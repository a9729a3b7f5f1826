"""Structured metrics logging, as ``cugp_tpu/utils/metrics.py``.

A copy of the JAX package's module: JSON-lines metric streams, one
object a step or event, written after a loop from its recorded trace
(readable by pandas or jq). The CLI's ``--metrics_file`` is one; its
modification time is ``utils/supervise``'s heartbeat.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    """Append-only JSON-lines metrics file: one object per step/event."""

    def __init__(self, path):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step=None, **values):
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in values.items():
            a = np.asarray(v)
            rec[k] = a.item() if a.ndim == 0 else a.tolist()
        self._f.write(json.dumps(rec) + "\n")

    def log_series(self, name, values, start_step=0):
        """Log a scan-carried per-step trace (e.g. the fit loss curve)."""
        for i, v in enumerate(np.asarray(values)):
            self.log(step=start_step + i, **{name: v})

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path):
    """Load a JSON-lines metrics file as a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
