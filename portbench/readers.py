"""Arithmetic the per-layer readers share. Each returns None where the
run holds nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import re

from portbench import frozen


def idle_percent(run):
    """100 (1 - union of the device's operations / the traced window)."""
    t = run.trace
    if not t or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_percent(run):
    """The window's model FLOPs over its length and the fp32 peak."""
    if run.tally["flops"] <= 0 or run.window_s <= 0:
        return None
    return 100.0 * run.tally["flops"] / (run.window_s
                                         * frozen.PEAK_FP32_FLOPS)


def device_seconds(run, pattern):
    """Device seconds of the operations whose name matches `pattern`, or
    None when none ran."""
    t = run.trace
    if not t:
        return None
    rx = re.compile(pattern)
    hits = [s for name, s in t["by_op"].items() if rx.search(name)]
    return sum(hits) if hits else None
