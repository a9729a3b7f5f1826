"""dist4.chol at a tiny size on the CPU (four gloo ranks): a run whose
rank 0 leaves the process group after its children have ended still
ends with exit 0 and a result, and a child that dies during the run
ends it."""

from __future__ import annotations

import io
import json

import torch.distributed as dist

from portbench import harness

CELL = "dist4.chol"


def _overrides():
    _, cfg, _ = harness.find_cell(harness.load_manifest(), CELL)
    dep = {**cfg["deployment"], "ranks": 4, "dp": 1, "block": 64,
           "reference_tile": 100}
    return {"n_train": 256, "deployment": dep}


def test_children_may_end_before_rank_0_leaves_the_group(monkeypatch):
    import time

    leave = dist.destroy_process_group

    def slow_leave(*a, **k):
        leave(*a, **k)
        time.sleep(1.5)  # longer than the watchdog's 0.5-s poll

    monkeypatch.setattr(dist, "destroy_process_group", slow_leave)
    out, err = io.StringIO(), io.StringIO()
    code, result = harness.run_cell(CELL, 2**31 + 7, 0.3, False,
                                    device="cpu", overrides=_overrides(),
                                    out=out, err=err)
    assert code == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == result
    assert result["correct"] is True and result["failed"] == 0


def test_a_child_that_dies_during_the_run_ends_it():
    import subprocess
    import sys

    from conftest import ROOT

    # the harness in a process of its own, since the driver ends a failed
    # run with os._exit(1); the fault is rank 1 killed after the first
    # timed step
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
load = harness.load_driver
def load_driver(traffic):
    class Killing(load(traffic)):
        def operation(self):
            r = super().operation()
            self.children[0].kill()
            return r
    return Killing
harness.load_driver = load_driver
harness.run_cell({CELL!r}, 2**31 + 7, 30.0, False, device="cpu",
                 overrides={_overrides()!r})
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "portbench: " in p.stderr
