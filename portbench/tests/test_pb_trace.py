"""The trace's reduction: the union of device operations over the
window, annotations left out, and idle gaps named by the host."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from portbench import readers, trace


def _ev(name, start, end, cat):
    return {"ph": "X", "cat": cat, "name": name, "ts": start,
            "dur": end - start}


class _Prof:
    def __init__(self, events):
        self._events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)


def test_summary_unions_device_operations_inside_the_window():
    cpu, ann, gpu = "user_annotation", "gpu_user_annotation", "kernel"
    prof = _Prof([
        _ev(trace.WINDOW_SPAN, 100.0, 1100.0, cpu),
        _ev(trace.WINDOW_SPAN, 100.0, 1100.0, ann),
        _ev("Optimizer.step#Adam.step", 300.0, 900.0, cpu),
        _ev("Optimizer.step#Adam.step", 300.0, 900.0, ann),
        _ev("aten::item", 350.0, 420.0, "cpu_op"),
        _ev("kernel_a", 50.0, 300.0, gpu),     # starts before the window
        _ev("kernel_b", 250.0, 350.0, gpu),    # overlaps kernel_a
        _ev("kernel_a", 400.0, 600.0, gpu),
        _ev("kernel_b", 950.0, 1000.0, gpu),
    ])
    s = trace.summarize(prof)
    # busy: [100, 350], [400, 600], [950, 1000]: 500 us of 1000 us
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["by_op"] == pytest.approx({"kernel_a": 400e-6,
                                        "kernel_b": 150e-6})
    assert [n for n, _ in s["device_ops"]] == ["kernel_a", "kernel_b"]
    idle = dict(s["idle_gaps"])
    # a gap is named by the host operation in progress when it began:
    # [350, 400] in aten::item, [600, 950] in the step, [1000, 1100] in
    # none
    assert idle["aten::item"] == pytest.approx(50e-6)
    assert idle["Optimizer.step#Adam.step"] == pytest.approx(350e-6)
    assert idle["host between operations"] == pytest.approx(100e-6)
    run = SimpleNamespace(trace=s)
    assert readers.idle_percent(run) == pytest.approx(50.0)
    assert readers.device_seconds(run, r"_b$") == pytest.approx(150e-6)
    assert readers.device_seconds(run, r"^none") is None
