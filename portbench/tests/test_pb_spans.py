"""The per-layer metrics read from the program's own spans and counters
(``portbench/spans.py``): a traced run of each cell at the tiny sizes
gives every one of its cell a finite value; an untraced run, or a program
without the spans, gives none."""

from __future__ import annotations

import functools
import io
import math

import pytest
from conftest import TINY

from portbench import harness

MANIFEST = harness.load_manifest()
NEW = {"kin40k.fit": ["factor_ms.fit", "chol_backward_ms_per_step",
                      "host_reads.fit"],
       "3droad.fit": ["cg_ms_per_iter", "sweep_ms_per_step",
                      "precond_ms_per_step", "host_reads.iterative"],
       "kin40k.predict": ["factor_ms.predict", "host_reads.predict"]}


@pytest.fixture
def split_solves(monkeypatch):
    """fit_iterative at the cell's own size (n >= 32768) solves and
    sweeps as two calls and counts CG's iterations; at the tiny size it
    would take the fused call, which counts none."""
    from cugp_tpu_torch.inference import map_opt

    monkeypatch.setattr(map_opt, "fit_iterative", functools.partial(
        map_opt.fit_iterative, split_programs=True))


def _run(cell, trace):
    code, result = harness.run_cell(cell, 2**31 + 77, 0.3, trace,
                                    device="cpu", overrides=TINY[cell],
                                    out=io.StringIO(), err=io.StringIO())
    assert code == 0 and result["correct"] is True
    return result


def test_the_manifest_names_each_metric_for_its_cell():
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            m = per_layer[name]
            assert m["workloads"] == [cell]
            assert m["source"] == ("program_counter"
                                   if name.startswith("host_reads.")
                                   else "program_span")


@pytest.mark.parametrize("cell", list(NEW))
def test_a_traced_run_reports_the_programs_metrics(cell, split_solves):
    metrics = _run(cell, True)["metrics"]
    for name in NEW[cell]:
        v = metrics[name]["value"]
        assert math.isfinite(v) and v > 0, name
    # a fit step reads the finite guard and one level of the jitter
    # ladder; a request the ladder; a matrix-free step CG's test before
    # each iteration and after the last, and its value
    if cell == "kin40k.fit":
        assert metrics["host_reads.fit"]["value"] == 2.0
    elif cell == "kin40k.predict":
        assert metrics["host_reads.predict"]["value"] == 1.0
    else:
        assert metrics["host_reads.iterative"]["value"] == pytest.approx(
            metrics["cg_iters_per_step"]["value"] + 2)


@pytest.mark.parametrize("cell", list(NEW))
def test_an_untraced_run_reports_none_of_them(cell):
    result = _run(cell, False)
    assert not set(NEW[cell]) & set(result["metrics"])
    run = harness.Run({"ops": 5, "failed": 0, "flops": 0.0, "points": 0},
                      1.0, {"cg_iters": [10] * 5}, None, None)
    for name in NEW[cell]:
        assert harness.read_metric(name, run) is None


def test_a_program_without_the_spans_gives_none(monkeypatch):
    """An older program, from before the spans: the readers return None
    and raise nothing."""
    from cugp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_ms")
    run = harness.Run({"ops": 5, "failed": 0, "flops": 0.0, "points": 0},
                      1.0, {"cg_iters": [10] * 5}, {"busy_s": 0.0}, None)
    for name in sum(NEW.values(), []):
        assert harness.read_metric(name, run) is None
