"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped): the result line keeps the contract, the JAX-free check works,
and every fault a cell can have turns ``correct`` false."""

from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys

import pytest
import torch
from conftest import TINY

from portbench import compare, faults, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _run(cell, trace=False, seed=2**31 + 99):
    out, err = io.StringIO(), io.StringIO()
    code, result = harness.run_cell(cell, seed, 0.3, trace, device="cpu",
                                    overrides=TINY[cell], out=out, err=err)
    return code, result, out.getvalue(), err.getvalue()


def test_banned_modules_compare_whole_top_level_names():
    assert harness.banned_modules({"cugp_tpu_torch.api": 1,
                                   "cugp_tpu_torchx": 1, "jaxtyping": 1}) == []
    assert harness.banned_modules({"cugp_tpu.ops": 1}) == ["cugp_tpu"]
    assert harness.banned_modules({"jax": 1, "jaxlib.xla": 1,
                                   "flax.linen": 1}) == ["flax", "jax",
                                                         "jaxlib"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keeps_the_contract(cell, trace):
    code, result, out, err = _run(cell, trace)
    assert code == 0
    last = json.loads(out.strip().splitlines()[-1])
    assert last == result
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    section = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in MANIFEST[section]
             if harness.applies(m, cell)}
    assert set(last["metrics"]) <= set(units)
    for name, m in last["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(last["metrics"]) == set(units)
    # the numbers compared, each beside its limit, end standard error
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [t.split("=")[0] for t in tail] == [
        "check " + k for k in last["checks"]]


def _driver(cell):
    return harness.find_cell(MANIFEST, cell)[2]["driver"]


FAULTY = [(cell, fault) for cell in CELLS
          for fault in faults.FAULTS_BY_DRIVER[_driver(cell)]]


@pytest.mark.parametrize("cell,fault", FAULTY)
def test_a_planted_fault_makes_correct_false(cell, fault):
    with faults.planted(fault, _driver(cell)):
        code, result, _, _ = _run(cell)
    assert code == 0 and result["correct"] is False


def test_solving_with_other_probes_is_seen_as_such():
    """The benchmark's probes go into the right-hand sides and the
    reference's estimate, and the probes the program swept with are
    compared with them: a fit on half of them reads every step."""
    with faults.planted("probe_subset", "fit_iterative"):
        _, result, _, _ = _run("3droad.fit")
    checks = result["checks"]
    assert checks["probes_differ"]["value"] == 3
    assert checks["solve_resid"]["value"] is None  # not finite


def test_leaf_gap_sees_a_gradient_handed_to_another_dimension():
    ref = {"log_lengthscale": torch.tensor([0.30, 0.20, 0.25]),
           "log_signal_var": torch.tensor(0.5),
           "log_noise_var": torch.tensor(-0.1)}
    swapped = {**ref, "log_lengthscale": torch.roll(
        ref["log_lengthscale"], 1)}
    assert compare.leaf_norm_gap(ref, ref) == 0.0
    # the norm of the whole leaf is the same; its entries are not
    assert compare.leaf_norm_gap(swapped, ref) == pytest.approx(0.1 / 0.25)
    assert "log_lengthscale[2]" in compare.moved_leaves(ref)


def test_a_serving_window_closes_on_a_whole_cycle():
    _, result, _, _ = _run("kin40k.predict")
    _, _, traffic = harness.find_cell(MANIFEST, "kin40k.predict")
    assert result["attempted"] % traffic["sizes_per_cycle"] == 0


def _command(cwd, home):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kin40k.fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(home), "TMPDIR": str(home)})


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = _command(ROOT, tmp_path)
    if "is_available() is false" not in out.stderr:
        pytest.skip("a card is visible")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ but no program."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
