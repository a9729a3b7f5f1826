"""The generators repeat for a seed and keep the published shapes; the
random features draw the Matern-3/2 kernel; the frozen FLOP and byte
counts match hand counts."""

from __future__ import annotations

import json
import math

import pytest
import torch

from portbench import data, frozen, harness
from portbench.reference import matern32

MANIFEST = harness.load_manifest()


def _draw(seed, n=257, d=3):
    gen = data.generator("cpu", seed)
    return data.matern32_draw(n, d, 1.5, 1.0, 0.04, gen, "cpu", features=512)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**33 + 5])
def test_draw_repeats_for_a_seed(seed):
    X1, y1 = _draw(seed)
    X2, y2 = _draw(seed)
    assert torch.equal(X1, X2) and torch.equal(y1, y2)
    X3, _ = _draw(seed + 1)
    assert not torch.equal(X1, X3)
    assert X1.dtype == torch.float32 and X1.shape == (257, 3)
    assert float(X1.abs().max()) <= math.sqrt(3.0) + 1e-6


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cells_keep_the_published_shapes(cell):
    _, cfg, _ = harness.find_cell(MANIFEST, cell)
    with open(harness.ROOT / "portbench" / "configs"
              / f"{cfg['name']}.json") as f:
        assert json.load(f) == cfg
    assert cfg["d"] == cfg["published"]["d"]
    if "n_test" in cfg:
        assert cfg["n_test"] == cfg["published"]["n_test"]


def test_random_features_draw_the_matern32_kernel():
    """E[f(x) f(x')] over many feature draws is sf2 * matern32(r)."""
    d, ell, feats = 3, 1.5, 200_000
    gen = data.generator("cpu", 3)
    z = torch.randn((d, feats), generator=gen, dtype=torch.float64)
    u = torch.randn((3, feats), generator=gen,
                    dtype=torch.float64).square().sum(0)
    W = z / ell / torch.sqrt(u / 3.0)
    for r in (0.3, 1.0, 2.5):
        delta = torch.tensor([r, 0.0, 0.0], dtype=torch.float64)
        est = float(torch.cos(delta @ W).mean())
        s = math.sqrt(3.0) * r / ell
        assert est == pytest.approx((1 + s) * math.exp(-s), abs=0.01)


def test_size_cycle_is_the_same_set_for_every_seed():
    a = data.size_cycle(256, 8000, 32, data.generator("cpu", 1))
    b = data.size_cycle(256, 8000, 32, data.generator("cpu", 2))
    assert sorted(a) == sorted(b) and a != b
    assert max(a) == 8000 and min(a) >= 256 and len(a) == 32


def test_probes_are_signs():
    z = data.rademacher(100, 8, data.generator("cpu", 4), "cpu")
    assert z.shape == (100, 8) and set(z.unique().tolist()) == {-1.0, 1.0}


def test_frozen_bounds_match_hand_counts():
    # matvec n=100,000, d=4, r=9: 1e10 * (8 + 3 + 18) flops over 67e12
    ms, by = frozen.matvec_bound(100_000, 4, 9)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 1e10 * 29 / 67e12)
    # TRSM n=1024, k=16: bytes (L's triangle, B and X) bound it
    ms, by = frozen.trsm_bound(1024, 16)
    assert by == "bytes"
    assert ms == pytest.approx(
        1e3 * 4 * (1024 * 1025 // 2 + 2 * 1024 * 16) / 3.35e12)
    ms, by = frozen.trsm_bound(1024, 4096)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 1024 ** 2 * 4096 / 67e12)


def test_frozen_flop_models_match_hand_counts():
    n, d = 25_600, 8
    assert frozen.dense_fit_step_flops(n, d, d + 2) == pytest.approx(
        n ** 3 + 2 * n * n * 8 + 2 * n * n * 10)
    assert frozen.predict_request_flops(n, d, 100) == pytest.approx(
        2 * n * 8 * 100 + n * n * 100 + 2 * n * 100)
    assert frozen.matrix_free_step_flops(1000, 3, 9, 4) == pytest.approx(
        5 * 1000 ** 2 * (6 + 3 + 18))


def test_reference_kernel_formula():
    a = torch.tensor([[0.0, 0.0]], dtype=torch.float64)
    b = torch.tensor([[0.6, 0.8]], dtype=torch.float64)
    s = math.sqrt(3.0)
    assert float(matern32.unit_kernel(a, b)) == pytest.approx(
        (1 + s) * math.exp(-s))
    assert float(matern32.unit_kernel(a, a)) == 1.0


def test_every_seed_holds_the_same_rows_and_probes_in_another_order():
    cfg = {"n_train": 64, "d": 3, "data_seed": 0,
           "draw": {"lengthscale": 1.5, "signal_var": 1.0, "noise_var": 0.04}}
    X1, y1, Z1, _ = data.dataset(cfg, 1, "cpu", probes=4)
    X2, y2, Z2, _ = data.dataset(cfg, 2, "cpu", probes=4)
    assert not torch.equal(X1, X2)
    rows1 = sorted(map(tuple, torch.cat([X1, y1[:, None], Z1], 1).tolist()))
    rows2 = sorted(map(tuple, torch.cat([X2, y2[:, None], Z2], 1).tolist()))
    assert rows1 == rows2
    X3, y3, Z3, _ = data.dataset(cfg, 1, "cpu")
    assert torch.equal(X1, X3) and torch.equal(y1, y3) and Z3 is None
