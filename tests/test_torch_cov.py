"""The covariance-tile kernel's design, checked on the CPU.

csrc/cov.cu runs only on the card (chip_smoke.py holds it against
cov_cuda.cov_tile_plain there). Here its arithmetic is modelled in fp32
torch ops and held against the Pallas kernel in interpret mode and the
plain version, its persistent tile schedule is walked in Python, and the
store route is named on aligned and unaligned outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.ops import kernels as jk
from cugp_tpu_torch.ops import cov_cuda
from cugp_tpu_torch.ops import kernels as tk
from cugp_tpu_torch.utils.params import params_from_numpy
from tests.test_torch_ops import (COV_CASES, RTOL, assert_close, inputs,
                                  matern12_slack, np_params)

torch.set_num_threads(1)

SQRT_LOG2E = 1.2011224087864498  # rbf rows are scaled by it (log2 units)
TILE = 128  # the output tile edge fixed in csrc/cov.cu (rows and columns)


def fmaf(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def chain(a, b):
    """The kernel's cross term of rows a (m, dp) and b (n, dp): the first
    product rounded, then one fmaf a feature (start4, then fma4)."""
    c = a[:, None, 0] * b[None, :, 0]
    for k in range(1, a.shape[1]):
        c = fmaf(a[:, None, k], b[None, :, k], c)
    return c


def prep(x, scale):
    """The pre-pass: rows times scale, padded to 4 features, and their
    half squared norms summed in the cross term's order."""
    m, d = x.shape
    xs = torch.zeros(m, -(-d // 4) * 4)
    xs[:, :d] = x * torch.tensor(scale, dtype=torch.float32)
    s = xs[:, 0] * xs[:, 0]
    for k in range(1, xs.shape[1]):
        s = fmaf(xs[:, k], xs[:, k], s)
    return xs, 0.5 * s


def cov_tile_model(xs1, xs2, scal, kind, square, n1_true, n2_true):
    """csrc/cov.cu's arithmetic in fp32 torch ops, with cov_tile_plain's
    signature: hoisted rows and half-norms, rbf as sf2 * 2^((cross - h_i)
    - h_j) on log2-unit rows (sf2 once an output), the other kinds on
    s = 2h, then the diagonal and padding contract."""
    sf2, diag_add, alpha = scal[0], scal[1], scal[2]
    a1, h1 = prep(xs1, SQRT_LOG2E if kind == "rbf" else 1.0)
    a2, h2 = prep(xs2, SQRT_LOG2E if kind == "rbf" else 1.0)
    cross = chain(a1, a2)
    m, n = cross.shape
    if kind == "rbf":
        e = (cross - h1[:, None]) - h2[None, :]
        if square:  # the same rows: the diagonal exponent is exactly 0
            assert bool((torch.diagonal(e) == 0).all())
        k = sf2 * torch.exp2(e)
    elif kind == "linear":
        k = sf2 * cross + alpha
    else:
        d2 = torch.clamp((h1 + h1)[:, None] + (h2 + h2)[None, :]
                         - 2.0 * cross, min=0.0)
        k = sf2 * cov_cuda.kernel_fn_plain(d2, kind, alpha)
    rows = torch.arange(m)[:, None]
    cols = torch.arange(n)[None, :]
    pad = (rows >= n1_true) | (cols >= n2_true)
    if square:
        diag = rows == cols
        k = torch.where(diag, k + diag_add, k)
        return torch.where(pad, diag.to(k.dtype), k)
    return torch.where(pad, 0.0, k)


def periodic_f64(P, X1, X2, square, n_true):
    """The periodic family in float64 numpy, with the diagonal and padding
    contract: the witness both fp32 builds are measured against."""
    ell = np.exp(np.float64(P["log_lengthscale"]))
    per = np.exp(np.float64(P["log_period"]))
    sf2 = np.exp(np.float64(P["log_signal_var"]))
    diff = np.float64(X1)[:, None, :] - np.float64(X2)[None, :, :]
    k = sf2 * np.exp(-2.0 * (np.sin(np.pi * diff / per) ** 2
                             / ell ** 2).sum(-1))
    if not square:
        k[n_true:] = 0.0
        return k
    k += np.eye(len(X1)) * (np.exp(np.float64(P["log_noise_var"]))
                            + 1e-6 * sf2)
    k[n_true:], k[:, n_true:] = 0.0, 0.0
    k[n_true:, n_true:] = np.eye(len(X1) - n_true)
    return k


# the model at every width of COV_CASES, and the periodic view at d = 40
# (80 features, a view row's s about 170: the widest rbf exponent)
MODEL_CASES = [c for c in COV_CASES if c[1] in (3, 40)] + [("periodic", 40)]


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("kind,d", MODEL_CASES)
def test_cov_tile_model(kind, d, square, monkeypatch):
    """The model through the port's covariance functions (periodic via its
    rbf view, composites as products and sums of its tiles) against the
    Pallas kernel in interpret mode and against cov_tile_plain: n = 300
    (ragged against 128-row tiles), a square build with an identity block
    past n_true = 280, a 300 x 170 cross build with rows past 290 masked.
    rtol 1e-5, atol 1e-6, plus the matern12 slack near coincident points.
    Periodic at d = 40 is also held against float64 at rtol 1e-5, atol
    1e-6: there both fp32 references stray from it by about eps s sf2 on
    the diagonal (their exponent cross - s1/2 - s2/2 cancels; the model's
    is exactly 0), so that stray is allowed on top in the comparisons
    with them."""
    P = np_params(kind, d, seed=50 + d)
    X = inputs(300, d, seed=51 + d)
    p = params_from_numpy(P, "cpu")
    if square:
        X2 = X

        def build(method):
            return tk.train_covariance(p, torch.tensor(X), kind, 1e-6,
                                       method=method, n_true=280)

        want_pallas = jk.train_covariance(P, jnp.asarray(X), kind, 1e-6,
                                          method="pallas", n_true=280)
    else:
        X2 = inputs(170, d, seed=52 + d)

        def build(method):
            return tk.cross_covariance(p, torch.tensor(X), torch.tensor(X2),
                                       kind, method=method, n_true=290)

        want_pallas = jk.cross_covariance(P, jnp.asarray(X), jnp.asarray(X2),
                                          kind, method="pallas", n_true=290)
    want_plain = build("auto")
    monkeypatch.setattr(cov_cuda, "cov_tile_plain", cov_tile_model)
    got = build("auto")
    tol = matern12_slack(kind, X, X2, P)
    want_pallas, want_plain = np.asarray(want_pallas), want_plain.numpy()
    tol_pallas = tol_plain = tol
    if kind == "periodic" and d == 40:
        exact = periodic_f64(P, X, X2, square, 280 if square else 290)
        assert_close(got, exact, rtol=RTOL, atol=tol)
        tol_pallas = tol + np.abs(want_pallas - exact)
        tol_plain = tol + np.abs(want_plain - exact)
    assert_close(got, want_pallas, rtol=RTOL, atol=tol_pallas)
    assert_close(got, want_plain, rtol=RTOL, atol=tol_plain)
    if square and kind in ("rbf", "periodic"):
        # K_ii = sf2 + diag_add bitwise (the exponent is 0)
        diag_add = (torch.exp(p["log_noise_var"])
                    + 1e-6 * torch.exp(p["log_signal_var"]))
        want = torch.exp(p["log_signal_var"]) + diag_add
        assert torch.equal(torch.diagonal(got)[:280], want.expand(280))


def tile_schedule(m, n, grid_cap):
    """csrc/cov.cu's persistent schedule: CTA c of min(tiles, grid_cap)
    takes tiles c, c + G, ... in row-major tile order. Returns the visits
    of each tile and the writes of each entry."""
    T = TILE
    tiles_n = -(-n // T)
    tiles = -(-m // T) * tiles_n
    grid = min(tiles, grid_cap)
    visits = np.zeros(tiles, int)
    writes = np.zeros((m, n), int)
    for c in range(grid):
        for t in range(c, tiles, grid):
            ti, tj = divmod(t, tiles_n)
            visits[t] += 1
            writes[ti * T:(ti + 1) * T, tj * T:(tj + 1) * T] += 1
    return visits, writes


def interior(ti, tj, square, n1, n2):
    """csrc/cov.cu's interior(): the tile takes the path without masks."""
    return ((ti + 1) * TILE <= n1 and (tj + 1) * TILE <= n2
            and not (square and ti == tj))


@pytest.mark.parametrize("m,n,square,grid_cap", [
    (300, 300, True, 5), (1000, 777, False, 264), (4096, 1000, False, 132),
    (129, 129, True, 396), (1, 1, True, 264), (100, 1000, False, 1),
    (512, 512, True, 132)])
def test_cov_tile_schedule(m, n, square, grid_cap):
    """For ragged (m, n) and any grid, every tile is visited once and every
    entry written once; and the tiles that take the path without masks
    are exactly those whose 128 x 128 entries, laid out in full, hold no
    diagonal entry, no padding and none past the edge."""
    n1 = max(m - 3, 1)  # rows (and, square, columns) past n1 are padding
    n2 = n1 if square else n
    visits, writes = tile_schedule(m, n, grid_cap)
    assert (visits == 1).all() and (writes == 1).all()
    T = TILE
    rows = np.arange(-(-m // T) * T)[:, None]
    cols = np.arange(-(-n // T) * T)[None, :]
    masked = (rows >= n1) | (cols >= n2) | (rows >= m) | (cols >= n)
    if square:
        masked |= rows == cols
    for ti in range(-(-m // T)):
        for tj in range(-(-n // T)):
            clean = not masked[ti * T:(ti + 1) * T, tj * T:(tj + 1) * T].any()
            assert interior(ti, tj, square, n1, n2) == clean, (ti, tj)


@pytest.mark.parametrize("ldo,ptr,want", [
    (8000, 0x7f0000000000, "16-byte"), (128, 0x1000, "16-byte"),
    (777, 0x1000, "4-byte"), (8001, 0x1000, "4-byte"),
    (8000, 0x1004, "4-byte"), (100_000, 0x1008, "4-byte")])
def test_cov_store_route(ldo, ptr, want):
    """16-byte stores need ldo % 4 == 0 and a 16-byte aligned output."""
    assert cov_cuda.route(ldo, ptr) == want
