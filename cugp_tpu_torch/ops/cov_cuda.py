"""Covariance tile — the CUDA kernel ``csrc/cov.cu`` and its twin.

Replaces ``cugp_tpu/ops/cov_pallas.py::_cov_kernel``. On the H100 the build
is bound by the m n fp32 store (4.29 GB at N = 32768). A call is two
launches: a pre-pass writes the rows of X1 and X2 padded to 4 features (in
log2 units for rbf) and their half squared norms into a scratch this
wrapper allocates (one pass when X2 is X1); then persistent CTAs walk
128x128 output tiles, a thread owning 16 rows x 4 adjacent columns, with
masks only in tiles that meet the diagonal, the padding or the ragged
edge. An rbf entry at d = 4 is 4 cross FMA, two subtractions, one ex2 and
sf2 once, about 10 instructions with its share of loads and stores, a
quarter of what the store time leaves, so the writes bind: the output
goes out as 16-byte streaming stores (``route(ldo, ptr)`` is "16-byte")
or, where its leading dimension or address does not allow them, as 4-byte
ones; both write the same bits. Straight into an exactly m x n output (no
padding, no crop copy); no atomics, and an entry's value does not depend
on the shape, its tile or the route. Measured on an H100 80GB HBM3 at
700 W (chip_smoke.py phase 2; PERF.md): 1.39-1.40 ms at 32768^2,
d = 8, against a 1.283 ms byte bound and 1.31 ms for ``out.fill_(1.0)``.

A batch (xs1 (B, m, d), xs2 (B, n, d), scal (B, 3): chains or Monte Carlo
draws as a leading dimension) is one launch pair: one pre-pass over
every element, then the persistent CTAs walk (element, tile) pairs; each
element equals its own 2-D build bitwise. A 2-D call is the B = 1 case.

``cov_tile`` launches the kernel for CUDA tensors and runs ``cov_tile_plain``
(the same formulas in torch ops) for CPU tensors; ``LAUNCHES`` counts its
calls that launched (a pre-pass and the tiles each). ``CovTile`` is the
autograd Function around it: forward launches the kernel, backward is the
VJP of the plain tile function recomputed on the same inputs — the
counterpart of the custom VJPs at ``cugp_tpu/ops/kernels.py:347-400``.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import _build

KIND_CODES = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3,
              "rq": 4, "linear": 5}

LAUNCHES = 0  # kernel launches by cov_tile (plain CPU calls do not count)


def kernel_fn_plain(d2, kind, alpha):
    """Unit-amplitude kernel value of a scaled squared distance."""
    if kind == "rbf":
        return torch.exp(-0.5 * d2)
    if kind == "rq":
        return torch.exp(-alpha * torch.log1p(d2 / (2.0 * alpha)))
    # min d2 before the sqrt (the JAX package's _R2_EPS): a finite
    # gradient at r = 0
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    if kind == "matern12":
        return torch.exp(-r)
    if kind == "matern32":
        s = 3.0 ** 0.5 * r
        return (1.0 + s) * torch.exp(-s)
    if kind == "matern52":
        s = 5.0 ** 0.5 * r
        return (1.0 + s + (s * s) / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown kernel kind: {kind}")


def cov_tile_plain(xs1, xs2, scal, kind, square, n1_true, n2_true):
    """The covariance tile in torch ops (cov_pallas._cov_kernel's formulas).

    xs1 (m, d), xs2 (n, d): rows already divided by the lengthscale.
    scal: (3,) tensor [sf2, diag_add, alpha]. Rows >= n1_true / cols >=
    n2_true follow the padding contract (identity block when square,
    zeros otherwise). A batch (xs1 (B, m, d), xs2 (B, n, d), scal (B, 3))
    goes through broadcasting.

    On a square build's diagonal d2 is set to exactly 0 (a GEMM need not
    round s1 + s2 - 2 cross to 0 there, and matern12's sqrt turns that
    rounding into a gradient error; the kernel's norms are summed in the
    cross term's order, so its own d2 is 0 there already).
    """
    sf2, diag_add, alpha = (scal[..., i, None, None] for i in range(3))
    cross = xs1 @ xs2.mT
    m, n = cross.shape[-2:]
    rows = torch.arange(m, device=cross.device)[:, None]
    cols = torch.arange(n, device=cross.device)[None, :]
    if kind == "linear":
        k = sf2 * cross + alpha
    else:
        s1 = torch.sum(xs1 * xs1, dim=-1)[..., :, None]
        s2 = torch.sum(xs2 * xs2, dim=-1)[..., None, :]
        if kind == "rbf":
            k = sf2 * torch.exp(cross - 0.5 * s1 - 0.5 * s2)
        else:
            d2 = torch.clamp(s1 + s2 - 2.0 * cross, min=0.0)
            if square:
                d2 = torch.where((rows == cols) & (rows < n1_true), 0.0, d2)
            k = sf2 * kernel_fn_plain(d2, kind, alpha)
    pad = (rows >= n1_true) | (cols >= n2_true)
    if square:
        diag = rows == cols
        k = k + torch.where(diag, diag_add, 0.0)
        k = torch.where(pad, diag.to(k.dtype), k)
    else:
        k = torch.where(pad, 0.0, k)
    return k


def route(ldo, ptr):
    """The store route the kernel takes for an output with leading
    dimension ldo at address ptr (cugp_cov's rule): "16-byte" where
    ldo % 4 == 0 and ptr is 16-byte aligned, else "4-byte". cugp_cov
    also asks a batch's element stride to be a multiple of 4; cov_tile's
    output is contiguous, so that stride, m ldo, is one whenever ldo is.
    Both routes write the same values."""
    return "16-byte" if ldo % 4 == 0 and ptr % 16 == 0 else "4-byte"


def cov_tile(xs1, xs2, scal, kind, square, n1_true, n2_true):
    """Build the (m, n) tile, or a (B, m, n) batch of them from xs1
    (B, m, d), xs2 (B, n, d) and scal (B, 3): the kernel on CUDA, the
    plain version on CPU."""
    global LAUNCHES
    if kind not in KIND_CODES:
        raise ValueError(f"cov_tile takes base families {tuple(KIND_CODES)}"
                         f" (periodic via the rbf view), got {kind!r}")
    if xs1.device.type != "cuda":
        return cov_tile_plain(xs1, xs2, scal, kind, square, n1_true, n2_true)
    for name, t in (("xs1", xs1), ("xs2", xs2), ("scal", scal)):
        if t.dtype != torch.float32 or t.device != xs1.device:
            raise ValueError(f"cov_tile: {name} must be float32 on "
                             f"{xs1.device}, got {t.dtype} on {t.device}")
    batched = xs1.ndim == 3
    *bs, m, d = xs1.shape
    if (xs2.ndim != xs1.ndim or xs1.ndim not in (2, 3)
            or xs2.shape[:-2] != xs1.shape[:-2] or xs2.shape[-1] != d
            or tuple(scal.shape) != (*bs, 3)):
        raise ValueError(f"cov_tile: shapes {tuple(xs1.shape)}, "
                         f"{tuple(xs2.shape)}, scal {tuple(scal.shape)}")
    batch = bs[0] if batched else 1
    n = xs2.shape[-2]
    same = xs2 is xs1
    xs1, scal = xs1.contiguous(), scal.contiguous()
    xs2 = xs1 if same else xs2.contiguous()
    out = torch.empty((*bs, m, n), dtype=torch.float32, device=xs1.device)
    if batch == 0:
        return out
    lib = _build.lib()
    floats = lib.cugp_cov_scratch(m, n, d)
    if floats < 0:
        raise ValueError(f"cov_tile: m={m}, n={n}, d={d} needs a scratch "
                         "past 2^31 floats")
    # padded rows and half-norms an element: 0.3 MB at 8000 x 8000, d = 4
    # (half of it when xs2 is xs1: one pre-pass)
    scratch = torch.empty(batch * floats, dtype=torch.float32,
                          device=xs1.device)
    with torch.cuda.device(xs1.device):
        err = lib.cugp_cov(xs1.data_ptr(), xs2.data_ptr(), scal.data_ptr(),
                           out.data_ptr(), scratch.data_ptr(), m, n, d,
                           out.stride(-2), KIND_CODES[kind], int(square),
                           min(int(n1_true), m), min(int(n2_true), n),
                           batch, m * d, n * d, m * n,
                           _build.stream_of(xs1))
    _build.check(err, "cov")
    LAUNCHES += 1
    return out


class CovTile(torch.autograd.Function):
    """cov_tile with the VJP of cov_tile_plain as its backward."""

    @staticmethod
    def forward(ctx, xs1, xs2, scal, kind, square, n1_true, n2_true):
        ctx.save_for_backward(xs1, xs2, scal)
        ctx.args = (kind, square, n1_true, n2_true)
        return cov_tile(xs1, xs2, scal, kind, square, n1_true, n2_true)

    @staticmethod
    def backward(ctx, g):
        xs1, xs2, scal = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (xs1, xs2, scal)]
            k = cov_tile_plain(*ins, *ctx.args)
            grads = torch.autograd.grad(k, ins, g)
        return (*grads, None, None, None, None)
