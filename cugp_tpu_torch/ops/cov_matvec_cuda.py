"""Fused covariance matvec — the kernel ``csrc/cov_matvec.cu`` and its twin.

Replaces ``cugp_tpu/ops/cov_pallas.py::_cov_matvec_kernel``: (K(X, X) +
diag_add I) V with K built tile by tile on chip and never written. On the
H100 it is bound by fp32 instruction issue (the cross term, the epilogue
and r contraction FMAs for each of the n^2 entries of K), not by bytes.
A call is two launches: a pre-pass writes the padded rows (in log2 units
for rbf), their half squared norms and a contiguous zero-padded copy of V
into a scratch this wrapper allocates; then one of two routes. For r <=
32 (CG and Lanczos) the narrow route keeps K in registers and spends per
entry d cross FMAs, two subtractions, one ex2 and RC contraction FMAs (RC
exact at r = 1, 9, 16, 17, else a multiple of 4), with a cp.async ring
over the column tiles; what bounds it is the issue of those instructions
plus ~6 an entry of loads, staging and addresses. For r > 32 (the
variance solve) the wide route builds each K entry once into shared
memory and contracts it with 128 columns of V in a register-tiled
product; what bounds it is the fp32 FMA pipe. Sums run in a fixed order (no
atomics: bitwise reproducible; in the narrow route a column's output does
not depend on r). Any d, n and r, V with any strides.

A batch (the samplers' chains: xs (B, n, d), v (B, n, r), scal (B, 3))
is the same two launches with the element as a grid index (the
pre-pass's and the narrow route's y, the wide route's z), each element
on its own scratch slice, so each equals its 2-D call bitwise.

``cov_matvec`` launches the kernel for CUDA tensors and runs
``cov_matvec_plain`` (row blocks of ``cov_cuda.cov_tile_plain`` times V)
for CPU tensors; ``LAUNCHES`` counts its calls that launched (a pre-pass
and a route each). The kernel has no backward: asking it for a gradient
raises on either device. The matrix-free tier differentiates through the
blocked route (``inference.iterative.make_matvec(method="blocked")``),
as the JAX package does.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import _build, cov_cuda
from cugp_tpu_torch.ops import kernels as kernel_ops

LAUNCHES = 0  # kernel launches by cov_matvec (plain CPU calls do not count)

_NO_GRAD = ("the fused covariance matvec has no backward; differentiate "
            "through make_matvec(method='blocked')")


def cov_matvec_plain(xs, v, scal, kind, n, block=4096):
    """The fused matvec in torch ops: row blocks of the cross tile times V.

    xs (>= n, d) scaled rows, v (>= n, r), scal [sf2, diag_add, alpha];
    or a batch: xs (B, >= n, d), v (B, >= n, r), scal (B, 3). Returns the
    (n, r) (or (B, n, r)) product over the first n rows and columns.
    """
    cols, v = xs[..., :n, :], v[..., :n, :]
    out = [cov_cuda.cov_tile_plain(xs[..., lo:min(lo + block, n), :], cols,
                                   scal, kind, False, min(block, n - lo), n)
           @ v for lo in range(0, n, block)]
    return torch.cat(out, dim=-2) + scal[..., 1, None, None] * v


def route(r):
    """The kernel's route for r columns: "narrow RC=<V columns a CTA
    holds>" or "wide" (builds the library if needed)."""
    width = _build.lib().cugp_cov_matvec_width(r)
    return f"narrow RC={width}" if width <= 32 else "wide"


def cov_matvec(xs, v, scal, kind, n):
    """(K(xs, xs) + scal[1] I) @ v over the first n rows: the kernel on
    CUDA, the plain version on CPU. v is (>= n, r) with any strides. A
    batch: xs (B, >= n, d), v (B, >= n, r) (any strides), scal (B, 3),
    one launch pair for all B; each element is bitwise its 2-D call."""
    global LAUNCHES
    if kind not in cov_cuda.KIND_CODES:
        raise ValueError(f"cov_matvec takes base families "
                         f"{tuple(cov_cuda.KIND_CODES)} (periodic via the "
                         f"rbf view), got {kind!r}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xs, v, scal)):
        raise RuntimeError(_NO_GRAD)
    if xs.device.type != "cuda":
        return cov_matvec_plain(xs, v, scal, kind, n)
    for name, t in (("xs", xs), ("v", v), ("scal", scal)):
        if t.dtype != torch.float32 or t.device != xs.device:
            raise ValueError(f"cov_matvec: {name} must be float32 on "
                             f"{xs.device}, got {t.dtype} on {t.device}")
    batched = xs.ndim == 3
    *bs, rows, d = xs.shape
    if (xs.ndim not in (2, 3) or v.ndim != xs.ndim
            or tuple(v.shape[:-2]) != tuple(bs) or rows < n
            or v.shape[-2] < n or tuple(scal.shape) != (*bs, 3)):
        raise ValueError(f"cov_matvec: shapes xs {tuple(xs.shape)}, "
                         f"v {tuple(v.shape)}, scal {tuple(scal.shape)}, "
                         f"n={n}")
    batch = bs[0] if batched else 1
    xs, scal = xs.contiguous(), scal.contiguous()
    r = v.shape[-1]
    out = torch.empty((*bs, n, r), dtype=torch.float32, device=xs.device)
    if batch == 0:
        return out
    lib = _build.lib()
    floats = lib.cugp_cov_matvec_scratch(n, d, r)
    if floats < 0:
        raise ValueError(f"cov_matvec: n={n}, d={d}, r={r} needs a scratch "
                         "past 2^31 floats an element")
    # padded rows, half-norms and V an element: 6.8 MB at n = 100k, d = 4,
    # r = 9
    scratch = torch.empty(batch * floats, dtype=torch.float32,
                          device=xs.device)
    vbs = v.stride(0) if batched else 0
    with torch.cuda.device(xs.device):
        err = lib.cugp_cov_matvec(xs.data_ptr(), v.data_ptr(),
                                  scal.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), n, d, r, batch,
                                  rows * d, vbs, v.stride(-2), v.stride(-1),
                                  n * r, out.stride(-2),
                                  cov_cuda.KIND_CODES[kind],
                                  _build.stream_of(xs))
    _build.check(err, "cov_matvec")
    LAUNCHES += 1
    return out


def train_cov_matvec(params, X, v, kind="rbf", jitter=1e-6):
    """(K(X, X) + (noise + jitter * signal) I) @ v without forming K.

    The counterpart of ``cov_pallas.train_cov_matvec_pallas``; v is (n,)
    or (n, r). Batched params (every leaf with a leading B, X shared)
    take v (B, n) or (B, n, r) and run every element in one launch pair.
    Periodic runs as rbf on its cos/sin view, at any width.
    """
    kernel_ops.require_base_kind(kind, "train_cov_matvec")
    if kind == "periodic":
        params, X = kernel_ops.periodic_rbf_view(params, X)
        kind = "rbf"
    batched = params["log_signal_var"].ndim == 1
    xs = kernel_ops._scale(X, torch.exp(params["log_lengthscale"])).to(
        torch.float32)
    sf2 = torch.exp(params["log_signal_var"])
    sn2 = torch.exp(params["log_noise_var"])
    scal = torch.stack([sf2, sn2 + jitter * sf2,
                        kernel_ops.extra_scalar(params, kind)], dim=-1).to(
                            torch.float32)
    vec = v.ndim == (2 if batched else 1)
    out = cov_matvec(xs, v[..., None] if vec else v, scal, kind,
                     X.shape[-2])
    return out[..., 0] if vec else out
