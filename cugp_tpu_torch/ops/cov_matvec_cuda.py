"""Fused covariance matvec — the kernel ``csrc/cov_matvec.cu`` and its twin.

Replaces ``cugp_tpu/ops/cov_pallas.py::_cov_matvec_kernel``: (K(X, X) +
diag_add I) V with K built tile by tile on chip and never written. On the
H100 it is bound by fp32 operations (2d + a few + 2r flops per entry of
K); the kernel holds each tile in registers, contracts it with a
shared-memory V tile, and reduces the warps' partial sums in a fixed order
(no atomics: bitwise reproducible). Any d (32-feature chunks), any r
(32-wide V chunks over the grid), n and r unpadded.

``cov_matvec`` launches the kernel for CUDA tensors and runs
``cov_matvec_plain`` (row blocks of ``cov_cuda.cov_tile_plain`` times V)
for CPU tensors. The kernel has no backward: asking it for a gradient
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

    xs (>= n, d) scaled rows, v (>= n, r), scal [sf2, diag_add, alpha].
    Returns the (n, r) product over the first n rows and columns.
    """
    cols, v = xs[:n], v[:n]
    out = [cov_cuda.cov_tile_plain(xs[lo:min(lo + block, n)], cols, scal,
                                   kind, False, min(block, n - lo), n) @ v
           for lo in range(0, n, block)]
    return torch.cat(out) + scal[1] * v


def cov_matvec(xs, v, scal, kind, n):
    """(K(xs, xs) + scal[1] I) @ v over the first n rows: the kernel on
    CUDA, the plain version on CPU. v is (>= n, r) with any strides."""
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
    if (xs.ndim != 2 or v.ndim != 2 or xs.shape[0] < n or v.shape[0] < n
            or scal.numel() != 3):
        raise ValueError(f"cov_matvec: shapes xs {tuple(xs.shape)}, "
                         f"v {tuple(v.shape)}, scal {tuple(scal.shape)}, "
                         f"n={n}")
    xs, scal = xs.contiguous(), scal.contiguous()
    r = v.shape[1]
    out = torch.empty((n, r), dtype=torch.float32, device=xs.device)
    lib = _build.lib()
    with torch.cuda.device(xs.device):
        err = lib.cugp_cov_matvec(xs.data_ptr(), v.data_ptr(),
                                  scal.data_ptr(), out.data_ptr(), n,
                                  xs.shape[1], r, v.stride(0), v.stride(1),
                                  out.stride(0), cov_cuda.KIND_CODES[kind],
                                  _build.stream_of(xs))
    _build.check(err, "cov_matvec")
    LAUNCHES += 1
    return out


def train_cov_matvec(params, X, v, kind="rbf", jitter=1e-6):
    """(K(X, X) + (noise + jitter * signal) I) @ v without forming K.

    The counterpart of ``cov_pallas.train_cov_matvec_pallas``; v is (n,)
    or (n, r). Periodic runs as rbf on its cos/sin view, at any width.
    """
    kernel_ops.require_base_kind(kind, "train_cov_matvec")
    if kind == "periodic":
        params, X = kernel_ops.periodic_rbf_view(params, X)
        kind = "rbf"
    xs = (X / torch.exp(params["log_lengthscale"])).to(torch.float32)
    sf2 = torch.exp(params["log_signal_var"])
    sn2 = torch.exp(params["log_noise_var"])
    scal = torch.stack([sf2, sn2 + jitter * sf2,
                        kernel_ops.extra_scalar(params, kind)]).to(
                            torch.float32)
    vec = v.ndim == 1
    out = cov_matvec(xs, v[:, None] if vec else v, scal, kind, X.shape[0])
    return out[:, 0] if vec else out
