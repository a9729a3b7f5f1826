"""Diagonal-block triangular solve — the CUDA kernel ``csrc/trsm.cu``.

Replaces ``cugp_tpu/ops/trsm_pallas.py::_trsm_kernel`` and its helper
``chol_pallas._trtri_tile``: op(L) X = B for a lower block L (any
n <= 1024) and op in {L, L^T}, overwriting B in place. Right-side solves
(X op(L) = B) pass B's transposed view, so no copy is made. On the H100
a single-column solve is one latency-bound CTA; wide right-hand sides
(predict, the Cholesky recursion) are bound by the n^2/2 FMAs per column
from shared memory, one 32-column slab per CTA.

``trsm_`` launches the kernel for CUDA tensors and writes ``trsm_plain``
(``torch.linalg.solve_triangular``) for CPU tensors.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import _build

MAX_N = 1024
LAUNCHES = 0  # kernel launches by trsm_ (plain CPU calls do not count)


def _vec_view(b, left):
    """A 1-D right-hand side as an (n, 1) column (left) or (1, n) row."""
    return b[:, None] if left else b[None, :]


def trsm_plain(l, b, left=True, transpose=False):
    """Solve op(L) X = B (left) or X op(L) = B (right); L lower."""
    vec = b.ndim == 1
    if vec:
        b = _vec_view(b, left)
    lt = torch.tril(l)
    a = lt.mT if transpose else lt
    x = torch.linalg.solve_triangular(a, b, upper=transpose, left=left)
    return x.reshape(-1) if vec else x


def trsm_(l, b, left=True, transpose=False):
    """trsm_plain's solve written into ``b`` in place (any strides).

    For a CUDA tensor this launches the kernel or raises.
    """
    global LAUNCHES
    if b.ndim == 1:
        trsm_(l, _vec_view(b, left), left, transpose)
        return b
    if not left:
        # X op(L) = B  <=>  op(L)^T X^T = B^T: the same solve on B's view
        trsm_(l, b.mT, True, not transpose)
        return b
    n = l.shape[-1]
    if l.shape != (n, n) or b.ndim != 2 or b.shape[0] != n:
        raise ValueError(f"trsm_: L {tuple(l.shape)}, B {tuple(b.shape)}")
    if b.device.type != "cuda":
        b.copy_(trsm_plain(l, b, True, transpose))
        return b
    if (l.dtype != torch.float32 or b.dtype != torch.float32
            or l.device != b.device or n > MAX_N or l.stride(-1) != 1):
        raise ValueError(f"trsm_ kernel takes float32 L with n <= {MAX_N} "
                         f"and unit column stride on B's device, got L "
                         f"{l.dtype} {tuple(l.shape)} {l.stride()} on "
                         f"{l.device}, B {b.dtype} on {b.device}")
    k = b.shape[1]
    lib = _build.lib()
    with torch.cuda.device(b.device):
        err = lib.cugp_trsm(l.data_ptr(), l.stride(0), b.data_ptr(),
                            b.stride(0), b.stride(1), n, k, int(transpose),
                            _build.stream_of(b))
    _build.check(err, "trsm")
    LAUNCHES += 1
    return b


def trsm(l, b, left=True, transpose=False):
    """Out-of-place trsm_ (same signature as trsm_pallas.trsm)."""
    return trsm_(l, b.clone(), left, transpose)
