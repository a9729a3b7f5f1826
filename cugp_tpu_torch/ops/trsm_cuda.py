"""Diagonal-block triangular solve — the CUDA kernels of ``csrc/trsm.cu``.

Replaces ``cugp_tpu/ops/trsm_pallas.py::_trsm_kernel`` (trsm_pallas.py:35)
and its helper ``chol_pallas._trtri_tile`` (chol_pallas.py:54): op(L) X = B
for a lower block L (any n <= 1024; only its lower triangle is read) and
op in {L, L^T}, overwriting B in place. Right-side solves (X op(L) = B)
pass B's transposed view, so no copy is made.

As on the TPU, the diagonal tiles of L are inverted first (a trtri pass,
one CTA a tile, into a scratch this wrapper allocates), and each panel of
the solve is a strip update followed by a product with its inverted tile,
so no per-column substitution chain is left. Two routes follow: for
k <= 16 right-hand sides (the alpha solves, the preconditioner) the solve
is bound by latency and by the bytes of L one SM pulls in, so one CTA a
column streams the tiles of L ahead of use with cp.async; for wider k
(predict, the Cholesky panel solves, Murray's backward, the triangular
inverse of ``cholesky.cho_inverse``) it is bound by fp32 FMA issue, so
a grid of column slabs runs register-tiled products.

A batch (L (B, n, n), B (B, n, k)) is one launch of each pass with the
element as the grid's second index, one scratch of inverted tiles an
element; each element equals its own 2-D solve bitwise.

``trsm_`` launches the kernels for CUDA tensors (or raises) and writes
``trsm_plain`` (``torch.linalg.solve_triangular``) for CPU tensors.
``LAUNCHES`` counts calls of ``trsm_`` that launched: one a solve, though
each is a trtri launch and a solve launch.
"""

from __future__ import annotations

import functools

import torch

from cugp_tpu_torch.ops import _build

MAX_N = 1024
LAUNCHES = 0  # solves trsm_ ran on the card (plain CPU calls do not count)


@functools.lru_cache(maxsize=None)
def _scratch_floats(n):
    return _build.lib().cugp_trsm_scratch(n)


def _vec_view(b, left):
    """A vector right-hand side (n,) or (B, n) as an (n, 1) column (left)
    or a (1, n) row, with the batch dimension in front."""
    return b[..., :, None] if left else b[..., None, :]


def trsm_plain(l, b, left=True, transpose=False):
    """Solve op(L) X = B (left) or X op(L) = B (right); L lower, (n, n) or
    a (B, n, n) batch with B (B, n, k) (or (B, n) vectors)."""
    vec = b.ndim == l.ndim - 1
    if vec:
        b = _vec_view(b, left)
    lt = torch.tril(l)
    a = lt.mT if transpose else lt
    x = torch.linalg.solve_triangular(a, b, upper=transpose, left=left)
    return x.squeeze(-1 if left else -2) if vec else x


def trsm_(l, b, left=True, transpose=False):
    """trsm_plain's solve written into ``b`` in place (any strides); L
    (n, n) with B (n, k) or (n,), or a batch: L (B, n, n) with B (B, n, k)
    or (B, n).

    For a CUDA tensor this launches the kernel or raises.
    """
    global LAUNCHES
    if b.ndim == l.ndim - 1:
        trsm_(l, _vec_view(b, left), left, transpose)
        return b
    if not left:
        # X op(L) = B  <=>  op(L)^T X^T = B^T: the same solve on B's view
        trsm_(l, b.mT, True, not transpose)
        return b
    n = l.shape[-1]
    if (l.ndim not in (2, 3) or l.shape[-2] != n or b.ndim != l.ndim
            or b.shape[:-2] != l.shape[:-2] or b.shape[-2] != n):
        raise ValueError(f"trsm_: L {tuple(l.shape)}, B {tuple(b.shape)}")
    if not b.is_cuda:
        b.copy_(trsm_plain(l, b, True, transpose))
        return b
    dev = b.get_device()
    if (l.dtype != torch.float32 or b.dtype != torch.float32
            or l.get_device() != dev or n > MAX_N or l.stride(-1) != 1):
        raise ValueError(f"trsm_ kernel takes float32 L with n <= {MAX_N} "
                         f"and unit column stride on B's device, got L "
                         f"{l.dtype} {tuple(l.shape)} {l.stride()} on "
                         f"{l.device}, B {b.dtype} on {b.device}")
    batch = l.shape[0] if l.ndim == 3 else 1
    if batch == 0:
        return b
    lib = _build.lib()
    # the inverted diagonal tiles (256 KB an element at n = 1024)
    scratch = torch.empty(batch * _scratch_floats(n), dtype=torch.float32,
                          device=b.device)
    args = (l.data_ptr(), l.stride(-2), b.data_ptr(), b.stride(-2),
            b.stride(-1), n, b.shape[-1], int(transpose), scratch.data_ptr(),
            batch, l.stride(0) if l.ndim == 3 else 0,
            b.stride(0) if b.ndim == 3 else 0, _build.stream_of(b))
    if dev == torch.cuda.current_device():
        err = lib.cugp_trsm(*args)
    else:
        with torch.cuda.device(b.device):
            err = lib.cugp_trsm(*args)
    _build.check(err, "trsm")
    LAUNCHES += 1
    return b


def trsm(l, b, left=True, transpose=False):
    """Out-of-place trsm_ (same signature as trsm_pallas.trsm)."""
    return trsm_(l, b.clone(), left, transpose)
