"""Diagonal-block Cholesky — the CUDA kernel ``csrc/potrf.cu`` and its twin.

Replaces ``cugp_tpu/ops/chol_pallas.py::_potrf_kernel``, the base case of
the recursive factorization. Unlike the Pallas kernel (n % 128 == 0,
block held in VMEM) it takes any n <= 1024 and factors a diagonal block
of the caller's buffer in place, reading only the lower triangle. On the
H100 it is a tiled right-looking Cholesky on 32x32 tiles, run by one
persistent grid of CTAs in a single cooperative launch: each step's
panel tiles and trailing-update tiles are dealt round-robin over the
CTAs, with a grid-wide barrier after each phase (``grid_size`` says how
many CTAs a block gets). The result does not depend on that number, and
a batch equals the loop over its blocks bitwise. A batch (B, n, n) takes
one of two routes: the cooperative one factors its blocks one after
another over the whole grid; the batch route (a batch of chains) runs
one CTA a block, all blocks at once, the same code at one CTA with block
barriers for grid barriers, so both give the same bits. ``route`` says
which one a call takes. cuSOLVER's potrf (``torch.linalg.cholesky``)
serves only as the plain version here.

``potrf_`` launches the kernel for CUDA tensors (a refused launch
raises) and writes ``potrf_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from cugp_tpu_torch.ops import _build

MAX_N = 1024
LAUNCHES = 0  # kernel launches by potrf_ (plain CPU calls do not count)
ROUTES = {"auto": 0, "cooperative": 1, "batch": 2}


def potrf_plain(a):
    """Lower Cholesky of the block whose lower triangle is ``a``'s; NaN
    throughout a block that is not positive definite (as the kernel, and
    as XLA's cholesky, signal failure)."""
    lower = torch.tril(a)
    L, info = torch.linalg.cholesky_ex(lower + torch.tril(lower, -1).mT)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def potrf_(a, route="auto"):
    """Factor a (n, n) or (B, n, n) block in place: lower L, zeros above.

    A non-PD block gives NaN (never a clamped factor). For a CUDA tensor
    this launches the kernel or raises. route: "auto" (see ``route``),
    "cooperative" or "batch"; both give the same bits.
    """
    global LAUNCHES
    n = a.shape[-1]
    if a.ndim not in (2, 3) or a.shape[-2] != n:
        raise ValueError(f"potrf_ takes (n, n) or (B, n, n), got "
                         f"{tuple(a.shape)}")
    if a.device.type != "cuda":
        a.copy_(potrf_plain(a))
        return a
    if a.dtype != torch.float32 or n > MAX_N or a.stride(-1) != 1:
        raise ValueError(f"potrf_ kernel takes float32 blocks with n <= "
                         f"{MAX_N} and unit column stride, got {a.dtype} "
                         f"{tuple(a.shape)} strides {a.stride()}")
    batch = a.shape[0] if a.ndim == 3 else 1
    batch_stride = a.stride(0) if a.ndim == 3 else 0
    lib = _build.lib()
    with torch.cuda.device(a.device):
        err = lib.cugp_potrf(a.data_ptr(), a.stride(-2), batch_stride, n,
                             batch, ROUTES[route], _build.stream_of(a))
    _build.check(err, "potrf")
    LAUNCHES += 1
    return a


def potrf(a, route="auto"):
    """Out-of-place potrf_: the lower factor of a copy of ``a``."""
    return potrf_(a.clone(memory_format=torch.contiguous_format), route)


def route(batch, device=None):
    """The route potrf_ takes for a batch of blocks on ``device`` when
    asked for "auto": "batch" from 9 blocks on an H100 (the SM count over
    16), else "cooperative"."""
    lib = _build.lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib.cugp_potrf_route(batch, ctypes.byref(out)),
                     "potrf")
    return {v: k for k, v in ROUTES.items()}[out.value]


def grid_size(n, device=None):
    """The number of CTAs the cooperative route's launch takes for an
    (n, n) block on ``device`` (the current CUDA device by default)."""
    lib = _build.lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib.cugp_potrf_grid(n, ctypes.byref(out)), "potrf")
    return out.value
