"""Blocked triangular solves (TRSM), as ``cugp_tpu/ops/trsm.py``.

Recursive blocked TRSM: the triangular factor is split at
``blocking.split_point``, the diagonal sub-solves recurse, and the
coupling term is one large GEMM (``addmm_``, true fp32). The base case
(n <= _BASE) is the TRSM kernel for CUDA tensors and
``torch.linalg.solve_triangular`` for CPU tensors (``trsm_cuda.trsm_``).
The recursion works in place on the right-hand side; the public solves
copy it once and carry an autograd rule whose backward is two more of
the same solves. Every solve also takes a batch: L (B, n, n) with B
(B, n, k) (or (B, n) vectors), its GEMMs batched (``baddbmm_``) and the
batched kernel launch at the base.

Solve variants (L lower triangular):
  solve_lx(L, B)  : L X = B       (forward substitution)
  solve_ltx(L, B) : L^T X = B     (back substitution)
  solve_xlt(L, B) : X L^T = B     (right-side solve; Cholesky panel update)
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import trsm_cuda
from cugp_tpu_torch.ops.blocking import BASE as _BASE
from cugp_tpu_torch.ops.blocking import split_point as _split_point


def check_method(method):
    """'auto' and 'pallas' both mean: kernels for CUDA tensors, plain
    versions for CPU tensors. The JAX package's XLA routes have no
    counterpart here."""
    if method in ("auto", "pallas"):
        return
    if method in ("xla", "blocked"):
        raise ValueError(f"method={method!r} is a JAX/XLA route; the port "
                         "takes 'auto' or 'pallas'")
    raise ValueError(f"unknown method: {method!r}")


def sub_mm_(c, a, b):
    """c -= a @ b in place, true fp32: addmm_ for matrices, baddbmm_ for
    a batch of them."""
    if c.ndim == 2:
        c.addmm_(a, b, alpha=-1.0)
    else:
        c.baddbmm_(a, b, alpha=-1.0)


def solve_lx_(l, b):
    """L X = B in place on b (n, k) or (B, n, k), any strides."""
    n = l.shape[-1]
    if n <= _BASE:
        trsm_cuda.trsm_(l, b, left=True, transpose=False)
        return b
    m = _split_point(n)
    solve_lx_(l[..., :m, :m], b[..., :m, :])
    sub_mm_(b[..., m:, :], l[..., m:, :m], b[..., :m, :])
    solve_lx_(l[..., m:, m:], b[..., m:, :])
    return b


def solve_ltx_(l, b):
    """L^T X = B in place on b (n, k) or (B, n, k), any strides."""
    n = l.shape[-1]
    if n <= _BASE:
        trsm_cuda.trsm_(l, b, left=True, transpose=True)
        return b
    m = _split_point(n)
    solve_ltx_(l[..., m:, m:], b[..., m:, :])
    sub_mm_(b[..., :m, :], l[..., m:, :m].mT, b[..., m:, :])
    solve_ltx_(l[..., :m, :m], b[..., :m, :])
    return b


def solve_xlt_(l, b):
    """X L^T = B in place on b (k, n) or (B, k, n): L X^T = B^T on b's
    transposed view, split at the same points as trsm.solve_xlt's column
    recursion."""
    solve_lx_(l, b.mT)
    return b


class _Solve(torch.autograd.Function):
    """X = op(L)^{-1} B with op = L^T when transpose, else L."""

    @staticmethod
    def forward(ctx, l, b, transpose):
        x = b.clone()
        (solve_ltx_ if transpose else solve_lx_)(l, x)
        ctx.save_for_backward(l, x)
        ctx.transpose = transpose
        return x

    @staticmethod
    def backward(ctx, gx):
        l, x = ctx.saved_tensors
        gb = gx.clone(memory_format=torch.contiguous_format)
        # B_bar = op(L)^{-T} X_bar
        (solve_lx_ if ctx.transpose else solve_ltx_)(l, gb)
        gl = None
        if ctx.needs_input_grad[0]:
            gl = torch.tril(-(x @ gb.mT) if ctx.transpose else -(gb @ x.mT))
        return gl, gb, None


def _solve(l, b, transpose, method):
    check_method(method)
    vec = b.ndim == l.ndim - 1
    x = _Solve.apply(l, b[..., None] if vec else b, transpose)
    return x[..., 0] if vec else x


def solve_lx(l, b, method="auto"):
    """Solve L X = B for X (L lower triangular, B is (n, k) or (n,); or
    a batch: L (B, n, n), B (B, n, k) or (B, n))."""
    return _solve(l, b, False, method)


def solve_ltx(l, b, method="auto"):
    """Solve L^T X = B for X."""
    return _solve(l, b, True, method)


def solve_xlt(l, b, method="auto"):
    """Solve X L^T = B for X (right-side solve; B is (k, n) or
    (B, k, n))."""
    check_method(method)
    return _Solve.apply(l, b.mT, False).mT


def cho_solve(l, b, method="auto"):
    """Solve (L L^T) x = b given the Cholesky factor L."""
    return solve_ltx(l, solve_lx(l, b, method), method)
