"""Blocked triangular solves (TRSM), as ``cugp_tpu/ops/trsm.py``.

Recursive blocked TRSM: the triangular factor is split at
``blocking.split_point``, the diagonal sub-solves recurse, and the
coupling term is one large GEMM (``addmm_``, true fp32). The base case
(n <= _BASE) is the TRSM kernel for CUDA tensors and
``torch.linalg.solve_triangular`` for CPU tensors (``trsm_cuda.trsm_``).
The in-place recursions take a GEMM precision for the Cholesky's
precision policies (``sub_mm_``); the public solves stay in true fp32.
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

import contextlib

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


# GEMM precisions of the recursions, named as jax.lax.Precision's levels:
# "highest" true fp32 (the default everywhere), "high" split TF32 (three
# tensor-core passes, close to fp32, as the TPU's bf16_3x HIGH), "default"
# one TF32 pass.
GEMM_PRECISIONS = ("highest", "high", "default")

# The k extent of one TF32 GEMM: longer contractions are cut into chunks
# of this many, each summed on the tensor cores and added into c by the
# GEMM's fp32 epilogue. Summed on the tensor cores over k = 16384, the
# products lost enough that "mixed" left an indefinite Schur complement
# at N = 32768 on an H100 (tools/chol_precision.py --k-chunk; PERF.md §6).
TF32_K_CHUNK = 4096


def round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even):
    the low 13 bits of each fp32 cleared."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & -0x2000
    return bits.view(torch.float32)


def split_tf32(x):
    """(hi, lo), both exact TF32 values, with hi + lo = x to ~21 bits."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


@contextlib.contextmanager
def tf32_matmul():
    """TF32 tensor-core GEMMs inside, restored to the old setting (False
    everywhere else in the port) on the way out, also on an exception.
    The operands handed to the GEMMs are TF32 values already, so the
    result does not depend on how the card converts fp32 to TF32; on the
    CPU the same products of TF32 values run in fp32, exact up to
    accumulation order."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _sub_(c, a, b):
    if c.ndim == 2:
        c.addmm_(a, b, alpha=-1.0)
    else:
        c.baddbmm_(a, b, alpha=-1.0)


def _sub_tf32_(c, a, b):
    """c -= a @ b on TF32 operands, TF32_K_CHUNK of k at a time."""
    k = a.shape[-1]
    for lo in range(0, k, TF32_K_CHUNK):
        _sub_(c, a[..., lo:lo + TF32_K_CHUNK], b[..., lo:lo + TF32_K_CHUNK, :])


def sub_mm_(c, a, b, precision="highest"):
    """c -= a @ b in place: addmm_ for matrices, baddbmm_ for a batch of
    them. precision "highest" is true fp32; "high" is split TF32, the
    small cross products hi.lo and lo.hi first, then hi.hi; "default" one
    TF32 product; both in k chunks of TF32_K_CHUNK."""
    if precision == "highest":
        _sub_(c, a, b)
        return
    with tf32_matmul():
        if precision == "high":
            ah, al = split_tf32(a)
            bh, bl = split_tf32(b)
            _sub_tf32_(c, ah, bl)
            _sub_tf32_(c, al, bh)
            _sub_tf32_(c, ah, bh)
        elif precision == "default":
            _sub_tf32_(c, round_tf32(a), round_tf32(b))
        else:
            raise ValueError(f"unknown GEMM precision {precision!r}; "
                             f"expected one of {GEMM_PRECISIONS}")


def solve_lx_(l, b, precision="highest"):
    """L X = B in place on b (n, k) or (B, n, k), any strides; the
    coupling GEMMs at `precision`."""
    n = l.shape[-1]
    if n <= _BASE:
        trsm_cuda.trsm_(l, b, left=True, transpose=False)
        return b
    m = _split_point(n)
    solve_lx_(l[..., :m, :m], b[..., :m, :], precision)
    sub_mm_(b[..., m:, :], l[..., m:, :m], b[..., :m, :], precision)
    solve_lx_(l[..., m:, m:], b[..., m:, :], precision)
    return b


def solve_ltx_(l, b, precision="highest"):
    """L^T X = B in place on b (n, k) or (B, n, k), any strides."""
    n = l.shape[-1]
    if n <= _BASE:
        trsm_cuda.trsm_(l, b, left=True, transpose=True)
        return b
    m = _split_point(n)
    solve_ltx_(l[..., m:, m:], b[..., m:, :], precision)
    sub_mm_(b[..., :m, :], l[..., m:, :m].mT, b[..., m:, :], precision)
    solve_ltx_(l[..., :m, :m], b[..., :m, :], precision)
    return b


def solve_xlt_(l, b, precision="highest"):
    """X L^T = B in place on b (k, n) or (B, k, n): L X^T = B^T on b's
    transposed view, split at the same points as trsm.solve_xlt's column
    recursion."""
    solve_lx_(l, b.mT, precision)
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
