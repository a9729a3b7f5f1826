"""Cholesky factorization, as ``cugp_tpu/ops/cholesky.py``.

Recursive blocked right-looking factorization with SYRK-lower trailing
updates, split at the same points as the JAX recursion:

    A = [[A11, .  ],          L11 = chol(A11)
         [A21, A22]]   ==>    L21 = A21 L11^{-T}          (recursive TRSM)
                              L22 = chol(A22 - L21 L21^T) (SYRK-lower update)

The JAX recursion builds L by concatenation at every level. Here the
forward clones K once and factors that buffer in place: the base case
writes L11 into its diagonal block (the potrf kernel on CUDA), the TRSM
overwrites A21 with L21, ``addmm_(..., alpha=-1)`` updates the lower part
of A22, and the strict upper triangle is zeroed at the end. Peak memory
is K plus this one buffer (4.3 GB + 4.3 GB at N = 32768), not a stack of
per-level copies. The GEMMs stay torch matmuls in true fp32, as the JAX
package leaves them to XLA.

The backward is Murray's Cholesky rule (Murray 2016, eq. 8-10) as an
autograd Function; its two n x n solves run through the recursive
``solve_ltx_``, so they also use the TRSM kernel on CUDA.

A batch (B, n, n) (chains or Monte Carlo draws as a leading dimension)
runs the same recursion with batched SYRK/GEMM updates (``baddbmm_``),
potrf's batch route at the base and the batched TRSM; the backward
takes the batch too.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import chol_cuda
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.ops.blocking import BASE as _BASE
from cugp_tpu_torch.ops.blocking import split_point as _split_point

# Below this size a trailing update is one full GEMM; above, the SYRK
# recursion skips the strictly-upper quadrant (as cholesky._SYRK_FULL).
_SYRK_FULL = 4096


def _syrk_lower_(a, p):
    """a -= p p^T on the (block) lower triangle; the upper is left stale."""
    n = a.shape[-1]
    if n <= _SYRK_FULL:
        trsm_ops.sub_mm_(a, p, p.mT)
        return
    m = _split_point(n)
    _syrk_lower_(a[..., :m, :m], p[..., :m, :])
    trsm_ops.sub_mm_(a[..., m:, :m], p[..., m:, :], p[..., :m, :].mT)
    _syrk_lower_(a[..., m:, m:], p[..., m:, :])


def _chol_(a):
    """Factor the lower triangle of a (n, n) or (B, n, n) view in place.

    Diagonal blocks come out lower with zeros above; the strictly-upper
    off-diagonal blocks keep stale values (cholesky zeroes them)."""
    n = a.shape[-1]
    if n <= _BASE:
        chol_cuda.potrf_(a)
        return
    m = _split_point(n)
    _chol_(a[..., :m, :m])
    trsm_ops.solve_xlt_(a[..., :m, :m], a[..., m:, :m])
    _syrk_lower_(a[..., m:, m:], a[..., m:, :m])
    _chol_(a[..., m:, m:])


def _murray_backward(l, l_bar):
    """A_bar = 1/2 L^{-T} (P + P^T) L^{-1}, P = Phi(L^T L_bar)."""
    p = l.mT @ l_bar
    p = torch.tril(p) - 0.5 * torch.diag_embed(
        torch.diagonal(p, dim1=-2, dim2=-1))
    sym = p + p.mT
    tmp = trsm_ops.solve_ltx_(l, sym)
    s = trsm_ops.solve_ltx_(l, tmp.mT.contiguous()).mT
    # s is symmetric by construction; the average keeps it exactly so
    return 0.25 * (s + s.mT)


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        l = a.detach().clone(memory_format=torch.contiguous_format)
        _chol_(l)
        l.tril_()
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        return _murray_backward(l, l_bar)


def cholesky(a, method="auto", precision=None):
    """Lower-triangular Cholesky factor of a symmetric PD (n, n) matrix,
    or of each of a (B, n, n) batch; only the lower triangle is read.

    method: 'auto' or 'pallas' — the kernels for CUDA tensors, the plain
    versions for CPU tensors. precision: only true fp32 (None) is ported.
    """
    trsm_ops.check_method(method)
    if precision is not None:
        raise NotImplementedError(
            "the TPU precision policies (HIGH, 'mixed', 'mixed_fast') are "
            "not ported; see ROADMAP.md, slice 1")
    if a.ndim not in (2, 3) or a.shape[-2] != a.shape[-1]:
        raise ValueError(f"cholesky takes (n, n) or (B, n, n), got "
                         f"{tuple(a.shape)}")
    return _Cholesky.apply(a)
