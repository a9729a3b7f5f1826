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
per-level copies. The GEMMs stay torch matmuls, as the JAX package
leaves them to XLA: in true fp32 by default (TF32 off).

Precision policies (``cholesky(precision=...)``, opt-in, as the JAX
package's ``cugp_tpu/ops/cholesky.py:56-131``):
  None / "highest"  every GEMM in true fp32 (the default);
  "high"            every GEMM (SYRK updates and the panel TRSM's) in
                    split TF32: each operand split into TF32 hi + lo,
                    hi.lo + lo.hi + hi.hi on the tensor cores into the
                    fp32 sum (the TPU's HIGH is bf16_3x, three bf16
                    passes: the same idea);
  "mixed"           true fp32 on the diagonal path (potrf, the panel
                    TRSM, the SYRK quadrants that hold the diagonal down
                    to _MIXED_DIAG); the strictly-off-diagonal SYRK
                    quadrants in split TF32;
  "mixed_fast"      the diagonal path in split TF32, the strictly-off-
                    diagonal quadrants in one TF32 pass (10 mantissa
                    bits).
TF32 is switched on only around those GEMMs (``trsm.tf32_matmul``) and
is off everywhere else. On CPU tensors the same TF32 splits multiply in
fp32, which emulates the tensor cores up to accumulation order. The
base blocks (the potrf kernel) are fp32 under every policy.

The TF32 GEMMs run their contraction in chunks of trsm.TF32_K_CHUNK
(4096). On an H100 80GB HBM3 at 700 W at the north star (N=32768, d=8;
tools/chol_precision.py, PERF.md §6) unchunked "mixed" returned a factor
that is NaN from row 14738 on (an indefinite Schur complement: the
tensor cores' sum over k = 16384 lost too much on the off-diagonal
blocks alone); in chunks of 4096 it is finite, its reconstruction error
within 1.2x of fp32's on every 4096-row block, and "high"'s worst block reads
5.8e-5 against fp32's 6.2e-5. Both are then only 3-4% faster than fp32
(0.301 s and 0.306 s against 0.314 s): the operand splits cost what the
tensor cores save. "mixed_fast" is NaN from row 12766 at every chunk
size (its one-pass operands, in the CPU's fp32 emulation too). Check
the whole factor before trusting a policy.

The backward is Murray's Cholesky rule (Murray 2016, eq. 8-10) as an
autograd Function; its two n x n solves run through the recursive
``solve_ltx_``, so they also use the TRSM kernel on CUDA. It runs in
true fp32 whatever the forward's policy, as the JAX package's
``_cholesky_bwd`` ignores ``precision``. It takes an L_bar of any shape;
the exact-GP LML, whose gradient needs A^{-1} itself, does not come
through it (``models/exact_gp.log_marginal_likelihood``).

``cho_inverse(L)`` is A^{-1} from the factor, in one n x n buffer: a
triangular inverse W = L^{-1} (``_trtri_``, n^3/3) and the product
W^T W (``_neg_lauum_``, n^3/3), both recursions split at the
factorization's points, their GEMMs true fp32 and the base blocks the
TRSM kernel (against an identity tile) and one small GEMM.

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
from cugp_tpu_torch.utils import profiling

# Below this size a trailing update is one full GEMM; above, the SYRK
# recursion skips the strictly-upper quadrant (as cholesky._SYRK_FULL).
_SYRK_FULL = 4096

# The mixed policies: quadrants that hold the diagonal keep the diagonal
# path's precision down to this size; strictly-off-diagonal update GEMMs
# take the lower one (cholesky._MIXED_DIAG).
_MIXED_DIAG = 4096

# policy -> (GEMM precision of the diagonal path, of the strictly-off-
# diagonal SYRK quadrants or None for the same)
POLICIES = {None: ("highest", None), "highest": ("highest", None),
            "high": ("high", None), "mixed": ("highest", "high"),
            "mixed_fast": ("high", "default")}


def _syrk_lower_(a, p, precision="highest", offdiag=None):
    """a -= p p^T on the (block) lower triangle; the upper is left stale.
    offdiag: the strictly-off-diagonal quadrants' precision (the mixed
    policies), the quadrants holding the diagonal recursing at
    `precision` down to _MIXED_DIAG."""
    n = a.shape[-1]
    if n <= (_SYRK_FULL if offdiag is None else _MIXED_DIAG):
        trsm_ops.sub_mm_(a, p, p.mT, precision)
        return
    m = _split_point(n)
    _syrk_lower_(a[..., :m, :m], p[..., :m, :], precision, offdiag)
    trsm_ops.sub_mm_(a[..., m:, :m], p[..., m:, :], p[..., :m, :].mT,
                     precision if offdiag is None else offdiag)
    _syrk_lower_(a[..., m:, m:], p[..., m:, :], precision, offdiag)


def _chol_(a, precision="highest", offdiag=None):
    """Factor the lower triangle of a (n, n) or (B, n, n) view in place,
    the GEMMs at `precision` (and `offdiag`, see _syrk_lower_).

    Diagonal blocks come out lower with zeros above; the strictly-upper
    off-diagonal blocks keep stale values (cholesky zeroes them)."""
    n = a.shape[-1]
    if n <= _BASE:
        chol_cuda.potrf_(a)
        return
    m = _split_point(n)
    _chol_(a[..., :m, :m], precision, offdiag)
    trsm_ops.solve_xlt_(a[..., :m, :m], a[..., m:, :m], precision)
    _syrk_lower_(a[..., m:, m:], a[..., m:, :m], precision, offdiag)
    _chol_(a[..., m:, m:], precision, offdiag)


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


def _trtri_(a):
    """Invert the lower triangle of a (n, n) or (B, n, n) view in place.

    With A = [[L11, 0], [L21, L22]] split at split_point(n), the inverse
    is W = [[W11, 0], [W21, W22]], W21 = -W22 L21 W11. The off-diagonal
    block is left as V = L22^{-1} L21 L11^{-1} = -W21 (two TRSMs of the
    factor's own blocks, then W11 and W22 recurse): every off-diagonal
    block of the result, at every level, holds minus its block of W.
    _trmm_ltx_ and _neg_lauum_ read that layout. Base blocks are their
    full inverse with zeros above the diagonal."""
    n = a.shape[-1]
    if n <= _BASE:
        x = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
        x = trsm_ops.solve_lx_(a, x.contiguous())
        a.copy_(x.tril_())
        return
    m = _split_point(n)
    trsm_ops.solve_ltx_(a[..., :m, :m], a[..., m:, :m].mT)  # L21 L11^{-1}
    trsm_ops.solve_lx_(a[..., m:, m:], a[..., m:, :m])
    _trtri_(a[..., :m, :m])
    _trtri_(a[..., m:, m:])


def _trmm_ltx_(t, x):
    """x := W^T x in place, W lower triangular held in t as _trtri_
    leaves it (off-diagonal blocks negated): W^T = [[W11^T, W21^T],
    [0, W22^T]], so x1 gets W11^T x1 - t21^T x2, then x2 gets W22^T x2."""
    n = t.shape[-1]
    if n <= _BASE:
        x.copy_(torch.tril(t).mT @ x)
        return
    m = _split_point(n)
    _trmm_ltx_(t[..., :m, :m], x[..., :m, :])
    trsm_ops.sub_mm_(x[..., :m, :], t[..., m:, :m].mT, x[..., m:, :])
    _trmm_ltx_(t[..., m:, m:], x[..., m:, :])


def _neg_lauum_(a):
    """-W^T W into the lower triangle of a, which holds W as _trtri_
    leaves it; the upper triangle is left stale.

    -C11 = -lauum(W11) - W21^T W21 (the SYRK-lower update, a21 = -W21),
    -C21 = -W22^T W21 = W22^T a21, -C22 = -lauum(W22); the quadrant above
    the diagonal is never formed."""
    n = a.shape[-1]
    if n <= _BASE:
        w = torch.tril(a)
        a.copy_((w.mT @ w).neg_())
        return
    m = _split_point(n)
    _neg_lauum_(a[..., :m, :m])
    _syrk_lower_(a[..., :m, :m], a[..., m:, :m].mT)
    _trmm_ltx_(a[..., m:, m:], a[..., m:, :m])
    _neg_lauum_(a[..., m:, m:])


# Edge of the tiles in which _mirror_lower_ copies the lower triangle up.
_MIRROR_TILE = 4096


def _mirror_lower_(a):
    """Copy the strict lower triangle of a onto the upper, in place, a
    strip of _MIRROR_TILE rows at a time: the result is symmetric bit
    for bit."""
    n = a.shape[-1]
    for i in range(0, n, _MIRROR_TILE):
        j = min(i + _MIRROR_TILE, n)
        d = a[..., i:j, i:j]
        d.copy_(torch.tril(d) + torch.tril(d, -1).mT)
        a[..., i:j, j:].copy_(a[..., j:, i:j].mT)


def cho_inverse(l):
    """A^{-1} = L^{-T} L^{-1}, symmetric bit for bit, from the lower
    factor L (n, n) or (B, n, n) of A; only L's lower triangle is read.

    One n x n buffer (a copy of L): _trtri_ and _neg_lauum_ in place,
    2 n^3 / 3 flops, no quadrant known to be zero or a mirror image
    multiplied but in the base blocks and the SYRK's small diagonal
    quadrants. Not differentiable."""
    a = torch.tril(l.detach())
    _trtri_(a)
    _neg_lauum_(a)
    _mirror_lower_(a)
    return a.neg_()


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, precision, offdiag):
        l = a.detach().clone(memory_format=torch.contiguous_format)
        _chol_(l, precision, offdiag)
        l.tril_()
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        with profiling.span("cugp.chol_backward", l.device):
            profiling.count("lml_backward.murray")
            return _murray_backward(l, l_bar), None, None


def cholesky(a, method="auto", precision=None):
    """Lower-triangular Cholesky factor of a symmetric PD (n, n) matrix,
    or of each of a (B, n, n) batch; only the lower triangle is read.

    method: 'auto' or 'pallas' — the kernels for CUDA tensors, the plain
    versions for CPU tensors. precision: None or "highest" (true fp32,
    the default), "high", "mixed" or "mixed_fast" (the module docstring);
    the gradient is true fp32 under each.
    """
    trsm_ops.check_method(method)
    if precision not in POLICIES:
        raise ValueError(f"unknown precision policy {precision!r}; "
                         f"expected one of {tuple(POLICIES)}")
    if a.ndim not in (2, 3) or a.shape[-2] != a.shape[-1]:
        raise ValueError(f"cholesky takes (n, n) or (B, n, n), got "
                         f"{tuple(a.shape)}")
    return _Cholesky.apply(a, *POLICIES[precision])
