"""The yardstick's frozen arithmetic: the H100's peaks, the roofline
bounds of single kernel launches, and the model FLOP counts of a whole
step or request.

Copied, not imported, so that a later change to the program or to
``chip_smoke.py`` cannot move what the benchmark measures against.
``PEAK_FP32_FLOPS``, ``PEAK_HBM_BYTES``, ``bound``, ``matvec_bound`` and
``trsm_bound`` are copies of ``chip_smoke.py``'s ``PEAK_*``, ``bound``,
``_matvec_bound`` and ``_trsm_bound`` (as of commit ebb90cf).

The model FLOP counts are fixed by the shapes, whatever implements
them: a later change that removes work raises the share of the peak,
it does not break the count.
"""

from __future__ import annotations

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W); fp32 is the
# non-tensor rate, since the program runs true fp32 (TF32 off)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound(nbytes, flops):
    """(least ms the card could take, what bounds it): bytes moved once
    over the HBM rate, or fp32 operations over the non-tensor peak."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return ((1e3 * t_bytes, "bytes") if t_bytes >= t_ops
            else (1e3 * t_ops, "operations"))


def matvec_bound(n, d, r):
    """One (K + diag) V launch of the fused covariance matvec. Each entry
    of K: 2d flops of cross term, 3 of exponent, 2r of contraction; the
    bytes are X and V read once and the output written once."""
    return bound(4 * (n * d + 2 * n * r), n * n * (2 * d + 3 + 2 * r))


def trsm_bound(n, k):
    """One triangular solve launch with an (n, n) L and k right-hand
    sides: L's lower triangle and B read once, X written once; n^2 k
    fp32 flops."""
    return bound(4 * (n * (n + 1) // 2 + 2 * n * k), n ** 2 * k)


def dense_fit_step_flops(n, d, num_hyper):
    """One exact-GP LML and gradient step: n^3/3 for the factor, 2n^3/3
    for the inverse that the gradient's trace term needs, 2n^2 d for the
    covariance and 2n^2 for the trace product of each hyperparameter."""
    return n ** 3 / 3 + 2 * n ** 3 / 3 + 2 * n * n * d + 2 * n * n * num_hyper


def predict_request_flops(n, d, b):
    """One posterior request of b test points against n training rows:
    the cross covariance (2ndb), the solve with the factor (n^2 b) and
    the mean and variance reductions (2nb). No factorization is counted,
    so a program that caches the factor cannot pass 100%."""
    return 2 * n * d * b + n * n * b + 2 * n * b


def matrix_free_step_flops(n, d, r, cg_iters):
    """One matrix-free fit step: each CG iteration one fused matvec with
    r columns (n^2 (2d + 3 + 2r)), plus one pass of the gradient sweep
    over the same columns."""
    return (cg_iters + 1) * n * n * (2 * d + 3 + 2 * r)
