"""Device milliseconds a fit step spends in the program's
``cugp.chol_backward`` span: Murray's Cholesky backward (one N x N x N
GEMM and two N-column triangular solves)."""

from portbench.spans import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "cugp.chol_backward")
