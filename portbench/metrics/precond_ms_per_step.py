"""Device milliseconds a matrix-free fit step spends in the program's
``cugp.precond_build`` span (the pivoted Cholesky and its rank x rank
factor), the window's rebuilds spread over all its steps."""

from portbench.spans import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "cugp.precond_build")
