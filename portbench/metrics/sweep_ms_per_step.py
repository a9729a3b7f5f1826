"""Device milliseconds a matrix-free fit step spends in the program's
``cugp.grad_sweep`` span: the Hutchinson gradient sweep, a reverse pass
through the blocked covariance tiles."""

from portbench.spans import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "cugp.grad_sweep")
