"""Device milliseconds an operation spends in the program's
``cugp.factorize`` span (the train covariance, the safe Cholesky and
cho_solve), for every metric of the ``factor_ms`` family:
``factor_ms.fit`` a fit step, ``factor_ms.predict`` a posterior request."""

from portbench.spans import span_ms_per_op


def read(run):
    return span_ms_per_op(run, "cugp.factorize")
