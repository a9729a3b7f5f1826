"""The program's reads of device values by the host an operation (its
``host_read.*`` counters: the finite guard, the jitter ladder, CG's
convergence test, fit_iterative's value), for every metric of the
``host_reads`` family: ``host_reads.fit``, ``host_reads.iterative`` a fit
step, ``host_reads.predict`` a posterior request."""

from portbench.spans import host_reads_per_op


def read(run):
    return host_reads_per_op(run)
