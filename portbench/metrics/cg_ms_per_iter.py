"""Device milliseconds a CG iteration: the window's ``cugp.cg_solve``
spans (each a whole solve: its warm start's matvec, the iterations and
their convergence reads) over the iterations fit_iterative counted
(info["cg_iters"])."""

from portbench.spans import span_ms_per


def read(run):
    return span_ms_per(run, "cugp.cg_solve",
                       sum(run.counters.get("cg_iters") or ()))
