"""CG iterations a matrix-free fit step, from fit_iterative's own count
(info["cg_iters"]) over the window's steps."""


def read(run):
    iters = run.counters.get("cg_iters")
    if not iters:
        return None
    return sum(iters) / len(iters)
