"""Faults planted under the timed path, to show that the check catches
them (``tests/test_pb_harness.py`` on the CPU, ``calibrate.py`` on the
card, where a fault's readings bound a limit from above). Never used by
a benchmark run.

- ``unchanged``: every optimizer step leaves the params as they were
  (the step runs, then the params are put back).
- ``half_batch``: half of the batch left out, the rest counted twice
  (the mean over what is left): the LML over half the rows, the
  gradient sweep over half the rows, half of a request's points served.
- ``altered``: one answer altered where it is produced: the LML, one
  entry of the CG solution, one posterior mean.
- ``swapped_dims``: the ARD lengthscales' gradients handed to Adam one
  dimension along (rolled by one), which keeps their norm.
- ``probe_subset``: the matrix-free fit solves and sweeps with the first
  half of the frozen probes only.

The exchange between chips does not exist in a one-card cell.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.hooks import patched

# the faults each driver's cells can have
FAULTS_BY_DRIVER = {
    "fit": ("unchanged", "half_batch", "altered", "swapped_dims"),
    "fit_iterative": ("unchanged", "half_batch", "altered", "swapped_dims",
                      "probe_subset"),
    "predict": ("half_batch", "altered"),
}
FAULTS = tuple(dict.fromkeys(f for fs in FAULTS_BY_DRIVER.values()
                             for f in fs))


@contextlib.contextmanager
def _params_unchanged():
    orig = torch.optim.Adam.step

    def step(self, *args, **kw):
        kept = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = orig(self, *args, **kw)
        with torch.no_grad():
            for p, v in zip((p for g in self.param_groups
                             for p in g["params"]), kept):
                p.copy_(v)
        return out

    torch.optim.Adam.step = step
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


@contextlib.contextmanager
def _swapped_dims():
    orig = torch.optim.Adam.step

    def step(self, *args, **kw):
        with torch.no_grad():
            for g in self.param_groups:
                for p in g["params"]:
                    if p.grad is not None and p.grad.numel() > 1:
                        p.grad.copy_(torch.roll(p.grad, 1))
        return orig(self, *args, **kw)

    torch.optim.Adam.step = step
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


def _half(n):
    """The half that is kept: the larger one."""
    return (n + 1) // 2


@contextlib.contextmanager
def planted(fault, driver):
    """Plant `fault` under the path of `driver` ("fit", "fit_iterative"
    or "predict")."""
    from cugp_tpu_torch.inference import iterative, map_opt
    from cugp_tpu_torch.models import exact_gp

    if fault not in FAULTS_BY_DRIVER.get(driver, ()):
        raise ValueError(f"no fault {fault!r} for driver {driver!r}; "
                         f"expected one of {FAULTS_BY_DRIVER.get(driver)}")
    if fault == "unchanged":
        with _params_unchanged():
            yield
        return
    if fault == "swapped_dims":
        with _swapped_dims():
            yield
        return
    if driver == "fit":
        def lml(orig):
            def log_marginal_likelihood(params, X, y, *a, **kw):
                if fault == "altered":
                    return orig(params, X, y, *a, **kw) + 1.0
                h = _half(X.shape[0])
                return 2.0 * orig(params, X[:h], y[..., :h], *a, **kw)
            return log_marginal_likelihood

        with patched(exact_gp, "log_marginal_likelihood", lml):
            yield
    elif fault == "probe_subset":
        def fit(orig):
            def fit_iterative(*a, probes=None, num_probes=16, **kw):
                h = _half(num_probes) if probes is None \
                    else _half(probes.shape[1])
                return orig(*a, probes=None if probes is None
                            else probes[:, :h], num_probes=h, **kw)
            return fit_iterative

        with patched(map_opt, "fit_iterative", fit):
            yield
    elif driver == "fit_iterative" and fault == "half_batch":
        def sweep(orig):
            def hutchinson_grads_program(params, X, alpha, w, z, *a, **kw):
                h = _half(X.shape[0])
                g = orig(params, X[:h], alpha[:h], w[:h], z[:h], *a, **kw)
                return {k: 2.0 * v for k, v in g.items()}
            return hutchinson_grads_program

        with patched(iterative, "hutchinson_grads_program", sweep):
            yield
    elif driver == "fit_iterative":
        def solve(orig):
            def cg_solve(*a, **kw):
                sol, it = orig(*a, **kw)
                sol = sol.clone()
                sol[0, 0] += 1.0
                return sol, it
            return cg_solve

        with patched(iterative, "cg_solve", solve):
            yield
    else:  # predict
        def post(orig):
            def predict_from_factor(params, X, L, alpha, Xs, *a, **kw):
                if fault == "altered":
                    mu, var = orig(params, X, L, alpha, Xs, *a, **kw)
                    mu = mu.clone()
                    mu[0] += 0.05
                    return mu, var
                b = Xs.shape[0]
                h = _half(b)
                mu, var = orig(params, X, L, alpha, Xs[:h], *a, **kw)
                return (torch.cat([mu, mu[:b - h]]),
                        torch.cat([var, var[:b - h]]))
            return predict_from_factor

        with patched(exact_gp, "predict_from_factor", post):
            yield
