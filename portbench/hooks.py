"""The benchmark's own observers, installed in its process around the
program's entry points. None changes what the program computes:

- ``AdamProbe``: torch's global optimizer-step hook; after an Adam
  instance's first step it works the gradient the optimizer got out of
  the state (exp_avg / (1 - beta1)).
- ``LaunchShapes``: wraps the kernel entry points ``trsm_cuda.trsm_``
  and ``cov_matvec_cuda.cov_matvec`` and records the shape of every call
  that launched (the module's ``LAUNCHES`` moved by one), for the
  rooflines of a traced run.
- ``SolveCapture``: wraps ``iterative.hutchinson_grads_program``, the
  gradient sweep every matrix-free fit step ends with, and keeps the
  solves it was given (a = K^-1 y, w = K^-1 z), the probes and the
  params.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name, wrapper_factory):
    orig = getattr(module, name)
    setattr(module, name, wrapper_factory(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


class AdamProbe:
    """The first gradient each Adam instance stepped with, in the order
    of its parameters."""

    def __init__(self):
        self.first_grads = []
        self._seen = set()

    def _hook(self, opt, args, kwargs):
        if id(opt) in self._seen:
            return
        self._seen.add(id(opt))
        grads = []
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                st = opt.state.get(p, {})
                grads.append(None if "exp_avg" not in st
                             else st["exp_avg"].detach() / (1.0 - b1))
        self.first_grads.append(grads)

    @contextlib.contextmanager
    def active(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        handle = register_optimizer_step_post_hook(self._hook)
        try:
            yield self
        finally:
            handle.remove()


class LaunchShapes:
    """Shapes of the launches of the TRSM and matvec kernels:
    trsm (batch, n, k) and cov_matvec (batch, n, d, r)."""

    def __init__(self):
        self.trsm = []
        self.cov_matvec = []

    @contextlib.contextmanager
    def active(self):
        from cugp_tpu_torch.ops import cov_matvec_cuda, trsm_cuda

        def wrap_trsm(orig):
            def trsm_(l, b, left=True, transpose=False):
                before = trsm_cuda.LAUNCHES
                out = orig(l, b, left, transpose)
                # the call that launched is the one with a left (.., n, k)
                # right-hand side; the vector and right-side forms recurse
                if (trsm_cuda.LAUNCHES == before + 1 and left
                        and b.ndim == l.ndim):
                    batch = l.shape[0] if l.ndim == 3 else 1
                    self.trsm.append((batch, l.shape[-1], b.shape[-1]))
                return out
            return trsm_

        def wrap_matvec(orig):
            def cov_matvec(xs, v, scal, kind, n):
                before = cov_matvec_cuda.LAUNCHES
                out = orig(xs, v, scal, kind, n)
                if cov_matvec_cuda.LAUNCHES == before + 1:
                    batch = xs.shape[0] if xs.ndim == 3 else 1
                    self.cov_matvec.append((batch, n, xs.shape[-1],
                                            v.shape[-1]))
                return out
            return cov_matvec

        with patched(trsm_cuda, "trsm_", wrap_trsm), \
                patched(cov_matvec_cuda, "cov_matvec", wrap_matvec):
            yield self


class SolveCapture:
    """Each matrix-free step's (params, a, w, z), in step order."""

    def __init__(self):
        self.steps = []

    @contextlib.contextmanager
    def active(self):
        from cugp_tpu_torch.inference import iterative

        def wrap(orig):
            def hutchinson_grads_program(params, X, alpha, w, z, *args,
                                         **kw):
                grads = orig(params, X, alpha, w, z, *args, **kw)
                self.steps.append({
                    "params": {k: v.detach().clone()
                               for k, v in params.items()},
                    "alpha": alpha.detach().clone(),
                    "w": w.detach().clone(), "z": z.detach()})
                return grads
            return hutchinson_grads_program

        with patched(iterative, "hutchinson_grads_program", wrap):
            yield self


def launch_counts():
    """The four kernel wrappers' LAUNCHES counters, by kernel."""
    from cugp_tpu_torch.ops import (chol_cuda, cov_cuda, cov_matvec_cuda,
                                    trsm_cuda)

    return {"cov": cov_cuda.LAUNCHES, "potrf": chol_cuda.LAUNCHES,
            "trsm": trsm_cuda.LAUNCHES, "cov_matvec": cov_matvec_cuda.LAUNCHES}
