"""Variational inference over kernel hyperparameters, as
``cugp_tpu/inference/vi.py``.

Gaussian q(theta) in log-space, mean-field or full-rank (Cholesky-
parameterized), trained by maximizing the reparameterized ELBO

  ELBO = E_q[ LML(theta) + log prior(theta) ] + H[q]

with Adam. The ELBO's num_mc Monte Carlo draws are one batch: each step
evaluates the LML of all of them in one batched call (one covariance
launch, one batched Cholesky, batched solves), and autograd carries the
gradient back to the variational parameters. The loop is
``map_opt.adam_fit``: optax.adam's update under
``optax.apply_if_finite``'s rule with the JAX package's count (1000).
The JAX package's scan keys become draws from one hmc.Draws: each
step's (num_mc, D) standard normals in turn.
"""

from __future__ import annotations

import math

import torch

from cugp_tpu_torch.inference import hmc as hmc_lib
from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.models.svgp import chol_from_flat as _chol_from_flat
from cugp_tpu_torch.utils.params import ravel_pytree

_LOG_2PI = math.log(2.0 * math.pi)


def _entropy_meanfield(log_scale):
    d = log_scale.shape[0]
    return torch.sum(log_scale) + 0.5 * d * (1.0 + _LOG_2PI)


def _entropy_fullrank(chol_flat, dim):
    # chol_flat holds the lower triangle; diagonal stored as log
    return torch.sum(chol_flat[:dim]) + 0.5 * dim * (1.0 + _LOG_2PI)


def _sample(vp, eps, rank, dim):
    """q draws (num_mc, dim) from standard normals eps (num_mc, dim)."""
    if rank == "meanfield":
        return vp["mean"][None, :] + torch.exp(vp["log_scale"])[None, :] * eps
    return vp["mean"][None, :] + eps @ _chol_from_flat(vp["chol"], dim).T


def _entropy(vp, rank, dim):
    if rank == "meanfield":
        return _entropy_meanfield(vp["log_scale"])
    return _entropy_fullrank(vp["chol"], dim)


def neg_elbo(vp, eps, logprob, rank, dim):
    """-(mean of logprob over the draws + entropy); logprob maps the
    (num_mc, dim) draws to (num_mc,) in one batched call."""
    qs = _sample(vp, eps, rank, dim)
    return -(torch.mean(logprob(qs)) + _entropy(vp, rank, dim))


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=2000, learning_rate=0.01, rank="meanfield", num_mc=8,
        rng=None, log_prior=hmc_lib.default_log_prior):
    """Fit q(theta). rng: a torch.Generator or hmc.Draws (None: a
    CPU generator seeded 0). Returns dict with the variational
    parameters "vp", the "elbo" trace (steps,), "mean" and "scale" (or
    "chol") in param-dict space, "unravel", and a sampler ``draw(rng,
    n)`` for posterior draws (a params tree with leading n)."""
    q0, unravel = ravel_pytree(init_params)
    q0 = q0.detach()
    dim = q0.shape[0]
    dev = q0.device

    def logprob(q):
        lml = exact_gp.log_marginal_likelihood(
            unravel(q), X, y, kind=kind, jitter=jitter, method=method)
        return lml + log_prior(q)

    if rank == "meanfield":
        vp = {"mean": q0.clone(), "log_scale": torch.full((dim,), -2.0,
                                                          device=dev)}
    elif rank == "fullrank":
        vp = {"mean": q0.clone(), "chol": torch.cat([
            torch.full((dim,), -2.0, device=dev),          # log-diag
            torch.zeros(dim * (dim - 1) // 2, device=dev),  # strict lower
        ])}
    else:
        raise ValueError(f"unknown rank: {rank}")
    draws = hmc_lib.as_draws(rng, dev)

    def loss_fn(v, _step):
        eps = draws.normal((num_mc, dim), dev)
        return neg_elbo(v, eps, logprob, rank, dim)

    vp, losses = map_opt.adam_fit(
        vp, loss_fn, steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=1000, clamp=False)

    def draw(rng=None, n=1):
        eps = hmc_lib.as_draws(rng, dev).normal((n, dim), dev)
        return unravel(_sample(vp, eps, rank, dim))

    out = {"vp": vp, "elbo": -losses, "mean": unravel(vp["mean"]),
           "draw": draw, "unravel": unravel}
    if rank == "meanfield":
        out["scale"] = unravel(torch.exp(vp["log_scale"]))
    else:
        out["chol"] = _chol_from_flat(vp["chol"], dim)
    return out
