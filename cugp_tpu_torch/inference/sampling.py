"""Facade over HMC/NUTS for hyperparameter posteriors (the api.GP entry
point), as ``cugp_tpu/inference/sampling.py``'s dense engine.

Flattens the log-space param dict to a vector in jax's tree order (so a
flat vector lines up with the JAX package's ``ravel_pytree``), builds the
posterior log density (LML + prior) over a batch of such vectors, runs
hmc/nuts with the chains as one batch, and unflattens the samples.
Every evaluation of the density is one batched LML: one covariance
launch, one batched Cholesky (potrf's batch route at the base) and
batched TRSM launches for all chains.

Not ported in this slice (ROADMAP.md §1, item 14's remainder):
``sample_hyperparams_checkpointed`` and the iterative engine
(``make_iterative_logprob``, ``sample_hyperparams_iterative``,
``cg_diagnostic``). The JAX package caches the closures it hands to
jit; eager PyTorch recompiles nothing, so there is no cache here.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.inference import hmc as hmc_lib
from cugp_tpu_torch.inference import nuts as nuts_lib
from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.utils.params import ravel_pytree


def make_flat_logprob(init_params, X, y, kind="rbf", jitter=1e-6,
                      method="auto", log_prior=hmc_lib.default_log_prior):
    """Returns (logprob_and_grad over flat q, unravel, q0_flat).

    logprob_and_grad maps q (B, D) to (logp (B,), grad (B, D)) through
    one batched LML (its gradient by autograd of the sum over chains).
    """
    q0, unravel = ravel_pytree(init_params)

    def flat_lml(q):
        return exact_gp.log_marginal_likelihood(
            unravel(q), X, y, kind=kind, jitter=jitter, method=method)

    return hmc_lib.make_logprob(flat_lml, log_prior), unravel, q0


def init_chains(q0, rng, n_chains, scale=0.2):
    """Overdispersed chain initializations around q0: q0 + scale * a
    (n_chains, D) standard-normal draw."""
    draws = hmc_lib.as_draws(rng, q0.device)
    noise = scale * draws.normal((n_chains, q0.shape[0]), q0.device)
    return q0[None, :] + noise


def sample_hyperparams(init_params, X, y, *, kind="rbf", jitter=1e-6,
                       method="auto", num_samples=512, num_chains=8,
                       num_warmup=256, sampler="nuts", rng=None,
                       max_tree_depth=8, eps0=0.1, target_accept=0.8,
                       log_prior=hmc_lib.default_log_prior, chain_block=0):
    """NUTS/HMC posterior over kernel hyperparameters.

    rng: a torch.Generator or hmc.Draws (the chains' initial jitter is
    drawn first, then the run's draws); None: a generator on X's device
    seeded 0. Returns dict with "samples": the params tree with
    (num_samples, n_chains, ...) leaves in log-space, plus the sampler's
    diagnostics.
    """
    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler: {sampler}")
    draws = hmc_lib.as_draws(rng, X.device)
    logprob_and_grad, unravel, q0 = make_flat_logprob(
        init_params, X, y, kind=kind, jitter=jitter, method=method,
        log_prior=log_prior)
    qs0 = init_chains(q0, draws, num_chains)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, eps0=eps0,
              target_accept=target_accept, chain_block=chain_block)
    if sampler == "nuts":
        out = nuts_lib.run_nuts(qs0, draws, logprob_and_grad,
                                max_depth=max_tree_depth, **kw)
    else:
        out = hmc_lib.run_hmc(qs0, draws, logprob_and_grad, n_leapfrog=32,
                              **kw)
    out["samples"] = unravel(out.pop("samples_flat"))  # (S, C, dim) leaves
    return out


def potential_scale_reduction(x):
    """Split-R-hat over (num_samples, n_chains) scalar draws."""
    x = torch.as_tensor(x)
    s = x.shape[0]
    half = s // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)  # (half, 2c)
    n = x.shape[0]
    chain_means = x.mean(dim=0)
    chain_vars = x.var(dim=0, correction=1)
    w = chain_vars.mean()
    b = n * chain_means.var(correction=1)
    var_est = (n - 1) / n * w + b / n
    return torch.sqrt(var_est / w)


def effective_sample_size(x, max_lag=100):
    """Crude ESS via initial positive-sequence autocorrelation sum."""
    x = torch.as_tensor(x)
    s = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    var = torch.mean(xc * xc, dim=0) + 1e-12
    rhos = torch.stack([torch.mean(xc[:-lag] * xc[lag:], dim=0) / var
                        for lag in range(1, min(max_lag, s - 1))])  # (L, c)
    # truncate at first negative autocorrelation (per chain)
    pos = torch.cumprod((rhos > 0).to(rhos.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rhos * pos, dim=0)
    return torch.sum(s / torch.clamp(tau, min=1.0))
