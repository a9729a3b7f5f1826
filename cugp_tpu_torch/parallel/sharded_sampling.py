"""Chain-sharded NUTS/HMC and large-N sampling, as
``cugp_tpu/parallel/sharded_sampling.py``.

``sample_hyperparams_sharded``: the chains are split over the 'dp' mesh
axis; each rank runs the batched sampler on its chains with
``psum_axis`` the dp group, so dual averaging and the mass-matrix
moments are reduced across ranks every warm-up step and every rank
adapts identically. X and y are replicated (each rank pays the full LML
for its own chains: data parallel over chains). Random streams follow
the port's rule for devices (ROADMAP §3, F3): CPU generators, the
chains' initial positions from one seeded by ``key`` (the same on every
rank), each rank's run from one seeded by (key, its dp index), where JAX
folds the axis index into its key.

``sample_hyperparams_large_n``: a few chains replicated on every rank,
every likelihood evaluation itself sharded over the grid
(distributed_chol.distributed_lml), a chain at a time.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.inference import hmc as hmc_lib
from cugp_tpu_torch.inference import nuts as nuts_lib
from cugp_tpu_torch.inference import sampling as sampling_lib
from cugp_tpu_torch.inference.sampling import _mix64
from cugp_tpu_torch.parallel import collectives
from cugp_tpu_torch.utils.params import ravel_pytree


def _run(sampler, qs0, draws, logprob_and_grad, *, max_tree_depth, **kw):
    if sampler == "nuts":
        return nuts_lib.run_nuts(qs0, draws, logprob_and_grad,
                                 max_depth=max_tree_depth, **kw)
    if sampler == "hmc":
        return hmc_lib.run_hmc(qs0, draws, logprob_and_grad, n_leapfrog=32,
                               **kw)
    raise ValueError(f"unknown sampler: {sampler}")


def rank_generator(key, index):
    """The CPU generator of stream `index` under seed `key`."""
    return torch.Generator().manual_seed(_mix64(_mix64(int(key)) ^ index))


def sample_hyperparams_sharded(init_params, X, y, mesh, *, kind="rbf",
                               jitter=1e-6, method="auto", num_samples=256,
                               num_chains=None, num_warmup=256,
                               sampler="nuts", key=None, max_tree_depth=8,
                               eps0=0.1, target_accept=0.8, rng=None):
    """NUTS/HMC with the chains sharded over mesh axis 'dp'.

    num_chains: total chains (divisible by the dp size); default 8 a
    rank. key: an int seed (0 when None). rng: this rank's draws instead
    (a torch.Generator or hmc.Draws): its first normal draw is the
    (num_chains, D) initial jitter of every chain, then this rank's run.
    Returns sampling.sample_hyperparams' dict with samples
    (num_samples, num_chains, ...) gathered across ranks, plus
    eps_per_chip (dp,) and inv_mass_per_chip (dp, D), the same on every
    rank.
    """
    dp = mesh.shape["dp"]
    if num_chains is None:
        num_chains = 8 * dp
    if num_chains % dp:
        raise ValueError(f"num_chains={num_chains} not divisible by dp={dp}")
    g = mesh.group("dp")
    key = 0 if key is None else key
    logprob_and_grad, unravel, q0 = sampling_lib.make_flat_logprob(
        init_params, X, y, kind=kind, jitter=jitter, method=method)
    if rng is None:
        init_draws = hmc_lib.Draws(rank_generator(key, 0))
        draws = hmc_lib.Draws(rank_generator(key, 1 + g.index))
    else:
        init_draws = draws = hmc_lib.as_draws(rng, X.device)
    qs0 = sampling_lib.init_chains(q0, init_draws, num_chains)
    local = num_chains // dp
    out = _run(sampler, qs0[g.index * local:(g.index + 1) * local], draws,
               logprob_and_grad, max_tree_depth=max_tree_depth,
               num_warmup=num_warmup, num_samples=num_samples, eps0=eps0,
               target_accept=target_accept, psum_axis=g)
    flat = collectives.all_gather(out["samples_flat"], g, dim=1)
    accept = collectives.all_gather(out["accept_rate"][None], g)
    return {
        "samples": unravel(flat),
        "samples_flat": flat,
        "accept_rate": torch.mean(accept),
        "eps_per_chip": collectives.all_gather(out["eps"][None], g),
        "inv_mass_per_chip": collectives.all_gather(out["inv_mass"][None],
                                                    g),
    }


def sample_hyperparams_large_n(init_params, X_loc, y_loc, mesh, *,
                               kind="rbf", jitter=1e-6, chunk=8192,
                               num_samples=256, num_chains=4,
                               num_warmup=256, sampler="nuts", key=None,
                               max_tree_depth=8, eps0=0.1,
                               target_accept=0.8, rng=None):
    """Hyperparameter MCMC where every likelihood evaluation is itself
    sharded over the grid (BASELINE config 5's shape).

    X_loc, y_loc: this rank's rows over ('dp', 'r'), distributed_lml's
    layout; each leapfrog step runs the 2D covariance build and the
    chunked distributed Cholesky for each chain. The chains are
    replicated: every rank draws the same numbers (key: an int seed, a
    CPU generator; or rng, the same on every rank). For chain-parallel
    small-N sampling use sample_hyperparams_sharded.
    """
    from cugp_tpu_torch.parallel import distributed_chol

    q0, unravel = ravel_pytree(init_params)

    def lml_fn(q):
        return torch.stack([distributed_chol.distributed_lml(
            unravel(qc), X_loc, y_loc, mesh, kind=kind, jitter=jitter,
            chunk=chunk) for qc in q])

    logprob_and_grad = hmc_lib.make_logprob(lml_fn)
    draws = hmc_lib.as_draws(
        rng if rng is not None else rank_generator(key or 0, 0),
        X_loc.device)
    qs0 = sampling_lib.init_chains(q0, draws, num_chains)
    out = _run(sampler, qs0, draws, logprob_and_grad,
               max_tree_depth=max_tree_depth, num_warmup=num_warmup,
               num_samples=num_samples, eps0=eps0,
               target_accept=target_accept)
    flat = out.pop("samples_flat")
    out["samples"] = unravel(flat)
    out["samples_flat"] = flat
    return out
