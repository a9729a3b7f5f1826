"""Facade over HMC/NUTS for hyperparameter posteriors (the api.GP entry
point), as ``cugp_tpu/inference/sampling.py``.

Flattens the log-space param dict to a vector in jax's tree order (so a
flat vector lines up with the JAX package's ``ravel_pytree``), builds the
posterior log density (LML + prior) over a batch of such vectors, runs
hmc/nuts with the chains as one batch, and unflattens the samples.

Two engines. The dense one (``make_flat_logprob``): every evaluation of
the density is one batched LML, one covariance launch, one batched
Cholesky (potrf's batch route at the base) and batched TRSM launches
for all chains. The matrix-free one (``make_iterative_logprob``, for n
beyond the dense ceiling): every evaluation is one batched
preconditioned CG for [y | Z] and one batched Lanczos on the fused
matvec kernel's batched launch, then one AD sweep through the blocked
route (the covariance tile's batched launch), for all chains together.
``sample_hyperparams_checkpointed`` runs either engine in segments with
an atomic checkpoint of the chain state after each, so a killed run
resumes to the same draws.

The JAX package caches the closures it hands to jit; eager PyTorch
recompiles nothing, so there is no cache here.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from cugp_tpu_torch.inference import hmc as hmc_lib
from cugp_tpu_torch.inference import iterative
from cugp_tpu_torch.inference import nuts as nuts_lib
from cugp_tpu_torch.inference.map_opt import check_iterative_schedule
from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.utils import checkpoint
from cugp_tpu_torch.utils.params import ravel_pytree

# the probes' seed when none are given (the JAX package's key(7))
DEFAULT_PROBE_SEED = 7


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
    drawn first, then the run's draws); None: a CPU generator
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


def _mix64(x):
    """splitmix64's finalizer: a well-spread 64-bit function of x."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def segment_generator(key_data, draws_done, device=None):
    """The generator of the segment that starts after draws_done draws:
    seeded from the run's base bits and the draw counter (the counterpart
    of ``jax.random.fold_in(base_key, draws_done)``), so segments
    compose and a resumed run draws what the uninterrupted one drew.
    It is a CPU generator whatever ``device`` the chains live on (its
    draws move there), so a checkpoint resumes to the same draws on
    any device."""
    seed = 0
    for word in np.asarray(key_data, np.uint32).ravel():
        seed = _mix64(seed ^ int(word))
    seed = _mix64(seed ^ _mix64(int(draws_done)))
    return torch.Generator().manual_seed(seed)


def cg_diagnostic(params, precond, X, y, *, kind="rbf", jitter=1e-6,
                  block=4096, tol=1e-5, max_iters=500):
    """CG iteration count for one (K + noise I) x = y solve under the
    given preconditioner factors (Lk, Lg, s2): the staleness probe of
    long-running samplers."""
    _x, it = iterative.cg_solve_program(
        params, X, y, precond=precond, kind=kind, jitter=jitter,
        block=block, tol=tol, max_iters=max_iters)
    return float(it)


def _probes(n, num_probes, Z, probe_rng, device):
    """The frozen (n, num_probes) Rademacher probes on device: Z as
    given, else drawn from probe_rng, else from a CPU generator seeded 7
    (the same probes on every device)."""
    if Z is not None:
        return torch.as_tensor(Z, dtype=torch.float32, device=device)
    if probe_rng is None:
        probe_rng = torch.Generator().manual_seed(DEFAULT_PROBE_SEED)
    return iterative.rademacher(n, num_probes, device, probe_rng)


def probe_digest(Z):
    """A short fingerprint of the probes' bits, saved with an iterative-
    engine checkpoint: a resume under other probes is detected by it."""
    a = np.ascontiguousarray(Z.detach().cpu().numpy(), np.float32)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def make_iterative_logprob(init_params, X, y, *, kind="rbf", jitter=1e-6,
                           block=4096, tol=1e-5, max_iters=500,
                           num_probes=16, num_steps=32, probe_rng=None,
                           Z=None, precond=None,
                           log_prior=hmc_lib.default_log_prior):
    """(logprob_and_grad, unravel, q0) over flat vectors with the
    MATRIX-FREE LML: hyperparameter posteriors at n beyond the dense
    Cholesky ceiling. logprob_and_grad maps q (B, D) to (logp (B,),
    grad (B, D)), every chain in the same batched launches.

    Per evaluation: one batched preconditioned CG for [y | Z] (alpha =
    K^-1 y for the quadratic term, w = K^-1 Z for the gradient's trace),
    the SLQ logdet on the same probes Z, and the gradient by one reverse
    sweep of 1/2 (alpha^T K alpha - mean_j w_j^T K z_j) (alpha and w held
    constant) through the blocked route, then the log prior.

    The Rademacher probes Z (n, num_probes) are drawn ONCE and FROZEN
    across every transition, chain and leapfrog step (the JAX package's
    documented bias trade): the chain targets a fixed approximation of
    the posterior (logdet and trace carry an O(1/sqrt(num_probes))
    error) and is exact for it. Z: the probes as a tensor (the tests
    feed the JAX package's); else drawn from probe_rng, a
    torch.Generator; else from a CPU generator seeded 7.

    precond: optional (Lk, Lg, s2) factors built at a representative
    point (iterative.precond_factors). They shape CG's convergence,
    never its fixed point.
    """
    q0, unravel = ravel_pytree(init_params)
    n = X.shape[0]
    z = _probes(n, num_probes, Z, probe_rng, X.device)
    pre = (iterative.precond_apply_from_factors(*precond)
           if precond is not None else None)

    def logprob_and_grad(q):
        q = q.detach()
        b = q.shape[0]
        zb = z.expand(b, *z.shape)
        with torch.no_grad():
            p = unravel(q)
            mv = iterative.make_matvec(p, X, kind=kind, jitter=jitter,
                                       block=block)
            rhs = torch.cat([y.expand(b, n)[..., None], zb], dim=-1)
            sol, _its = iterative.cg_solve(mv, rhs, tol=tol,
                                           max_iters=max_iters,
                                           precond_apply=pre)
            alpha, w = sol[..., 0], sol[..., 1:]
            logdet = iterative.slq_logdet(mv, n, Z=zb, num_steps=num_steps)
            value = (-0.5 * torch.sum(y * alpha, dim=-1) - 0.5 * logdet
                     - 0.5 * n * iterative.LOG2PI)
        qg = q.requires_grad_(True)
        with torch.enable_grad():
            est = iterative.hutchinson_estimator(
                unravel(qg), X, alpha, w, z, kind=kind, jitter=jitter,
                block=block)
            prior = log_prior(qg)
            (grad,) = torch.autograd.grad(torch.sum(est + prior), qg)
        return value + prior.detach(), grad

    return logprob_and_grad, unravel, q0


def _precond_factors(params, X, precond_rank, precond_where, kind, jitter):
    check_iterative_schedule(precond_where=precond_where)
    return iterative.precond_factors(params, X, precond_rank, kind=kind,
                                     jitter=jitter)


def sample_hyperparams_iterative(
        init_params, X, y, *, kind="rbf", jitter=1e-6, num_samples=256,
        num_chains=8, num_warmup=128, sampler="hmc", rng=None,
        n_leapfrog=16, max_tree_depth=8, eps0=0.05, target_accept=0.8,
        log_prior=hmc_lib.default_log_prior, chain_block=0, block=4096,
        tol=1e-5, max_iters=500, num_probes=16, num_steps=32,
        precond_rank=0, precond_where="auto", probe_rng=None, Z=None):
    """NUTS/HMC over kernel hyperparameters with the matrix-free LML.

    The contract of sample_hyperparams, but every density evaluation is
    CG + SLQ instead of a dense Cholesky (make_iterative_logprob): K is
    never formed, so the hyperparameter posterior is reachable at n =
    32k-100k+ on one card. precond_rank > 0 builds pivoted-Cholesky
    factors ONCE at init_params on the device (precond_where "host"
    raises: ROADMAP item 12) and reuses them for every transition. rng:
    a torch.Generator or hmc.Draws (the chains' initial jitter first,
    then the run's draws); None: a CPU generator seeded 0.
    Returns the sample_hyperparams dict plus "samples_flat".
    """
    hmc_lib.check_chain_block(chain_block)
    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler: {sampler}")
    precond = (_precond_factors(init_params, X, precond_rank, precond_where,
                                kind, jitter) if precond_rank else None)
    logprob_and_grad, unravel, q0 = make_iterative_logprob(
        init_params, X, y, kind=kind, jitter=jitter, block=block, tol=tol,
        max_iters=max_iters, num_probes=num_probes, num_steps=num_steps,
        probe_rng=probe_rng, Z=Z, precond=precond, log_prior=log_prior)
    draws = hmc_lib.as_draws(rng, X.device)
    qs0 = init_chains(q0, draws, num_chains)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, eps0=eps0,
              target_accept=target_accept)
    if sampler == "nuts":
        out = nuts_lib.run_nuts(qs0, draws, logprob_and_grad,
                                max_depth=max_tree_depth, **kw)
    else:
        out = hmc_lib.run_hmc(qs0, draws, logprob_and_grad,
                              n_leapfrog=n_leapfrog, **kw)
    flat = out.pop("samples_flat")
    out["samples"] = unravel(flat)
    out["samples_flat"] = flat
    return out


def sample_hyperparams_checkpointed(
        init_params, X, y, *, checkpoint_dir, checkpoint_every=64,
        kind="rbf", jitter=1e-6, method="auto", num_samples=512,
        num_chains=8, num_warmup=256, sampler="hmc", rng=None,
        n_leapfrog=32, max_tree_depth=8, eps0=0.1, target_accept=0.8,
        log_prior=hmc_lib.default_log_prior, chain_block=0,
        engine="dense", block=4096, cg_tol=1e-5, cg_max_iters=500,
        num_probes=16, num_steps=32, precond_rank=0, precond_where="auto",
        probe_rng=None, Z=None, refresh_factor=2.0, verbose=False):
    """NUTS/HMC with chain-state checkpoint/resume.

    After warm-up, the draws run in segments of `checkpoint_every`
    (hmc.sample_segment); after each segment (and once after warm-up) the
    whole sampler state is saved atomically (utils.checkpoint) with the
    JAX package's leaves: positions q, their log densities and gradients,
    step size eps, diagonal inverse mass, the base random bits
    ``key_data`` (uint32 (2,)), the samples so far (flat) and the summed
    accept probability, the draw counter as the checkpoint's step. A
    call with the same checkpoint_dir resumes: segment k draws from a
    generator seeded from the base bits and the draw counter
    (``segment_generator``), eps and inv_mass stay fixed after warm-up,
    so a killed run continues to the same draws it would have made
    uninterrupted. A larger num_samples extends a finished checkpoint.

    rng: a torch.Generator (or hmc.Draws holding one) for the chains'
    initial jitter, the base bits and the warm-up, drawn in that order;
    None: a CPU generator seeded 0. A checkpoint written by
    the JAX package resumes here: q, logp, grad, eps, inv_mass and the
    samples carry over, and the port's draws follow from its stored
    key_data bits, so they are not the draws JAX would have made. A
    checkpoint in the older 6-leaf layout (no logp/grad) resumes with
    them recomputed.

    engine="iterative": every evaluation is make_iterative_logprob (CG +
    SLQ on frozen probes Z, drawn once as it says). precond_rank > 0
    builds pivoted-Cholesky factors on the device; after every segment
    one solve at the chain-mean position (cg_diagnostic) logs the CG
    iteration count ("cg_iters_per_segment") and, when it exceeds
    refresh_factor x the best count since the factors were built, the
    factors are rebuilt there. The factors and that best count are
    checkpointed (leaves pre_lk, pre_lg, pre_s2, cg_best), so resume is
    exact. A checkpoint of one engine refuses to resume with the other.
    The checkpoint records a fingerprint of its probes
    (``probe_digest``). A checkpoint taken under other probes (the JAX
    package's, drawn from its key(7), which the port cannot redraw; or
    the port's own under another Z) resumes with logp and grad
    RECOMPUTED at the stored positions under this call's probes, so the
    state and every later evaluation belong to one frozen-probe target:
    the draws continue on this call's target, not on the writer's. Pass
    the writer's probes as Z to continue on its target.

    Returns the sample_hyperparams dict (samples, samples_flat,
    accept_rate, eps, inv_mass) plus "resumed" and "draws_done".
    """
    if engine not in ("dense", "iterative"):
        raise ValueError(f"unknown engine {engine!r}: dense | iterative")
    hmc_lib.check_chain_block(chain_block)
    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler: {sampler}")
    dev = X.device
    draws = hmc_lib.as_draws(rng, dev)
    if draws.generator is None:
        raise ValueError("sample_hyperparams_checkpointed draws its base "
                         "bits from a torch.Generator: pass one as rng")
    track_precond = engine == "iterative" and precond_rank > 0
    digest = None
    if engine == "iterative":
        Z = _probes(X.shape[0], num_probes, Z, probe_rng, dev)
        digest = probe_digest(Z)

    def build_precond(at_params):
        return _precond_factors(at_params, X, precond_rank, precond_where,
                                kind, jitter)

    def make_lp(pre):
        if engine == "dense":
            return make_flat_logprob(init_params, X, y, kind=kind,
                                     jitter=jitter, method=method,
                                     log_prior=log_prior)
        return make_iterative_logprob(
            init_params, X, y, kind=kind, jitter=jitter, block=block,
            tol=cg_tol, max_iters=cg_max_iters, num_probes=num_probes,
            num_steps=num_steps, Z=Z, precond=pre, log_prior=log_prior)

    def make_kernel(lp):
        if sampler == "hmc":
            return hmc_lib.make_hmc_kernel(lp, n_leapfrog,
                                           chain_block=chain_block)
        return nuts_lib.make_nuts_kernel(lp, max_tree_depth,
                                         chain_block=chain_block)

    def diagnostic(at_params, pre):
        return cg_diagnostic(at_params, pre, X, y, kind=kind, jitter=jitter,
                             block=block, tol=cg_tol, max_iters=cg_max_iters)

    old_meta = checkpoint.peek_meta(checkpoint_dir)
    if old_meta is not None:
        old_engine = old_meta.get("extra", {}).get("engine", "dense")
        if old_engine != engine:
            raise ValueError(
                f"checkpoint at {checkpoint_dir} was written by the "
                f"{old_engine!r} engine; resuming it with "
                f"engine={engine!r} would silently change the target "
                "density; use a fresh checkpoint_dir")
    precond = (build_precond(init_params)
               if track_precond and old_meta is None else None)
    logprob_and_grad, unravel, q0 = make_lp(precond)
    dim = q0.shape[0]
    probe = {"q": 0, "logp": 0, "grad": 0, "eps": 0, "inv_mass": 0,
             "key_data": 0, "samples": 0, "accept_sum": 0}
    if track_precond:
        probe.update(pre_lk=0, pre_lg=0, pre_s2=0, cg_best=0)
    if (old_meta is not None and engine == "dense"
            and old_meta.get("num_leaves") == len(probe) - 2):
        # the layout before logp/grad were checkpointed: recompute them
        tree, meta = checkpoint.restore(
            checkpoint_dir, {k: 0 for k in probe if k not in ("logp",
                                                              "grad")})
        logp_m, grad_m = logprob_and_grad(torch.as_tensor(
            tree["q"], dtype=torch.float32, device=dev))
        tree["logp"], tree["grad"] = logp_m.cpu().numpy(), grad_m.cpu(
        ).numpy()
    else:
        tree, meta = checkpoint.restore(checkpoint_dir, probe)
    resumed = tree is not None

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cg_best = None
    if resumed:
        draws_done = int(meta["step"])
        eps, inv_mass = t32(tree["eps"]), t32(tree["inv_mass"])
        key_data = np.asarray(tree["key_data"], np.uint32)
        samples_list = ([np.asarray(tree["samples"], np.float32).reshape(
            draws_done, num_chains, dim)] if draws_done else [])
        accept_sum = float(tree["accept_sum"])
        state = hmc_lib.HMCState(t32(tree["q"]), t32(tree["logp"]),
                                 t32(tree["grad"]))
        if track_precond:
            precond = (t32(tree["pre_lk"]), t32(tree["pre_lg"]),
                       t32(tree["pre_s2"]))
            cg_best = float(tree["cg_best"])
            logprob_and_grad, unravel, q0 = make_lp(precond)
        if (engine == "iterative"
                and meta["extra"].get("probe_digest") != digest):
            # taken under other probes: re-evaluate the stored positions
            # on this call's target
            state = hmc_lib.HMCState(state.q, *logprob_and_grad(state.q))
    else:
        draws_done = 0
        qs0 = init_chains(q0, draws, num_chains)
        key_data = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                                 generator=draws.generator,
                                 device=draws.generator.device).cpu().numpy(
                                 ).astype(np.uint32)
        state, eps, inv_mass = hmc_lib.warmup_adapt(
            hmc_lib.init_state(qs0, logprob_and_grad), draws,
            make_kernel(logprob_and_grad), num_warmup, eps0, target_accept)
        samples_list = []
        accept_sum = 0.0
        if track_precond:
            cg_best = diagnostic(unravel(torch.mean(state.q, dim=0)),
                                 precond)
    kernel = make_kernel(logprob_and_grad)

    def save(state):
        flat = (np.concatenate([s.reshape(-1) for s in samples_list])
                if samples_list else np.zeros(0, np.float32))
        blob = {"q": state.q, "logp": state.logp, "grad": state.grad,
                "eps": eps, "inv_mass": inv_mass, "key_data": key_data,
                "samples": flat, "accept_sum": np.asarray(accept_sum)}
        if track_precond:
            blob.update(pre_lk=precond[0], pre_lg=precond[1],
                        pre_s2=precond[2],
                        cg_best=np.asarray(cg_best, np.float32))
        extra = {"sampler": sampler, "kind": kind, "num_chains": num_chains,
                 "num_warmup": num_warmup, "engine": engine}
        if digest is not None:
            extra["probe_digest"] = digest
        checkpoint.save(checkpoint_dir, blob, step=draws_done,
                        extra_json=extra)

    if not resumed:
        save(state)  # the warm-up survives a kill before the first segment

    cg_iters_log = []
    while draws_done < num_samples:
        seg = min(checkpoint_every, num_samples - draws_done)
        state, qs, aprobs, _aux = hmc_lib.sample_segment(
            state, segment_generator(key_data, draws_done, dev), kernel,
            eps, inv_mass, seg)
        samples_list.append(qs.cpu().numpy().astype(np.float32))
        accept_sum += float(torch.sum(aprobs))
        draws_done += seg
        if track_precond:
            # one solve at the chain mean: rebuild only when the stale
            # factors cost real iterations
            p_mean = unravel(torch.mean(state.q, dim=0))
            it = diagnostic(p_mean, precond)
            cg_iters_log.append(it)
            if verbose:
                print(f"# ckpt-sample: draws={draws_done} cg_it={it} "
                      f"(best {cg_best:.0f})", file=sys.stderr, flush=True)
            if it > refresh_factor * cg_best:
                precond = build_precond(p_mean)
                logprob_and_grad, unravel, q0 = make_lp(precond)
                kernel = make_kernel(logprob_and_grad)
                cg_best = diagnostic(p_mean, precond)
            else:
                cg_best = min(cg_best, it)
        save(state)

    flat = (np.concatenate(samples_list, axis=0) if samples_list
            else np.zeros((0, num_chains, dim), np.float32))
    flat = torch.as_tensor(flat[:num_samples], device=dev)
    out = {
        "samples": unravel(flat),
        "samples_flat": flat,
        "accept_rate": torch.as_tensor(
            accept_sum / max(draws_done * num_chains, 1),
            dtype=torch.float32, device=dev),
        "eps": eps,
        "inv_mass": inv_mass,
        "resumed": resumed,
        "draws_done": draws_done,
    }
    if track_precond:
        out["cg_iters_per_segment"] = cg_iters_log
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
