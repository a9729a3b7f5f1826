"""Hamiltonian Monte Carlo over kernel hyperparameters, as
``cugp_tpu/inference/hmc.py``.

The target is the hyperparameter posterior, log p(theta | X, y) =
LML(theta) + log prior(theta); every leapfrog step pays a covariance
build, a Cholesky and its gradient. Chains are the leading dimension of
every tensor (the JAX package's vmap axis): positions q (C, D), log
densities (C,), gradients (C, D). A log density is a function from q
(C, D) to (logp (C,), grad (C, D)), so one call evaluates every chain
(for the GP, one batched LML: sampling.make_flat_logprob). The JAX
package's ``lax.scan``/``fori_loop`` are Python loops here; the step
size and mass adaptation stay on the device, so a transition reads
nothing back to the host beyond what its log density reads.

Random numbers come from ``Draws``: a ``torch.Generator``, or tensors
replayed in the order the samplers consume them (the tests replay the
JAX package's draws, since jax.random and torch give other numbers).

Warmup: dual-averaging step size shared across chains (mean
acceptance), plus diagonal mass-matrix adaptation from raw moments.

One deliberate difference from the JAX package: ``make_hmc_kernel``
draws each chain's step size for each transition uniformly from
[(1 - j) eps, (1 + j) eps], j = STEP_JITTER (Stan's stepsize_jitter);
``step_jitter=0`` gives the JAX package's kernel, and these drivers are
held to JAX's on its own draws (tests/test_torch_sampling.py). With one
eps for every chain and a fixed 32 steps, HMC does not converge at
BASELINE config 3 (256 chains, 64 warm-up, 64 draws): on an H100 80GB
HBM3 step_jitter=0 read split R-hat 2.30 / 3.21 / 1.23 with 4 chains
that never moved, the jitter 1.011 / 1.004 / 1.007 with none
(tools/hmc_convergence.py; PERF.md section 6; ROADMAP.md section 3).
``hmc_kernel`` itself takes the step size it is given, as in JAX.

``chain_block`` > 0 (``blocked_chains``): the log density and its
gradient are evaluated that many chains at a time, which bounds the
batched (B, n, n) covariance, factor, solves and autograd graph that a
batch of chains holds; the draws, the accept decisions and the
adaptation stay (C,)-wide, so every chain's random numbers are those of
the unblocked run. The JAX package lax.maps a vmapped per-chain kernel
over blocks of chains (padding the last with copies of chain 0); a
block here is simply smaller when chain_block does not divide C.

Cross-rank adaptation (``psum_axis``, the chain-sharded samplers of
``parallel/sharded_sampling.py``): a mesh Group (``mesh.group("dp")``)
or a torch ProcessGroup whose ranks hold consecutive blocks of the
chains, in rank order. Every rank gathers the chains' acceptance
probabilities and positions (one all_gather each) and reduces them as
one process holding every chain does, so every rank adapts to that
process's step size and mass bit for bit (JAX's pmean and psum add the
ranks' partial results instead: the adaptation is chaotic, one ulp of
a mean moving the final step size by ~1e-4, and a partial sum rounds
otherwise than the whole). ``psum_axis=None`` reduces over the local
chains only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _all_chains(x, psum_axis):
    """x (the local chains along dim 0) concatenated over the ranks of
    psum_axis (a Group or a ProcessGroup) in rank order; x itself for
    None."""
    if psum_axis is None:
        return x
    from cugp_tpu_torch.parallel import collectives

    return collectives.all_gather(x, collectives.as_group(psum_axis))


def blocked_chains(fn, chain_block):
    """fn, a function of q (C, D) returning a tuple of tensors with the
    chains leading (a logprob_and_grad), evaluated chain_block chains at
    a time and concatenated; the last block holds what is left.
    chain_block 0 (or >= C) is fn itself."""
    if chain_block < 0:
        raise ValueError(f"chain_block must be >= 0, got {chain_block}")
    if not chain_block:
        return fn

    def run(q):
        if q.shape[0] <= chain_block:
            return fn(q)
        outs = [fn(q[lo:lo + chain_block])
                for lo in range(0, q.shape[0], chain_block)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return run


class Draws:
    """The samplers' random numbers.

    From ``generator`` (a torch.Generator; its device is where the draws
    are made), or, when ``normals``/``uniforms`` are given, those tensors
    one after another in the order the samplers ask for them (each must
    have the asked shape). ``normal``/``uniform`` return float32 tensors
    on ``device``.
    """

    def __init__(self, generator=None, normals=None, uniforms=None):
        self.generator = generator
        self._normals = None if normals is None else iter(normals)
        self._uniforms = None if uniforms is None else iter(uniforms)

    def _next(self, it, shape, device, what):
        try:
            t = next(it)
        except StopIteration:
            raise ValueError(f"Draws ran out of {what} draws") from None
        t = torch.as_tensor(t, dtype=torch.float32).to(device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Draws: {what} draw of shape "
                             f"{tuple(t.shape)}, asked for {tuple(shape)}")
        return t

    def normal(self, shape, device):
        if self._normals is not None:
            return self._next(self._normals, shape, device, "normal")
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device).to(device)

    def uniform(self, shape, device):
        if self._uniforms is not None:
            return self._next(self._uniforms, shape, device, "uniform")
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device).to(device)


def as_draws(rng, device):
    """rng as Draws: a Draws as it is, a torch.Generator wrapped, None a
    CPU generator seeded 0 (the JAX package's key(0)) whose draws move to
    ``device``: the same numbers on every device."""
    if isinstance(rng, Draws):
        return rng
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    return Draws(rng)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0, device=None):
    eps0 = _f32(eps0, device)
    return DualAveragingState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        h_avg=torch.zeros((), device=eps0.device),
        mu=torch.log(10.0 * eps0),
        t=torch.zeros((), device=eps0.device),
    )


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75):
    t = state.t + 1.0
    h_avg = ((1.0 - 1.0 / (t + t0)) * state.h_avg
             + (target - accept_prob) / (t + t0))
    log_eps = state.mu - torch.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, state.mu, t)


class MomentState(NamedTuple):
    """Raw-moment accumulator for diagonal mass estimation (raw sums, so
    that a cross-device reduction would be a plain sum)."""

    count: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor


def moments_init(dim, device=None):
    return MomentState(torch.zeros((), device=device),
                       torch.zeros(dim, device=device),
                       torch.zeros(dim, device=device))


def moments_update(state, xs, psum_axis=None):
    """Accumulate a (n_chains, dim) batch of positions; with psum_axis,
    every rank's chains."""
    xs = _all_chains(xs, psum_axis)
    b = _f32(xs.shape[0], xs.device)
    s1, s2 = torch.sum(xs, dim=0), torch.sum(xs * xs, dim=0)
    return MomentState(state.count + b, state.s1 + s1, state.s2 + s2)


def moments_variance(state, regularize=True):
    n = torch.clamp(state.count, min=2.0)
    mean = state.s1 / n
    var = torch.clamp(state.s2 / n - mean * mean, min=1e-10) * (n / (n - 1.0))
    if regularize:
        # Stan-style shrinkage towards unit scale
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def leapfrog(q, p, grad, eps, inv_mass, logprob_and_grad, n_steps):
    """n_steps of leapfrog on every chain; logprob_and_grad returns
    (logp, dlogp/dq). Returns (q, p, grad, logp of the last step)."""
    logp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad  # grad of logp (ascend)
        q = q + eps * inv_mass * p
        logp, grad = logprob_and_grad(q)
        p = p + 0.5 * eps * grad
    return q, p, grad, logp


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


class HMCState(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def hmc_kernel(state, rng, eps, inv_mass, logprob_and_grad, n_leapfrog):
    """One Metropolis-corrected HMC transition of every chain. Draws: the
    (C, D) standard-normal momentum, then the (C,) accept uniforms (the
    JAX kernel's momentum key, then its accept key)."""
    draws = as_draws(rng, state.q.device)
    p0 = draws.normal(state.q.shape, state.q.device) / torch.sqrt(inv_mass)
    q1, p1, grad1, logp1 = leapfrog(state.q, p0, state.grad, eps, inv_mass,
                                    logprob_and_grad, n_leapfrog)
    h0 = -state.logp + _kinetic(p0, inv_mass)
    h1 = -logp1 + _kinetic(p1, inv_mass)
    delta = h0 - h1
    delta = torch.where(torch.isfinite(delta), delta, -torch.inf)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = draws.uniform(accept_prob.shape, state.q.device) < accept_prob
    a = accept[:, None]
    new = HMCState(q=torch.where(a, q1, state.q),
                   logp=torch.where(accept, logp1, state.logp),
                   grad=torch.where(a, grad1, state.grad))
    return new, accept_prob


def default_log_prior(q):
    """Weak N(0, 3^2) prior on each log-hyperparameter (proper posterior);
    q (..., D) -> (...)."""
    return torch.sum(-0.5 * (q / 3.0) ** 2, dim=-1)


def make_logprob(lml_fn, log_prior=default_log_prior):
    """logprob_and_grad over flat vectors: q (C, D) -> (logp (C,), grad
    (C, D)), the gradient by autograd through one evaluation of every
    chain (summed over chains; the chains share no term)."""

    def logprob_and_grad(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            logp = lml_fn(q) + log_prior(q)
            (grad,) = torch.autograd.grad(logp.sum(), q)
        return logp.detach(), grad

    return logprob_and_grad


def _chain_mean(x, psum_axis):
    """Mean over the chains; with psum_axis, over every rank's chains."""
    return torch.mean(_all_chains(x, psum_axis), dim=0)


def warmup_adapt(state0, rng, kernel, num_warmup, eps0, target_accept,
                 psum_axis=None):
    """3-phase Stan-style warmup. Returns (state, eps, inv_mass).

    Phases (Stan-style windowing), drawing from rng in turn (the JAX
    package takes a key per phase):
      I   (25% of warmup): dual-averaging eps under identity mass
      II  (50%): eps continues; position moments accumulated for the mass
      III (25%): mass fixed from phase II; eps re-adapted under the new
          metric
    kernel(state, rng, eps, inv_mass) -> (state, accept_probs (C,), aux).
    """
    n_chains, dim = state0.q.shape
    dev = state0.q.device
    draws = as_draws(rng, dev)

    def warmup_phase(state, da, steps, inv_mass, collect):
        mom = moments_init(dim, dev)
        for _ in range(steps):
            eps = torch.exp(da.log_eps)
            state, aprobs, _ = kernel(state, draws, eps, inv_mass)
            da = da_update(da, _chain_mean(aprobs, psum_axis),
                           target=target_accept)
            if collect:
                mom = moments_update(mom, state.q, psum_axis)
        return state, da, mom

    w1 = max(num_warmup // 4, 1)
    w3 = max(num_warmup // 4, 1)
    w2 = max(num_warmup - w1 - w3, 1)
    ones = torch.ones(dim, device=dev)

    state, da, _ = warmup_phase(state0, da_init(eps0, dev), w1, ones, False)
    state, da, mom = warmup_phase(state, da, w2, ones, True)
    inv_mass = moments_variance(mom)
    # re-init dual averaging around the current step size, new metric
    eps_mid = torch.exp(da.log_eps_avg)
    state, da, _ = warmup_phase(state, da_init(eps_mid), w3, inv_mass, False)
    return state, torch.exp(da.log_eps_avg), inv_mass


def retune_eps(state, rng, kernel, eps0, inv_mass, num_steps=16,
               target_accept=0.8, psum_axis=None):
    """Cheap eps-only re-tune under a carried mass matrix: num_steps
    dual-averaging transitions re-center eps for the chains' positions
    while keeping inv_mass. Returns (state, eps)."""
    draws = as_draws(rng, state.q.device)
    da = da_init(eps0, state.q.device)
    for _ in range(num_steps):
        eps = torch.exp(da.log_eps)
        state, aprobs, _ = kernel(state, draws, eps, inv_mass)
        da = da_update(da, _chain_mean(aprobs, psum_axis),
                       target=target_accept)
    return state, torch.exp(da.log_eps_avg)


def _stack(items):
    if isinstance(items[0], tuple):
        return tuple(torch.stack(z) for z in zip(*items))
    return torch.stack(items)


def sample_segment(state, rng, kernel, eps, inv_mass, num_draws):
    """num_draws post-warmup transitions at fixed eps and inv_mass;
    returns (state, qs (S, C, D), aprobs (S, C), aux stacked over S).
    Segments compose: two of K draws from one rng are one of 2K."""
    draws = as_draws(rng, state.q.device)
    qs, aprobs, aux = [], [], []
    for _ in range(num_draws):
        state, a, x = kernel(state, draws, eps, inv_mass)
        qs.append(state.q)
        aprobs.append(a)
        aux.append(x)
    return state, torch.stack(qs), torch.stack(aprobs), _stack(aux)


def adaptive_run(state0, rng, kernel, num_warmup, num_samples, eps0,
                 target_accept, psum_axis=None):
    """Shared 3-phase adaptive driver for batched-chain HMC/NUTS:
    warmup_adapt, then sample_segment, drawing from rng in turn."""
    draws = as_draws(rng, state0.q.device)
    state, eps, inv_mass = warmup_adapt(state0, draws, kernel, num_warmup,
                                        eps0, target_accept, psum_axis)
    state, qs, aprobs, aux = sample_segment(state, draws, kernel, eps,
                                            inv_mass, num_samples)
    return {
        "samples_flat": qs,  # (num_samples, n_chains, dim)
        "accept_rate": torch.mean(aprobs),
        "eps": eps,
        "inv_mass": inv_mass,
        "aux": aux,
        "final_state": state,
    }


STEP_JITTER = 0.8  # eps of a chain's transition: U((1 - j) eps, (1 + j) eps)


def make_hmc_kernel(logprob_and_grad, n_leapfrog=32, chain_block=0,
                    step_jitter=STEP_JITTER):
    """Batched-chain HMC transition kernel for adaptive_run /
    sample_segment: kernel(state, rng, eps, inv_mass) -> (state,
    accept_probs, accept_probs). Each transition first draws (C,)
    uniforms u and runs chain c at eps (1 + step_jitter (2 u_c - 1));
    step_jitter 0 draws no u and is the JAX package's kernel.
    chain_block > 0: every evaluation blocked (blocked_chains)."""
    logprob_and_grad = blocked_chains(logprob_and_grad, chain_block)

    def kernel(state, rng, eps, inv_mass):
        draws = as_draws(rng, state.q.device)
        if step_jitter:
            u = draws.uniform(state.logp.shape, state.q.device)
            eps = eps * (1.0 + step_jitter * (2.0 * u - 1.0))[:, None]
        state, aprobs = hmc_kernel(state, draws, eps, inv_mass,
                                   logprob_and_grad, n_leapfrog)
        return state, aprobs, aprobs

    return kernel


def init_state(q0, logprob_and_grad):
    """HMCState at q0 (C, D): one evaluation of every chain."""
    logp0, grad0 = logprob_and_grad(q0)
    return HMCState(q0, logp0, grad0)


def run_hmc(q0, rng, logprob_and_grad, n_leapfrog=32, num_warmup=256,
            num_samples=512, eps0=0.1, target_accept=0.8, psum_axis=None,
            chain_block=0):
    """Batched-chain HMC with shared step-size/mass adaptation.

    q0: (n_chains, dim) initial positions; rng: a torch.Generator or
    Draws. Returns dict with samples_flat (num_samples, n_chains, dim),
    accept_rate, eps, inv_mass. psum_axis: see the module docstring.
    chain_block: see blocked_chains (the initial evaluation too).
    """
    logprob_and_grad = blocked_chains(logprob_and_grad, chain_block)
    kernel = make_hmc_kernel(logprob_and_grad, n_leapfrog)
    out = adaptive_run(init_state(q0, logprob_and_grad), rng, kernel,
                       num_warmup, num_samples, eps0, target_accept,
                       psum_axis)
    out.pop("aux")
    out.pop("final_state")
    return out
