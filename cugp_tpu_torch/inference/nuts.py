"""No-U-Turn Sampler (iterative, multinomial), as
``cugp_tpu/inference/nuts.py``.

The recursive tree of the original algorithm is replaced by a loop over
leaves with an O(max_depth) checkpoint stack for the U-turn checks:
leaves are visited left to right within each doubling, and each even
leaf's state is written into stack slot ctz(leaf index), so the start of
every balanced span is still there when its last leaf arrives.

Chains run in lockstep, as the JAX kernel does under vmap: every tensor
has the chains in its leading dimension, each chain carries its own
masks (turning, diverging, depth), and a chain whose tree has ended is
frozen while the others go on. The leaves of one doubling are the same
number for every chain still building (they all doubled the same number
of times), so a doubling is one Python loop over its leaves, each leaf
one evaluation of every chain's log density. The tree ends for the
batch when every chain's tree has ended: one host read a doubling.

Draws (hmc.Draws): the (C, D) standard-normal momentum; then for each
doubling the (C,) direction uniforms, one (C,) uniform a leaf (the
progressive multinomial within the subtree), and the (C,) merge
uniforms, in that order (the JAX kernel's momentum key, then for each
doubling its direction key, its subtree key split once a leaf, and its
merge key).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cugp_tpu_torch.inference import hmc as hmc_lib


def _ctz(i):
    """Count trailing zeros of a positive int."""
    return (i & -i).bit_length() - 1


def _slot(i, max_depth):
    return max_depth if i == 0 else _ctz(i)


def _uturn(q_minus, p_minus, q_plus, p_plus, inv_mass):
    dq = q_plus - q_minus
    return ((torch.sum(dq * (inv_mass * p_minus), dim=-1) < 0.0)
            | (torch.sum(dq * (inv_mass * p_plus), dim=-1) < 0.0))


def _leapfrog_one(q, p, grad, eps, inv_mass, logprob_and_grad):
    """One leapfrog step of every chain; eps (C,) carries each chain's
    direction."""
    e = eps[:, None]
    p = p + 0.5 * e * grad
    q = q + e * inv_mass * p
    logp, grad = logprob_and_grad(q)
    p = p + 0.5 * e * grad
    return q, p, grad, logp


def _where(mask, new, old):
    """new where mask (C,) else old, for every field of two NamedTuples."""
    return type(old)(*(torch.where(mask.view((-1,) + (1,) * (o.ndim - 1)),
                                   n, o) for n, o in zip(new, old)))


class _TreeState(NamedTuple):
    # current integration endpoint (the "running leaf")
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    logp: torch.Tensor
    # progressive-multinomial proposal for the new subtree
    prop_q: torch.Tensor
    prop_logp: torch.Tensor
    prop_grad: torch.Tensor
    log_weight: torch.Tensor      # logsumexp of -energy over subtree leaves
    # U-turn checkpoint stack: (C, max_depth + 1, dim) starts of open spans
    ckpt_q: torch.Tensor
    ckpt_p: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor      # sum of per-leaf accept probs (for DA)
    n_leaves: torch.Tensor


def _build_subtree(depth, z, draws, eps, direction, inv_mass, h0, *,
                   logprob_and_grad, max_depth):
    """Integrate 2^depth leaves in each chain's direction (C,), with the
    progressive multinomial; depth is the same for every chain.

    z: (q, p, grad, logp) starting endpoints (already tree endpoints; the
    first new leaf is one leapfrog step away). Returns a _TreeState.
    """
    q0, p0, grad0, logp0 = z
    n_chains, dim = q0.shape
    dev = q0.device
    flags = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    st = _TreeState(
        q=q0, p=p0, grad=grad0, logp=logp0,
        prop_q=q0, prop_logp=logp0, prop_grad=grad0,
        log_weight=torch.full((n_chains,), -torch.inf, device=dev),
        ckpt_q=torch.zeros((n_chains, max_depth + 1, dim), device=dev),
        ckpt_p=torch.zeros((n_chains, max_depth + 1, dim), device=dev),
        turning=flags, diverging=flags,
        sum_accept=torch.zeros(n_chains, device=dev),
        n_leaves=torch.zeros(n_chains, dtype=torch.int32, device=dev),
    )
    step = direction * eps
    for i in range(1 << depth):
        u_sel = draws.uniform((n_chains,), dev)
        q, p, grad, logp = _leapfrog_one(st.q, st.p, st.grad, step,
                                         inv_mass, logprob_and_grad)
        energy = -logp + 0.5 * torch.sum(p * p * inv_mass, dim=-1)
        log_w = -energy
        log_w = torch.where(torch.isfinite(log_w), log_w, -torch.inf)
        diverging = (energy - h0) > 1000.0
        # per-leaf accept prob (Stan's averaged Metropolis statistic)
        accept = torch.clamp(torch.exp(h0 - energy), max=1.0)
        accept = torch.where(torch.isfinite(energy), accept, 0.0)

        # progressive multinomial within the subtree
        new_total = torch.logaddexp(st.log_weight, log_w)
        take = torch.log(u_sel) < (log_w - new_total)
        t1 = take[:, None]
        prop_q = torch.where(t1, q, st.prop_q)
        prop_logp = torch.where(take, logp, st.prop_logp)
        prop_grad = torch.where(t1, grad, st.prop_grad)

        # checkpoint stack: even leaves at slot ctz(i)
        ckpt_q, ckpt_p = st.ckpt_q, st.ckpt_p
        if i % 2 == 0:
            slot = _slot(i, max_depth)
            ckpt_q, ckpt_p = ckpt_q.clone(), ckpt_p.clone()
            ckpt_q[:, slot] = q
            ckpt_p[:, slot] = p

        # U-turn checks for every balanced span ending at leaf i: spans of
        # size 2^m for m = 1..(trailing ones of i)
        turning = st.turning
        for m in range(1, max_depth + 1):
            span = 1 << m
            if (i + 1) % span:
                continue
            s = _slot(i + 1 - span, max_depth)
            qs, ps = ckpt_q[:, s], ckpt_p[:, s]
            # orientation: in direction -1 the later leaf is the minus end
            t = torch.where(direction > 0,
                            _uturn(qs, ps, q, p, inv_mass),
                            _uturn(q, p, qs, ps, inv_mass))
            turning = turning | t

        new_st = _TreeState(
            q=q, p=p, grad=grad, logp=logp,
            prop_q=prop_q, prop_logp=prop_logp, prop_grad=prop_grad,
            log_weight=new_total, ckpt_q=ckpt_q, ckpt_p=ckpt_p,
            turning=turning, diverging=st.diverging | diverging,
            sum_accept=st.sum_accept + accept, n_leaves=st.n_leaves + 1,
        )
        # freeze a chain's state once it turns or diverges (its later
        # leaves are lockstep work, as under the JAX kernel's vmap)
        st = _where(~(st.turning | st.diverging), new_st, st)
    return st


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    depth: torch.Tensor
    n_leapfrog: torch.Tensor


class _Carry(NamedTuple):
    q_minus: torch.Tensor
    p_minus: torch.Tensor
    grad_minus: torch.Tensor
    logp_minus: torch.Tensor
    q_plus: torch.Tensor
    p_plus: torch.Tensor
    grad_plus: torch.Tensor
    logp_plus: torch.Tensor
    prop_q: torch.Tensor
    prop_logp: torch.Tensor
    prop_grad: torch.Tensor
    log_weight: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leapfrog: torch.Tensor


def nuts_kernel(state, rng, eps, inv_mass, logprob_and_grad, max_depth=8):
    """One NUTS transition of every chain (state: hmc.HMCState with the
    chains leading). Returns (hmc.HMCState, NUTSInfo)."""
    n_chains, dim = state.q.shape
    dev = state.q.device
    draws = hmc_lib.as_draws(rng, dev)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    p0 = draws.normal((n_chains, dim), dev) / torch.sqrt(inv_mass)
    h0 = -state.logp + 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    flags = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    zeros_i = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    c = _Carry(
        q_minus=state.q, p_minus=p0, grad_minus=state.grad,
        logp_minus=state.logp,
        q_plus=state.q, p_plus=p0, grad_plus=state.grad,
        logp_plus=state.logp,
        prop_q=state.q, prop_logp=state.logp, prop_grad=state.grad,
        log_weight=-h0, depth=zeros_i, turning=flags, diverging=flags,
        sum_accept=torch.zeros(n_chains, device=dev), n_leapfrog=zeros_i,
    )
    for depth in range(max_depth):
        active = ~c.turning & ~c.diverging  # depth < max_depth here
        if not bool(active.any()):  # the doubling's host read
            break
        go_right = draws.uniform((n_chains,), dev) < 0.5
        direction = torch.where(go_right, 1.0, -1.0)
        g1 = go_right[:, None]
        z = (torch.where(g1, c.q_plus, c.q_minus),
             torch.where(g1, c.p_plus, c.p_minus),
             torch.where(g1, c.grad_plus, c.grad_minus),
             torch.where(go_right, c.logp_plus, c.logp_minus))
        st = _build_subtree(depth, z, draws, eps, direction, inv_mass, h0,
                            logprob_and_grad=logprob_and_grad,
                            max_depth=max_depth)

        # biased progressive sampling between old tree and new subtree
        accept_new = (torch.log(draws.uniform((n_chains,), dev))
                      < (st.log_weight - c.log_weight))
        usable = ~(st.turning | st.diverging)
        take = (accept_new & usable)[:, None]
        prop_q = torch.where(take, st.prop_q, c.prop_q)
        prop_logp = torch.where(take[:, 0], st.prop_logp, c.prop_logp)
        prop_grad = torch.where(take, st.prop_grad, c.prop_grad)
        log_weight = torch.logaddexp(
            c.log_weight, torch.where(usable, st.log_weight, -torch.inf))

        q_minus = torch.where(g1, c.q_minus, st.q)
        p_minus = torch.where(g1, c.p_minus, st.p)
        grad_minus = torch.where(g1, c.grad_minus, st.grad)
        logp_minus = torch.where(go_right, c.logp_minus, st.logp)
        q_plus = torch.where(g1, st.q, c.q_plus)
        p_plus = torch.where(g1, st.p, c.p_plus)
        grad_plus = torch.where(g1, st.grad, c.grad_plus)
        logp_plus = torch.where(go_right, st.logp, c.logp_plus)

        # whole-tree U-turn check after the doubling
        turning_tree = _uturn(q_minus, p_minus, q_plus, p_plus, inv_mass)

        new = _Carry(
            q_minus=q_minus, p_minus=p_minus, grad_minus=grad_minus,
            logp_minus=logp_minus,
            q_plus=q_plus, p_plus=p_plus, grad_plus=grad_plus,
            logp_plus=logp_plus,
            prop_q=prop_q, prop_logp=prop_logp, prop_grad=prop_grad,
            log_weight=log_weight, depth=c.depth + 1,
            turning=st.turning | turning_tree, diverging=st.diverging,
            sum_accept=c.sum_accept + st.sum_accept,
            n_leapfrog=c.n_leapfrog + st.n_leaves,
        )
        c = _where(active, new, c)

    new_state = hmc_lib.HMCState(q=c.prop_q, logp=c.prop_logp,
                                 grad=c.prop_grad)
    accept_prob = c.sum_accept / torch.clamp(
        c.n_leapfrog.to(torch.float32), min=1.0)
    info = NUTSInfo(accept_prob=accept_prob, diverging=c.diverging,
                    depth=c.depth, n_leapfrog=c.n_leapfrog)
    return new_state, info


def make_nuts_kernel(logprob_and_grad, max_depth=8, chain_block=0):
    """Batched-chain NUTS transition kernel for hmc.adaptive_run /
    sample_segment: kernel(state, rng, eps, inv_mass) -> (state,
    accept_probs, (diverging, n_leapfrog)). chain_block > 0: every
    evaluation of the lockstep tree build is blocked
    (hmc.blocked_chains); each chain's tree and draws are those of the
    unblocked kernel."""
    logprob_and_grad = hmc_lib.blocked_chains(logprob_and_grad, chain_block)

    def kernel(state, rng, eps, inv_mass):
        state, info = nuts_kernel(state, rng, eps, inv_mass,
                                  logprob_and_grad, max_depth)
        return state, info.accept_prob, (info.diverging, info.n_leapfrog)

    return kernel


def run_nuts(q0, rng, logprob_and_grad, max_depth=8, num_warmup=256,
             num_samples=512, eps0=0.1, target_accept=0.8, psum_axis=None,
             chain_block=0):
    """Batched-chain NUTS with the shared 3-phase adaptive driver;
    psum_axis and chain_block as hmc.run_hmc's."""
    logprob_and_grad = hmc_lib.blocked_chains(logprob_and_grad, chain_block)
    kernel = make_nuts_kernel(logprob_and_grad, max_depth)
    out = hmc_lib.adaptive_run(hmc_lib.init_state(q0, logprob_and_grad),
                               rng, kernel, num_warmup, num_samples, eps0,
                               target_accept, psum_axis)
    divs, nlf = out.pop("aux")
    out.pop("final_state")
    out["divergence_rate"] = torch.mean(divs.to(torch.float32))
    out["mean_leapfrog"] = torch.mean(nlf.to(torch.float32))
    return out
