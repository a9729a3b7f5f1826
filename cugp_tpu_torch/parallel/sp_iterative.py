"""Distributed matrix-free inference, as
``cugp_tpu/parallel/sp_iterative.py``: the ring matvec, sharded CG and
SLQ, the sharded AD gradient sweep, and the training and sampling loops
on top of them.

X, y and every CG vector are row-sharded over a mesh axis; the kernel
matvec rotates the shards around the ring (``collectives``' ring shift,
JAX's ``ppermute``), each step building one (n_loc, n_loc) block through
the covariance tile kernel (``kernels.cross_covariance``, every family
and composite, as ring.py) and contracting it at once with
``torch.matmul``; K never exists whole on any rank. CG's and Lanczos'
inner products are all_reduce-d: the port's own CG, Lanczos and SLQ
(``inference/iterative.py``) run with ``ring_reduce``, a RowReduce whose
every partial sum is all-reduced. Per-rank memory is O(n_loc^2) for the
block plus O(n_loc (d + r)).

Every function takes this rank's rows (X_loc, y_loc, the right-hand
sides) and returns its rows of row-sharded results; scalars and
posterior moments are the same on every rank. As in ring.py the ring
carries raw rows of X, scaled on receipt, so the hyperparameters'
gradient is local plus one all_reduce (``hutchinson_grads_sharded``).

Divergence from the JAX package: it builds the pivoted-Cholesky
preconditioner on the host (``precond_factors_host``, a tunnel-era
layout the port leaves out); ``precond_factors_sharded`` builds it with
the port's device ``iterative.precond_factors`` on the gathered X, and
each rank keeps its rows of Lk. Probes are global (n, p) tensors each
rank slices (drawn on a CPU generator when not given, the same bits on
every rank and device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cugp_tpu_torch.inference import hmc as hmc_lib
from cugp_tpu_torch.inference import iterative
from cugp_tpu_torch.inference.map_opt import _clamp
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.parallel import collectives
from cugp_tpu_torch.utils.params import ravel_pytree, tree_leaves, tree_map


def ring_reduce(g):
    """iterative.RowReduce for rows sharded over g: each per-column
    partial sum all-reduced (one all_reduce per dot or norm)."""
    def dot(a, b):
        return collectives.all_reduce(iterative._sum_rows(a * b), g)

    def norm(x):
        return torch.sqrt(dot(x, x))

    return iterative.RowReduce(dot, norm)


def _rows(A, g):
    """This rank's rows of a global array sharded over g."""
    n = A.shape[0]
    if n % g.size:
        raise ValueError(f"{n} rows are not divisible by the ring of "
                         f"{g.size}")
    w = n // g.size
    return A[g.index * w:(g.index + 1) * w]


def _diag_add(params, jitter):
    return (torch.exp(params["log_noise_var"])
            + jitter * kernel_ops.signal_scale(params))


def _make_ring_matvec(params, X_loc, kind, jitter, g):
    """v_loc (n_loc,) or (n_loc, r) -> ((K + diag I) v)_loc: R ring steps,
    X and v moving together; with a gradient asked for, each step under
    torch.utils.checkpoint, so the backward rebuilds its block instead of
    keeping R of them (jax.checkpoint's rematerialization)."""
    diag_add = _diag_add(params, jitter)

    def block_mv(x_rot, v_rot):
        return kernel_ops.cross_covariance(params, X_loc, x_rot,
                                           kind=kind) @ v_rot

    def matvec(v_loc):
        vec = v_loc.ndim == 1
        v2 = v_loc[:, None] if vec else v_loc
        grad = torch.is_grad_enabled() and iterative._requires_grad(params)
        u, x_rot, v_rot = None, X_loc, v2
        for s in range(g.size):
            part = (checkpoint(block_mv, x_rot, v_rot, use_reentrant=False)
                    if grad else block_mv(x_rot, v_rot))
            u = part if u is None else u + part
            if s + 1 < g.size:
                x_rot, v_rot = collectives.ring_shift_many(
                    [x_rot.detach(), v_rot.detach()], g)
        out = u + diag_add * v2
        return out[:, 0] if vec else out

    return matvec


def _woodbury_apply_sharded(Lk_loc, Lg, s2, g):
    """The pivoted-Cholesky preconditioner apply with Lk row-sharded like
    every CG vector: Lk^T r is one all_reduce of local partial products,
    the k x k solves (the TRSM kernel) are replicated, Lk t is local."""

    def apply_p(r_loc):
        t = collectives.all_reduce(Lk_loc.mT @ r_loc, g)
        t = trsm_ops.cho_solve(Lg, t)
        return (r_loc - Lk_loc @ t) / s2

    return apply_p


@torch.no_grad()
def precond_factors_sharded(params, X_loc, mesh, rank, kind="rbf",
                            jitter=1e-6, axis="r"):
    """(Lk_loc, Lg, s2): iterative.precond_factors on the all-gathered X
    (the same factors on every rank), Lk cut to this rank's rows."""
    g = mesh.group(axis)
    X = collectives.all_gather(X_loc, g)
    Lk, Lg, s2 = iterative.precond_factors(params, X, rank, kind=kind,
                                           jitter=jitter)
    return _rows(Lk, g), Lg, s2


def _apply_m(precond, g):
    return None if precond is None else _woodbury_apply_sharded(*precond, g)


def ring_matvec(params, X_loc, v_loc, mesh, kind="rbf", jitter=1e-6,
                axis="r"):
    """This rank's rows of (K(X,X) + (noise + jitter sf2) I) v over the
    ring of `axis`; X_loc (n_loc, d), v_loc (n_loc,) or (n_loc, r)."""
    kernel_ops.validate_kind(kind)
    mv = _make_ring_matvec(params, X_loc, kind, jitter, mesh.group(axis))
    return mv(v_loc.to(torch.float32))


@torch.no_grad()
def cg_solve_sharded(params, X_loc, b_loc, mesh, kind="rbf", jitter=1e-6,
                     axis="r", tol=1e-6, max_iters=500, precond=None):
    """Distributed CG solve of (K + noise I) x = b; K never formed.

    precond: optional (Lk_loc, Lg, s2) (precond_factors_sharded), one
    all_reduce an apply. Returns (this rank's rows of x, iterations)."""
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    mv = _make_ring_matvec(params, X_loc, kind, jitter, g)
    return iterative.cg_solve(mv, b_loc.to(torch.float32), tol=tol,
                              max_iters=max_iters,
                              precond_apply=_apply_m(precond, g),
                              reduce=ring_reduce(g))


@torch.no_grad()
def posterior_iterative_sharded(params, X_loc, y_loc, Xs, mesh, kind="rbf",
                                jitter=1e-6, axis="r", tol=1e-6,
                                max_iters=500, include_noise=False,
                                precond=None):
    """Matrix-free posterior mean and diagonal variance over the ring.

    Xs (m, d) is replicated (test points are few). mean = sum over ranks
    of K(Xs, X_j) alpha_j with alpha from distributed CG; variance via
    the batched distributed solve on the cross-covariance columns.
    Returns (mu, var), the same on every rank."""
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    mv = _make_ring_matvec(params, X_loc, kind, jitter, g)
    kw = dict(tol=tol, max_iters=max_iters,
              precond_apply=_apply_m(precond, g), reduce=ring_reduce(g))
    alpha, _ = iterative.cg_solve(mv, y_loc.to(torch.float32), **kw)
    ks_loc = kernel_ops.cross_covariance(params, X_loc, Xs, kind=kind)
    mu = collectives.all_reduce(ks_loc.mT @ alpha, g)
    w, _ = iterative.cg_solve(mv, ks_loc, **kw)
    qvar = collectives.all_reduce(torch.sum(ks_loc * w, dim=0), g)
    var = kernel_ops.kernel_diag(params, Xs, kind) - qvar
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    return mu, torch.clamp(var, min=0.0)


@torch.no_grad()
def _lml_parts_sharded(params, X_loc, y_loc, z_loc, mesh, kind="rbf",
                       jitter=1e-6, axis="r", tol=1e-5, max_iters=500,
                       num_steps=32, precond=None):
    """The matrix-free LML over the ring and the solves its gradient
    needs: one batched distributed CG for [y | z] (each ring block built
    once an iteration for rhs and probes together) and SLQ on the same
    probes with all-reduced inner products. Returns (value, alpha_loc,
    w_loc, CG iterations)."""
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    red = ring_reduce(g)
    n = y_loc.shape[0] * g.size
    mv = _make_ring_matvec(params, X_loc, kind, jitter, g)
    B = torch.cat([y_loc[:, None], z_loc], dim=1)
    sol, it = iterative.cg_solve(mv, B, tol=tol, max_iters=max_iters,
                                 precond_apply=_apply_m(precond, g),
                                 reduce=red)
    alpha, w = sol[:, 0], sol[:, 1:]
    quad = red.dot(y_loc[:, None], alpha[:, None])[0]
    logdet = iterative.slq_logdet(mv, n, Z=z_loc, num_steps=num_steps,
                                  reduce=red)
    value = -0.5 * quad - 0.5 * logdet - 0.5 * n * iterative.LOG2PI
    return value, alpha, w, it


def _probes_loc(n, num_probes, Z, generator, g, device):
    """This rank's rows of the global (n, num_probes) Rademacher probes:
    Z as given, else drawn from generator (a CPU generator seeded 0 when
    none), the same global probes on every rank."""
    if Z is None:
        Z = iterative.rademacher(n, num_probes, device, generator)
    return _rows(torch.as_tensor(Z, dtype=torch.float32, device=device), g)


def lml_iterative_sharded(params, X_loc, y_loc, mesh, Z=None, kind="rbf",
                          jitter=1e-6, axis="r", tol=1e-5, max_iters=500,
                          num_probes=16, num_steps=32, precond=None,
                          generator=None):
    """Matrix-free LML over the ring: distributed CG for the quadratic
    term, SLQ with all-reduced inner products for the logdet. Z: the
    global (n, num_probes) probes (drawn from generator when not given).
    """
    g = mesh.group(axis)
    z_loc = _probes_loc(y_loc.shape[0] * g.size, num_probes, Z, generator,
                        g, X_loc.device)
    value, _alpha, _w, _it = _lml_parts_sharded(
        params, X_loc, y_loc, z_loc, mesh, kind=kind, jitter=jitter,
        axis=axis, tol=tol, max_iters=max_iters, num_steps=num_steps,
        precond=precond)
    return value


def hutchinson_grads_sharded(params, X_loc, alpha_loc, w_loc, z_loc, mesh,
                             kind="rbf", jitter=1e-6, axis="r"):
    """The gradient sweep given the solves: one reverse pass of
    g(p) = 1/2 (alpha^T K(p) alpha - mean_z w^T K(p) z) with alpha, w, z
    held constant, through the ring matvec (each step rematerialized):
    each rank differentiates its rows' share, and one all_reduce sums the
    ranks' gradients. The estimator of iterative.hutchinson_grads_program
    on the ring; every kernel family and composite."""
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    a2 = alpha_loc.detach().reshape(-1, 1).to(torch.float32)
    w_loc, z_loc = w_loc.detach(), z_loc.detach()
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        mv = _make_ring_matvec(p, X_loc, kind, jitter, g)
        U = mv(torch.cat([a2, z_loc], dim=1))
        est = 0.5 * (torch.sum(a2 * U[:, :1])
                     - torch.sum(w_loc * U[:, 1:]) / z_loc.shape[1])
        grads = torch.autograd.grad(est, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(leaves, grads)]
    flat = collectives.all_reduce(torch.cat([gr.reshape(-1) for gr in grads]),
                                  g)
    it = iter(torch.split(flat, [t.numel() for t in leaves]))
    return tree_map(lambda t: next(it).reshape(t.shape), params)


def fit_iterative_sharded(init_params, X_loc, y_loc, mesh, *, kind="rbf",
                          jitter=1e-6, axis="r", steps=50,
                          learning_rate=0.05, tol=1e-4, max_iters=400,
                          num_probes=16, precond_rank=128,
                          precond_refresh="auto", refresh_factor=1.5,
                          generator=None, log_prior=None, callback=None,
                          verbose=False):
    """Matrix-free MAP fit over the ring, the distributed twin of
    map_opt.fit_iterative's split path (no warm start).

    Per Adam step: one batched distributed CG for [y | z] (row-sharded
    Woodbury preconditioner), one sharded gradient sweep, Adam on the
    negated gradients (torch's Adam, as fit_iterative), the clamp.
    Probes: a fresh global (n, num_probes) draw a step from generator
    (a CPU generator seeded 0 when none: fit_iterative's stream), each
    rank keeping its rows. precond_refresh="auto" rebuilds the factors
    when a step's CG count exceeds refresh_factor x the best since the
    last build. Returns (params, info) shaped like fit_iterative's; every
    rank holds the same params."""
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    n = y_loc.shape[0] * g.size
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    adaptive = precond_refresh == "auto"
    if adaptive:
        precond_refresh = 10 ** 9
    params = tree_map(lambda t: t.detach().clone(), init_params)
    leaves = tree_leaves(params)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, cg_iters = [], []
    rebuilds, best_since, need_rebuild, precond = 0, float("inf"), False, None
    for step in range(steps):
        if precond_rank and (precond is None or need_rebuild
                             or (not adaptive and step > 0
                                 and step % precond_refresh == 0)):
            precond = precond_factors_sharded(params, X_loc, mesh,
                                              precond_rank, kind=kind,
                                              jitter=jitter, axis=axis)
            rebuilds += 1
            best_since, need_rebuild = float("inf"), False
        z_loc = _probes_loc(n, num_probes, None, generator, g, X_loc.device)
        B = torch.cat([y_loc[:, None], z_loc], dim=1)
        sol, it = cg_solve_sharded(params, X_loc, B, mesh, kind=kind,
                                   jitter=jitter, axis=axis, tol=tol,
                                   max_iters=max_iters, precond=precond)
        cg_iters.append(it)
        if adaptive and precond_rank:
            if it > refresh_factor * best_since:
                need_rebuild = True
            best_since = min(best_since, it)
        alpha, w = sol[:, 0], sol[:, 1:]
        grads = hutchinson_grads_sharded(params, X_loc, alpha, w, z_loc,
                                         mesh, kind=kind, jitter=jitter,
                                         axis=axis)
        value = -0.5 * ring_reduce(g).dot(y_loc[:, None], alpha[:, None])[0]
        if log_prior is not None:
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            with torch.enable_grad():
                pv = log_prior(p)
                pg = torch.autograd.grad(pv, tree_leaves(p))
            value = value + pv.detach()
            it_pg = iter(pg)
            grads = tree_map(lambda t: t + next(it_pg), grads)
        with torch.no_grad():
            for leaf, gr in zip(leaves, tree_leaves(grads)):
                leaf.grad = -gr
            opt.step()
            _clamp(params)
        losses.append(-float(value))
        if callback is not None:
            callback(step, params, float(value), grads)
        if verbose:
            print(f"# fit_iterative_sharded step {step}: "
                  f"quad-obj={-losses[-1]:.4f} cg_it={it}",
                  file=sys.stderr, flush=True)
    info = {"loss": torch.tensor(losses, dtype=torch.float32),
            "quad_obj": -losses[-1] if losses else float("nan"),
            "cg_iters": np.asarray(cg_iters, np.int32),
            "precond_rebuilds": rebuilds,
            "lml": float("nan")}
    return params, info


def make_sharded_logprob(init_params, X_loc, y_loc, mesh, *, kind="rbf",
                         jitter=1e-6, axis="r", tol=1e-5, max_iters=500,
                         num_probes=16, num_steps=32, Z=None, probe_rng=None,
                         precond=None, log_prior=hmc_lib.default_log_prior):
    """(logprob_and_grad, unravel, q0) over flat hyperparameter vectors
    with the sharded matrix-free LML: each density evaluation is itself
    distributed over the ring.

    Per evaluation of a chain: _lml_parts_sharded (batched [y | z]
    distributed CG and sharded SLQ) and hutchinson_grads_sharded. The
    probes are drawn ONCE and frozen (sampling.make_iterative_logprob's
    trade): Z global (n, num_probes), else from probe_rng, else a CPU
    generator seeded 7. Chains are replicated on every rank (D is tiny);
    q (C, D) is evaluated a chain at a time."""
    from cugp_tpu_torch.inference.sampling import DEFAULT_PROBE_SEED

    q0, unravel = ravel_pytree(init_params)
    g = mesh.group(axis)
    if Z is None and probe_rng is None:
        probe_rng = torch.Generator().manual_seed(DEFAULT_PROBE_SEED)
    z_loc = _probes_loc(y_loc.shape[0] * g.size, num_probes, Z, probe_rng,
                        g, X_loc.device)
    kw = dict(kind=kind, jitter=jitter, axis=axis)

    def one(qc):
        p = unravel(qc)
        value, alpha, w, _it = _lml_parts_sharded(
            p, X_loc, y_loc, z_loc, mesh, tol=tol, max_iters=max_iters,
            num_steps=num_steps, precond=precond, **kw)
        grads = hutchinson_grads_sharded(p, X_loc, alpha, w, z_loc, mesh,
                                         **kw)
        return value, ravel_pytree(grads)[0]

    def logprob_and_grad(q):
        q = q.detach()
        vals, grads = zip(*(one(qc) for qc in q))
        qg = q.clone().requires_grad_(True)
        with torch.enable_grad():
            prior = log_prior(qg)
            (pg,) = torch.autograd.grad(torch.sum(prior), qg)
        return torch.stack(vals) + prior.detach(), torch.stack(grads) + pg

    return logprob_and_grad, unravel, q0


def sample_hyperparams_sharded(init_params, X_loc, y_loc, mesh, *,
                               kind="rbf", jitter=1e-6, axis="r",
                               num_samples=256, num_chains=8,
                               num_warmup=128, sampler="hmc", rng=None,
                               n_leapfrog=16, max_tree_depth=8, eps0=0.05,
                               target_accept=0.8, tol=1e-5, max_iters=500,
                               num_probes=16, num_steps=32, precond_rank=0,
                               Z=None, probe_rng=None,
                               log_prior=hmc_lib.default_log_prior):
    """NUTS/HMC over kernel hyperparameters with the sharded matrix-free
    LML: every density evaluation a ring-distributed CG + SLQ and its
    gradient a sharded AD sweep; the contract of
    sampling.sample_hyperparams_iterative. rng: a torch.Generator or
    hmc.Draws, the same on every rank (the chains are replicated); None:
    a CPU generator seeded 0. precond_rank > 0: factors built once at
    init_params (precond_factors_sharded)."""
    from cugp_tpu_torch.inference import nuts as nuts_lib
    from cugp_tpu_torch.inference.sampling import init_chains

    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler: {sampler}")
    precond = (precond_factors_sharded(init_params, X_loc, mesh,
                                       precond_rank, kind=kind,
                                       jitter=jitter, axis=axis)
               if precond_rank else None)
    logprob_and_grad, unravel, q0 = make_sharded_logprob(
        init_params, X_loc, y_loc, mesh, kind=kind, jitter=jitter,
        axis=axis, tol=tol, max_iters=max_iters, num_probes=num_probes,
        num_steps=num_steps, Z=Z, probe_rng=probe_rng, precond=precond,
        log_prior=log_prior)
    draws = hmc_lib.as_draws(rng, X_loc.device)
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
