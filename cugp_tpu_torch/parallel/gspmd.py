"""Sharded training steps, as ``cugp_tpu/parallel/gspmd.py``.

The JAX module leans on GSPMD: sharding constraints around the
covariance/Cholesky pipeline, with XLA inserting the collectives. Torch
has no counterpart, so the port keeps what XLA did with explicit
collectives (DTensor's linalg coverage would redistribute unseen):

  lml_sharded  only the covariance is sharded (each rank builds its 2D
               block through the covariance tile kernel); the blocks are
               all-gathered and the factor is replicated (``ops.cholesky``
               on every rank), as XLA could not partition the Cholesky;
  make_map_train_step  one Adam step on -LML over either backend:
               "chunked", distributed_chol.distributed_lml (the sharded
               factorization: K, its block-cyclic factor and the
               gradient's K^{-1} sharded, the gradient in closed form,
               2 n^3/3 for the inverse), or "gspmd", lml_sharded.

A step is the span ``cugp.step`` (utils.profiling, recorded only in a
profiler session); the chunked LML's factor and closed-form backward are
its children ``cugp.factorize`` and ``cugp.chol_backward``.

Layout: X and y rows over ('dp', 'r'), K blocks over (('dp', 'r'), 'c').
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.models.exact_gp import LOG2PI
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.parallel import collectives, distributed_chol
from cugp_tpu_torch.parallel.distributed_chol import ROWS
from cugp_tpu_torch.parallel.mesh import AXES, Sharding
from cugp_tpu_torch.utils import profiling
from cugp_tpu_torch.utils.params import tree_leaves, tree_map


def lml_sharded(params, X_loc, y_loc, mesh, kind="rbf", jitter=1e-6):
    """LML with the O(N^2) covariance sharded and the factor replicated;
    the same value on every rank, differentiable in params (every rank's
    backward() gives the full gradient)."""
    world = mesh.group(AXES)
    params = tree_map(lambda t: collectives.grad_sync(t, world), params)
    K_loc, _X = distributed_chol.covariance_2d(params, X_loc, mesh,
                                               kind=kind, jitter=jitter)
    K = Sharding(mesh, (ROWS, "c")).gather(K_loc)
    y = collectives.all_gather(y_loc.detach(), mesh.group(ROWS))
    L = chol_ops.cholesky(K)
    alpha = trsm_ops.cho_solve(L, y)
    n = y.shape[0]
    lml = (-0.5 * torch.sum(y * alpha)
           - torch.sum(torch.log(torch.diagonal(L))) - 0.5 * n * LOG2PI)
    return collectives.replicated_out(lml, world)


class OptState:
    """Adam's state for make_map_train_step: the trainable params (leaf
    tensors), torch's Adam over them and optax's apply_if_finite count
    (map_opt.FiniteGuard)."""

    def __init__(self, params, learning_rate, max_consecutive_errors):
        self.params = tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        self.opt = torch.optim.Adam(tree_leaves(self.params),
                                    lr=learning_rate, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.guard = map_opt.FiniteGuard(max_consecutive_errors)


class AdamIfFinite:
    """optax.apply_if_finite(optax.adam(learning_rate), 1000) for the
    sharded step: init(params) gives the OptState."""

    def __init__(self, learning_rate, max_consecutive_errors=1000):
        self.learning_rate = learning_rate
        self.max_consecutive_errors = max_consecutive_errors

    def init(self, params):
        return OptState(params, self.learning_rate,
                        self.max_consecutive_errors)


def make_map_train_step(mesh, kind="rbf", jitter=1e-6, learning_rate=0.05,
                        lml_backend="chunked", chunk=8192):
    """One sharded Adam step on the LML. Returns (step_fn, tx).

    ``state = tx.init(params)``, then ``params, state, loss = step_fn(
    state.params, state, X_loc, y_loc)``: Adam with optax's
    apply_if_finite count, then the box clamp (map_opt._clamp), as
    map_opt.fit; every rank ends with the same params. X_loc, y_loc:
    the rank's rows over ('dp', 'r').

    lml_backend: 'chunked' (distributed_chol.distributed_lml, the
    sharded factorization and its closed-form gradient; chunk: the
    largest block of its block-cyclic layout) or 'gspmd' (lml_sharded:
    sharded covariance, replicated factor).
    """
    if lml_backend == "chunked":
        def lml(p, X, y):
            return distributed_chol.distributed_lml(
                p, X, y, mesh, kind=kind, jitter=jitter, chunk=chunk)
    elif lml_backend == "gspmd":
        def lml(p, X, y):
            return lml_sharded(p, X, y, mesh, kind=kind, jitter=jitter)
    else:
        raise ValueError(f"unknown lml_backend: {lml_backend}")
    tx = AdamIfFinite(learning_rate, 1000)

    def step(params, opt_state, X_loc, y_loc):
        if params is not opt_state.params:
            raise ValueError("step takes opt_state.params (the tensors its "
                             "Adam updates)")
        leaves = tree_leaves(params)
        with profiling.span("cugp.step", X_loc.device, root=True):
            opt_state.opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = -lml(params, X_loc, y_loc)
                loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in leaves]
            for p, gr in zip(leaves, grads):
                p.grad = gr
            if opt_state.guard.apply(grads):
                opt_state.opt.step()
            map_opt._clamp(params)
        return params, opt_state, loss.detach()

    return step, tx
