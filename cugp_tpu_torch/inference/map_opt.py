"""MAP hyperparameter optimization, as ``cugp_tpu/inference/map_opt.fit``.

The JAX package runs Adam as one jitted ``lax.scan``; here it is a Python
loop over ``torch.optim.Adam`` on leaf tensors (b1=0.9, b2=0.999,
eps=1e-8 outside the root: the same update as ``optax.adam``). As with
``optax.apply_if_finite``, a step whose gradient is not finite is skipped
and leaves the optimizer state untouched. Every iterate is clamped into
the box of ``_BOUNDS``.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.utils.params import tree_leaves, tree_map

_NOT_PORTED = "not ported yet; see ROADMAP.md, slice 1"


def _neg_lml(params, X, y, kind, jitter, method, basis=None,
             log_prior=None, objective="lml"):
    if objective != "lml":
        if objective == "loo":
            raise NotImplementedError(f"objective='loo' is {_NOT_PORTED}")
        raise ValueError(f"unknown objective {objective!r}: lml | loo")
    if basis is not None:
        raise NotImplementedError(f"basis={basis!r} is {_NOT_PORTED}")
    if log_prior is not None:
        raise NotImplementedError(f"log_prior is {_NOT_PORTED}")
    return -exact_gp.log_marginal_likelihood(
        params, X, y, kind=kind, jitter=jitter, method=method)


# Box constraints on log-hyperparameters: fp32 Cholesky fails (NaN) in the
# tiny-noise / huge-lengthscale corners; these keep every iterate
# factorizable (the same box as the JAX package).
_BOUNDS = {
    "log_lengthscale": (-6.0, 6.0),
    "log_signal_var": (-8.0, 8.0),
    "log_noise_var": (-9.0, 5.0),
    "log_alpha": (-4.0, 6.0),
    "log_period": (-6.0, 6.0),
    "log_bias_var": (-8.0, 8.0),
    "log_nu": (0.1, 6.0),
}


@torch.no_grad()
def _clamp(params):
    """Clip every bounded log-hyperparameter IN PLACE (Adam's leaf
    tensors), recursing through the terms/factors of composite kernels."""
    if isinstance(params, dict):
        for k, v in params.items():
            if k in _BOUNDS and isinstance(v, torch.Tensor):
                v.clamp_(*_BOUNDS[k])
            else:
                _clamp(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            _clamp(v)
    return params


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=200, optimizer="adam", learning_rate=0.05, basis=None,
        log_prior=None, objective="lml"):
    """Maximize the LML over log-hyperparameters with Adam.

    Returns (params, info): info["loss"] holds the negative LML at each
    step's pre-update params, info["lml"] = -loss[-1].
    """
    if optimizer == "lbfgs":
        raise NotImplementedError(f"optimizer='lbfgs' is {_NOT_PORTED}")
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer: {optimizer}")
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      init_params)
    leaves = tree_leaves(params)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = _neg_lml(params, X, y, kind, jitter, method, basis,
                        log_prior, objective)
        loss.backward()
        losses.append(loss.detach())
        finite = torch.stack([torch.isfinite(p.grad).all() for p in leaves
                              if p.grad is not None])
        if bool(finite.all()):  # one host sync per step
            opt.step()
        _clamp(params)
    loss_trace = torch.stack(losses)
    params = tree_map(lambda t: t.detach(), params)
    return params, {"loss": loss_trace, "lml": -loss_trace[-1]}
