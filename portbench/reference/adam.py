"""Adam (Kingma and Ba 2015, as torch.optim.Adam states it) over the
log-hyperparameters in float64, each iterate clamped into the box the
configuration states."""

from __future__ import annotations

import torch


def follow(p0, loss_and_grad, steps, lr, bounds, b1=0.9, b2=0.999,
           eps=1e-8):
    """Minimize from p0 (dict of float64 tensors). loss_and_grad(p) ->
    (loss, dict of gradients of the loss). Returns ([the loss at each
    step's pre-update point], the first gradient, the params after
    `steps` updates)."""
    p = {k: v.clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        loss, g = loss_and_grad(p)
        losses.append(loss)
        if first is None:
            first = g
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            denom = torch.sqrt(v2[k]) / (1 - b2 ** t) ** 0.5 + eps
            p[k] = p[k] - lr / (1 - b1 ** t) * m[k] / denom
            lo, hi = bounds[k]
            p[k] = torch.clamp(p[k], lo, hi)
    return losses, first, p
