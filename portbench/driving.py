"""What the drivers share: the hyperparameter dicts they hand the
program and the reference, and the device's synchronisation."""

from __future__ import annotations

import math

import torch

NAMES = ("log_lengthscale", "log_signal_var", "log_noise_var")


def log_params(d, lengthscale, signal_var, noise_var, device,
               dtype=torch.float32):
    """The log-space hyperparameters, in the program's leaf order.
    lengthscale: a number or d numbers."""
    ell = torch.as_tensor(lengthscale, dtype=torch.float64).expand(d)
    return {"log_lengthscale": torch.log(ell).to(device=device, dtype=dtype),
            "log_signal_var": torch.tensor(math.log(signal_var), dtype=dtype,
                                           device=device),
            "log_noise_var": torch.tensor(math.log(noise_var), dtype=dtype,
                                          device=device)}


def to64(params):
    return {k: torch.as_tensor(v).detach().to(torch.float64)
            for k, v in params.items()}


def named(leaves):
    """The program's leaves (insertion order of the dict it was given)
    by name."""
    if len(leaves) != len(NAMES):
        raise ValueError(f"expected {len(NAMES)} hyperparameter leaves, "
                         f"got {len(leaves)}")
    return dict(zip(NAMES, leaves))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def bounds(cfg):
    return {k: tuple(v) for k, v in cfg["bounds"].items()}
