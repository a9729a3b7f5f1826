"""Inputs: the configuration's data set with its probes, and what the
run's seed draws (the rows' order, the test points and the order of
the request sizes).

``matern32_draw`` is ``chip_smoke.py``'s ``rff_gp_draw`` (as of commit
ebb90cf), rewritten: the frequencies come from the Matern-3/2 spectral
density (a Student-t with 3 degrees of freedom, scaled by the
lengthscales) instead of the RBF's Gaussian, and every draw is made on
the device from a ``torch.Generator`` seeded with the run's seed, in a
few large calls. The (n, features) feature map is formed in row chunks
in float64, so memory stays bounded.
"""

from __future__ import annotations

import math

import torch

# inputs uniform on [-sqrt(3), sqrt(3)]: zero mean and unit variance per
# column, as standardized data
_HALF_WIDTH = math.sqrt(3.0)


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(int(seed))


def uniform_inputs(n, d, gen, device):
    u = torch.rand((n, d), generator=gen, device=device, dtype=torch.float64)
    return (2.0 * u - 1.0) * _HALF_WIDTH


def matern32_draw(n, d, lengthscales, signal_var, noise_var, gen, device,
                  features=4096, chunk=16384):
    """(X (n, d), y (n,)) float32 on `device`: X uniform and standardized,
    y = f + noise with f ~ GP(0, signal_var * matern32(lengthscales)) by
    random Fourier features."""
    X = uniform_inputs(n, d, gen, device)
    ell = torch.as_tensor(lengthscales, dtype=torch.float64,
                          device=device).expand(d)
    # multivariate t with 2 nu = 3 degrees of freedom: z / sqrt(u / 3)
    z = torch.randn((d, features), generator=gen, device=device,
                    dtype=torch.float64)
    u = torch.randn((3, features), generator=gen, device=device,
                    dtype=torch.float64).square().sum(0)
    W = z / ell[:, None] / torch.sqrt(u / 3.0)
    b = 2.0 * math.pi * torch.rand(features, generator=gen, device=device,
                                   dtype=torch.float64)
    w = torch.randn(features, generator=gen, device=device,
                    dtype=torch.float64)
    scale = math.sqrt(2.0 * signal_var / features)
    f = torch.cat([scale * torch.cos(X[lo:lo + chunk] @ W + b) @ w
                   for lo in range(0, n, chunk)])
    noise = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    y = f + math.sqrt(noise_var) * noise
    return X.to(torch.float32), y.to(torch.float32)


def dataset(cfg, seed, device, probes=0):
    """(X, y, Z, the run's generator): the configuration's data set, one
    draw from its ``data_seed`` (the same in every run, as a published
    data set is) with `probes` Rademacher probe columns Z (None for 0),
    its rows in an order drawn from the run's seed. Every seed so holds
    the same rows and probes in another order, and does the same work.
    The returned generator then draws the run's test points."""
    draw = cfg["draw"]
    data_gen = generator(device, cfg["data_seed"])
    X, y = matern32_draw(cfg["n_train"], cfg["d"], draw["lengthscale"],
                         draw["signal_var"], draw["noise_var"], data_gen,
                         device)
    Z = rademacher(cfg["n_train"], probes, data_gen, device) if probes \
        else None
    gen = generator(device, seed)
    order = torch.randperm(X.shape[0], generator=gen, device=device)
    return X[order], y[order], None if Z is None else Z[order], gen


def rademacher(n, p, gen, device):
    """(n, p) float32 probes of +-1."""
    bits = torch.randint(0, 2, (n, p), generator=gen, device=device)
    return (2 * bits - 1).to(torch.float32)


def size_cycle(lo, hi, count, gen):
    """`count` request sizes spread log-uniformly over [lo, hi] at fixed
    quantiles (the same set for every seed), in an order drawn from the
    generator."""
    logs = [math.log(lo) + (i + 0.5) / count * (math.log(hi) - math.log(lo))
            for i in range(count)]
    sizes = [int(round(math.exp(v))) for v in logs]
    sizes[-1] = hi  # the largest size is always served
    order = torch.randperm(count, generator=gen, device=gen.device).tolist()
    return [sizes[i] for i in order]
