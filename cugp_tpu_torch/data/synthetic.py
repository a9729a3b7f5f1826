"""Synthetic regression datasets, as ``cugp_tpu/data/synthetic.py``.

NumPy copies of the config-1 and config-2 generators: the same seed gives
the same arrays bit for bit as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def sinusoid_1d(n=1000, noise_std=0.1, seed=0, x_range=(-3.0, 3.0)):
    """Config-1 dataset: y = sin(3x) + 0.5 x + noise, X in x_range."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(x_range[0], x_range[1], size=(n, 1))
    X = np.sort(X, axis=0)
    f = np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 0]
    y = f + noise_std * rng.standard_normal(n)
    return X.astype(np.float64), y.astype(np.float64), f.astype(np.float64)


def multidim_regression(n=8000, d=4, noise_std=0.2, seed=0):
    """Config-2 dataset: smooth nonlinear function of d inputs + noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    w = rng.standard_normal(d) / np.sqrt(d)
    f = np.sin(X @ w * 2.0) + 0.3 * np.cos(1.5 * X[:, 0]) + 0.2 * (X**2 @ w)
    y = f + noise_std * rng.standard_normal(n)
    return X.astype(np.float64), y.astype(np.float64), f.astype(np.float64)
