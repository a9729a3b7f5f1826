"""Synthetic regression datasets, as ``cugp_tpu/data/synthetic.py``.

NumPy copies of the config-1 and config-2 generators, the known-GP draw,
the padding helper, and the count, outlier and classification datasets
of the sparse and classification models, and the multi-host row shard
(``host_shard``): the same seed gives the same arrays bit for bit as the
JAX package's.
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


def gp_draw(n=512, d=2, lengthscale=0.7, signal_var=1.5, noise_var=0.05,
            seed=0, kind="rbf"):
    """Data drawn from a GP with KNOWN hyperparameters (recovery tests);
    the covariance is the port's copy of the float64 oracle's."""
    from cugp_tpu_torch.oracle import exact_gp_np as oracle

    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    params = {
        "log_lengthscale": np.full((d,), np.log(lengthscale)),
        "log_signal_var": np.log(signal_var),
        "log_noise_var": np.log(noise_var),
    }
    K = oracle.kernel_matrix(params, X, X, kind) + 1e-10 * np.eye(n)
    Lf = np.linalg.cholesky(K)
    f = Lf @ rng.standard_normal(n)
    y = f + np.sqrt(noise_var) * rng.standard_normal(n)
    return X, y, params


def pad_dataset(X, y, n_padded):
    """Zero-pad (X, y) rows up to n_padded.

    Pass the TRUE row count to the model as ``n_true`` (e.g.
    ``exact_gp.log_marginal_likelihood(..., n_true=len(y_orig))``): the
    covariance builders then write an identity block beyond it, so the
    padded system's Cholesky, LML and posterior equal the unpadded ones.
    """
    n, d = X.shape
    if n_padded < n:
        raise ValueError(f"n_padded={n_padded} is below the {n} rows")
    Xp = np.zeros((n_padded, d), dtype=X.dtype)
    yp = np.zeros((n_padded,), dtype=y.dtype)
    Xp[:n] = X
    yp[:n] = y
    return Xp, yp


def poisson_counts(n=500, seed=0, x_range=(-3.0, 3.0)):
    """Count-regression dataset: log-rate f = sin(2x) + 0.5, y ~ Poisson(e^f).

    Returns (X (n,1) float32, y (n,) float32 counts, rate (n,) float64).
    """
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(x_range[0], x_range[1], size=(n, 1)), axis=0)
    rate = np.exp(np.sin(2.0 * X[:, 0]) + 0.5)
    y = rng.poisson(rate)
    return X.astype(np.float32), y.astype(np.float32), rate


def sinusoid_outliers(n=500, noise_std=0.1, outlier_frac=0.1,
                      outlier_scale=3.0, seed=0):
    """sinusoid_1d contaminated with heavy outliers, the robust
    (student_t) regression testbed. Returns (X, y, f) like sinusoid_1d."""
    X, y, f = sinusoid_1d(n=n, noise_std=noise_std, seed=seed)
    rng = np.random.default_rng(seed + 1)
    k = max(1, int(outlier_frac * n))
    idx = rng.choice(n, size=k, replace=False)
    y = y.copy()
    y[idx] += outlier_scale * rng.standard_normal(k)
    return X, y, f


def two_moons(n=200, noise_std=0.15, seed=0):
    """Binary classification dataset (two interleaved half-circles).

    Returns (X (n,2) float32, y (n,) float32 in {-1, +1}).
    """
    rng = np.random.default_rng(seed)
    n1 = n // 2
    n2 = n - n1
    t1 = rng.uniform(0.0, np.pi, n1)
    t2 = rng.uniform(0.0, np.pi, n2)
    X = np.concatenate([
        np.stack([np.cos(t1), np.sin(t1)], axis=1),
        np.stack([1.0 - np.cos(t2), 0.5 - np.sin(t2)], axis=1),
    ])
    X += noise_std * rng.standard_normal(X.shape)
    y = np.concatenate([-np.ones(n1), np.ones(n2)])
    perm = rng.permutation(n)
    return X[perm].astype(np.float32), y[perm].astype(np.float32)


def gaussian_blobs(n=300, num_classes=3, d=2, spread=0.6, seed=0):
    """Multiclass classification dataset: num_classes Gaussian blobs on a
    circle of radius 2. Returns (X (n,d) float32, y (n,) int32 labels).
    """
    rng = np.random.default_rng(seed)
    per = n // num_classes
    Xs, ys = [], []
    for c in range(num_classes):
        angle = 2.0 * np.pi * c / num_classes
        center = np.zeros(d)
        center[0] = 2.0 * np.cos(angle)
        center[min(1, d - 1)] += 2.0 * np.sin(angle)
        cnt = per if c < num_classes - 1 else n - per * (num_classes - 1)
        Xs.append(center + spread * rng.standard_normal((cnt, d)))
        ys.append(np.full(cnt, c))
    X = np.concatenate(Xs)
    y = np.concatenate(ys)
    perm = rng.permutation(n)
    return X[perm].astype(np.float32), y[perm].astype(np.int32)


def host_shard(X, y, process_index, process_count):
    """Contiguous row shard for this host (multi-host data feeding)."""
    n = X.shape[0]
    per = n // process_count
    lo = process_index * per
    hi = n if process_index == process_count - 1 else lo + per
    return X[lo:hi], y[lo:hi]
