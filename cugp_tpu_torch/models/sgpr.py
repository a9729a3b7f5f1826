"""Sparse GP regression (Titsias collapsed bound), as
``cugp_tpu/models/sgpr.py``.

SGPR with m inducing points: O(n m^2) instead of O(n^3). Collapsed
evidence lower bound (Titsias 2009):

  ELBO = log N(y | 0, Q_nn + sigma^2 I) - 1/(2 sigma^2) tr(K_nn - Q_nn)

computed through m x m factorizations only:
  L   = chol(K_mm + jitter I)
  A   = L^{-1} K_mn / sigma          (m x n)
  B   = I + A A^T,  L_B = chol(B)
  c   = L_B^{-1} A y / sigma
  ELBO = -n/2 log(2 pi sigma^2) - sum log diag(L_B)
         - ||y||^2/(2 sigma^2) + ||c||^2 / 2
         - (tr(K_nn) - tr(A A^T)) / (2 sigma^2)

With Z = X (m = n) the bound equals the exact LML (up to jitter). Every
covariance is ``ops.kernels.cross_covariance`` (the covariance kernel on
CUDA), every Cholesky ``ops.cholesky`` (the potrf kernel at the base)
and every triangular solve ``ops.trsm`` (the TRSM kernel at the base),
where the JAX package calls XLA's own Cholesky and solves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops

LOG2PI = math.log(2.0 * math.pi)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _common(params, Z, X, y, kind, jitter):
    m = Z.shape[0]
    sn2 = torch.exp(params["log_noise_var"])
    sf2 = kernel_ops.signal_scale(params)
    # K_mm is noise-free and can be fp32-singular (e.g. Z dense in X): an
    # escalating-jitter ladder keeps the factorization finite
    Kmm = kernel_ops.cross_covariance(params, Z, Z, kind)
    Kmm = Kmm + (jitter * sf2 + 1e-6) * _eye(m, Kmm)
    Kmn = kernel_ops.cross_covariance(params, Z, X, kind)
    L = exact_gp.safe_cholesky(Kmm, sf2, max_attempts=3, jitter0=1e-5)
    A = trsm_ops.solve_lx(L, Kmn) / torch.sqrt(sn2)
    B = _eye(m, A) + A @ A.mT
    LB = chol_ops.cholesky(B)
    c = trsm_ops.solve_lx(LB, A @ y) / torch.sqrt(sn2)
    return L, A, LB, c, sn2, sf2


def elbo(params, Z, X, y, kind="rbf", jitter=1e-6):
    """Collapsed SGPR evidence lower bound."""
    n = X.shape[0]
    L, A, LB, c, sn2, sf2 = _common(params, Z, X, y, kind, jitter)
    out = -0.5 * n * (LOG2PI + torch.log(sn2))
    out = out - torch.sum(torch.log(torch.diagonal(LB)))   # -1/2 log|B|
    out = out - 0.5 * torch.sum(y * y) / sn2 + 0.5 * torch.sum(c * c)
    # trace correction -1/(2 sn2) (tr K_nn - tr Q_nn), with
    # tr(Q_nn)/sn2 = tr(A A^T); kernel_diag handles non-stationary kinds
    tr_knn = torch.sum(kernel_ops.kernel_diag(params, X, kind))
    return out - 0.5 * tr_knn / sn2 + 0.5 * torch.sum(A * A)


def posterior(params, Z, X, y, Xs, kind="rbf", jitter=1e-6,
              include_noise=False):
    """SGPR predictive mean/variance at Xs.

    mu* = K*m L^{-T} L_B^{-T} c
    var* = k** - ||L^{-1} K_m*||^2 + ||L_B^{-1} L^{-1} K_m*||^2 (+ sn2)
    """
    L, A, LB, c, sn2, sf2 = _common(params, Z, X, y, kind, jitter)
    Kms = kernel_ops.cross_covariance(params, Z, Xs, kind)  # (m, s)
    tmp1 = trsm_ops.solve_lx(L, Kms)
    tmp2 = trsm_ops.solve_lx(LB, tmp1)
    mu = tmp2.mT @ c
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var = (kss - torch.sum(tmp1 * tmp1, dim=0)
           + torch.sum(tmp2 * tmp2, dim=0))
    if include_noise:
        var = var + sn2
    return mu, torch.clamp(var, min=0.0)


def init_inducing(X, m, seed=0):
    """Inducing locations: a random training subset (the JAX package's
    NumPy draw, so the same rows for a seed), on X's device."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(X.shape[0], size=min(m, X.shape[0]), replace=False)
    return X[torch.as_tensor(np.sort(idx), device=X.device)]


def fit(init_params, X, y, *, num_inducing=512, Z=None, kind="rbf",
        jitter=1e-6, steps=500, learning_rate=0.05, optimize_inducing=True,
        seed=0):
    """Maximize the collapsed ELBO over hyperparameters (and inducing
    locations): Adam under optax.apply_if_finite's rule with 1000 as its
    count (map_opt.adam_fit). Returns (params, Z, info) with info
    "loss" (the negative ELBO at each step's pre-update point) and
    "elbo" = -loss[-1]."""
    if Z is None:
        Z = init_inducing(X, num_inducing, seed=seed)
    trainables = {"params": init_params}
    if optimize_inducing:
        trainables["Z"] = Z

    def loss_fn(tr, _step):
        z = tr["Z"] if optimize_inducing else Z
        return -elbo(tr["params"], z, X, y, kind=kind, jitter=jitter)

    tr, losses = map_opt.adam_fit(
        trainables, loss_fn, steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=1000)
    z_out = tr["Z"] if optimize_inducing else Z
    return tr["params"], z_out, {"loss": losses, "elbo": -losses[-1]}
