"""Exact GP regression model, as ``cugp_tpu/models/exact_gp.py``.

Plain functions composing the ops tier (covariance build, Cholesky,
triangular solves) into the log-marginal likelihood, its gradient
(autograd through the Cholesky and solve rules) and the posterior
predictive. Tensors stay on the device they arrive on.
"""

from __future__ import annotations

import math

import torch

from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.utils.params import tree_leaves, tree_map

LOG2PI = math.log(2.0 * math.pi)


def safe_cholesky(K, sf2, method="auto", max_attempts=2, jitter0=1e-6):
    """Cholesky with an escalating-jitter retry ladder.

    fp32 factorization of a barely-PD covariance can produce NaNs; each
    failed attempt multiplies the added diagonal jitter by 100x. The JAX
    version decides with lax.cond on the device; here the is-finite check
    reads one scalar back to the host: one sync per factorization.
    """
    L = chol_ops.cholesky(K, method=method)
    for i in range(1, max_attempts):
        if bool(torch.isfinite(torch.diagonal(L).sum())):
            break
        extra = jitter0 * (100.0 ** i) * sf2
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        L = chol_ops.cholesky(K + extra * eye, method=method)
    return L


def _factorize(params, X, y, kind, jitter, method, safe=True, n_true=None):
    """K -> L, alpha = K^{-1} y."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method, n_true=n_true)
    if safe:
        sf2 = kernel_ops.signal_scale(params)
        L = safe_cholesky(K, sf2, method=method, jitter0=max(jitter, 1e-6))
    else:
        L = chol_ops.cholesky(K, method=method)
    alpha = trsm_ops.cho_solve(L, y, method=method)
    return L, alpha


def log_marginal_likelihood(params, X, y, kind="rbf", jitter=1e-6,
                            method="auto", safe=True, n_true=None):
    """LML = -1/2 y^T alpha - sum_i log L_ii - N/2 log 2pi.

    Padded inputs: zero-pad X rows and y and pass the true count as
    n_true; the result is the unpadded LML.
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method, safe, n_true)
    n = n_true if n_true is not None else y.shape[-1]
    logdet_half = torch.sum(torch.log(torch.diagonal(L)))
    quad = torch.sum(y * alpha)
    return -0.5 * quad - logdet_half - 0.5 * n * LOG2PI


def lml_value_and_grad(params, X, y, **kw):
    """(LML, d LML / d params) with the gradient in params' nesting."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        val = log_marginal_likelihood(p, X, y, **kw)
        leaves = tree_leaves(p)
        grads = iter(torch.autograd.grad(val, leaves))
    return val.detach(), tree_map(lambda _: next(grads), p)


def predict_from_factor(params, X, L, alpha, Xs, kind="rbf", method="auto",
                        include_noise=False, n_true=None):
    """Posterior mean and diagonal variance at Xs from a factorization:
    mu* = K*^T alpha;  v = L^{-1} K*;  var* = k** - sum(v*v, axis=0)."""
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind, method=method,
                                     n_true=n_true)
    mu = Ks.mT @ alpha
    V = trsm_ops.solve_lx(L, Ks, method=method)
    var = kernel_ops.kernel_diag(params, Xs, kind) - torch.sum(V * V, dim=0)
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    return mu, torch.clamp(var, min=0.0)


def posterior(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
              include_noise=False, n_true=None):
    """Posterior mean and diagonal variance at test points Xs."""
    L, alpha = _factorize(params, X, y, kind, jitter, method, True, n_true)
    return predict_from_factor(params, X, L, alpha, Xs, kind=kind,
                               method=method, include_noise=include_noise,
                               n_true=n_true)


def posterior_full_cov(params, X, y, Xs, kind="rbf", jitter=1e-6,
                       method="auto"):
    """Posterior mean and FULL covariance at test points Xs."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind, method=method)
    Kss = kernel_ops.cross_covariance(params, Xs, Xs, kind=kind,
                                      method=method)
    mu = Ks.mT @ alpha
    V = trsm_ops.solve_lx(L, Ks, method=method)
    return mu, Kss - V.mT @ V
