"""Binary GP classification (Laplace approximation), as
``cugp_tpu/models/gpc.py``.

Model: y in {-1, +1}, logistic likelihood p(y|f) = sigmoid(y f), GP
prior f ~ N(0, K). The posterior mode comes from Newton's iteration in
the W^1/2 parameterization (GPML Algorithm 3.1: B = I + W^1/2 K W^1/2 is
well conditioned even when K is not); the Gaussian at the mode gives the
approximate log marginal likelihood and the predictive (Algorithm 3.2,
MacKay's probit approximation of the class-probability integral).

The JAX package's fixed-length ``lax.scan`` of Newton steps is a plain
loop here, and the hyperparameter gradient is autograd through it, as
JAX differentiates the scan. Each step runs the port's Cholesky on B
and two triangular solves (the potrf and TRSM kernels on CUDA).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops


def _newton_terms(K, f, y):
    """(grad log p, W, sqrt W, L = chol(B)) at f."""
    pi = torch.sigmoid(f)
    grad = 0.5 * (y + 1.0) - pi  # d log p / df for y in {-1,+1}
    w = torch.clamp(pi * (1.0 - pi), min=1e-10)
    sw = torch.sqrt(w)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    L = chol_ops.cholesky(eye + sw[:, None] * K * sw[None, :])
    return grad, w, sw, L


def _laplace_mode(K, y, num_newton=20):
    """Newton iterations for the mode (GPML Alg 3.1). Returns (f, a, obj):
    a = K^{-1} f at the mode, obj = -1/2 a^T f + log p(y|f)."""
    f = torch.zeros_like(y)
    a = torch.zeros_like(y)
    for _ in range(num_newton):
        grad, w, sw, L = _newton_terms(K, f, y)
        b = w * f + grad
        # a = b - W^1/2 L^-T (L^-1 (W^1/2 K b))
        inner = trsm_ops.solve_lx(L, sw * (K @ b))
        a = b - sw * trsm_ops.solve_ltx(L, inner)
        f = K @ a
    loglik = torch.sum(F.logsigmoid(torch.where(y > 0.0, f, -f)))
    return f, a, -0.5 * torch.sum(a * f) + loglik


def laplace_lml(params, X, y, kind="rbf", jitter=1e-6, method="auto",
                num_newton=20):
    """Approximate log marginal likelihood under the Laplace
    approximation (GPML eq. 3.32): -1/2 a^T f + log p(y|f) - sum_i log
    L_ii with L = chol(I + W^1/2 K W^1/2) at the mode."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    f, _a, obj = _laplace_mode(K, y, num_newton)
    L = _newton_terms(K, f, y)[3]
    return obj - torch.sum(torch.log(torch.diagonal(L)))


def predict_proba(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  num_newton=20):
    """Predictive class-+1 probability at Xs (GPML Alg 3.2 + MacKay's
    probit approximation). Returns (prob, f_mean, f_var)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    f, _a, _obj = _laplace_mode(K, y, num_newton)
    grad, _w, sw, L = _newton_terms(K, f, y)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind,
                                     method=method)
    mu = Ks.mT @ grad
    v = trsm_ops.solve_lx(L, sw[:, None] * Ks)
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var = torch.clamp(kss - torch.sum(v * v, dim=0), min=1e-10)
    kappa = 1.0 / torch.sqrt(1.0 + (math.pi / 8.0) * var)
    return torch.sigmoid(kappa * mu), mu, var


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=100, learning_rate=0.05, num_newton=20):
    """MAP hyperparameters by maximizing the Laplace marginal: Adam under
    optax.apply_if_finite's rule with 100 as its count."""
    params, losses = map_opt.adam_fit(
        init_params,
        lambda p, _step: -laplace_lml(p, X, y, kind=kind, jitter=jitter,
                                      method=method, num_newton=num_newton),
        steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=100)
    return params, {"loss": losses, "lml": -losses[-1]}
