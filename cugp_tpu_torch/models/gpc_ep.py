"""Binary GP classification by Expectation Propagation (GPML ch. 3.6), as
``cugp_tpu/models/gpc_ep.py``.

Model: y in {-1, +1}, probit likelihood p(y|f) = Phi(y f), GP prior
f ~ N(0, K). Each likelihood term is approximated by a scaled Gaussian
site with natural parameters tau~ >= 0, nu~. Parallel EP: every sweep
recomputes the joint posterior once (one Cholesky of
B = I + S~^1/2 K S~^1/2 and one triangular solve against S~^1/2 K) and
moment-matches all sites at once, damped on the natural parameters.
The marginal likelihood is computed from first principles:

  Z_EP = [prod_i Z~_i] * N(mu~ | 0, K + S~^-1)
  log Z~_i = log Phi(z_i) - log N(mu_-i - mu~_i | 0, s2_-i + 1/tau~_i)

The JAX package's fixed-length ``lax.scan`` of sweeps is a plain loop
here, with the hyperparameter gradient by autograd through it. Each
sweep runs the port's Cholesky and an (n, n) TRSM (the potrf and TRSM
kernels on CUDA); scipy's normal logcdf/logpdf/cdf are
``torch.special.log_ndtr``, the Gaussian log density and ``ndtr``.
"""

from __future__ import annotations

import math

import torch

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops

_TAU_FLOOR = 1e-6
LOG2PI = math.log(2.0 * math.pi)


def _posterior_from_sites(K, tau, nu):
    """mu, sigma2 (marginals), L = chol(B), sr = sqrt(tau):
    Sigma = K - K S^1/2 B^-1 S^1/2 K, mu = Sigma nu~."""
    n = K.shape[0]
    sr = torch.sqrt(tau)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L = chol_ops.cholesky(eye + sr[:, None] * K * sr[None, :])
    V = trsm_ops.solve_lx(L, sr[:, None] * K)           # (n, n)
    Sigma = K - V.mT @ V
    mu = Sigma @ nu
    return mu, torch.diagonal(Sigma), L, sr


def _probit_moments(y, mu_c, s2_c):
    """Tilted-distribution moments against the probit likelihood (GPML
    eqs. 3.58): (logZhat, mu_hat, s2_hat)."""
    denom = torch.sqrt(1.0 + s2_c)
    z = y * mu_c / denom
    logZ = torch.special.log_ndtr(z)
    ratio = torch.exp(-0.5 * z * z - 0.5 * LOG2PI - logZ)  # phi(z)/Phi(z)
    mu_hat = mu_c + y * s2_c * ratio / denom
    s2_hat = s2_c - s2_c ** 2 * ratio / (1.0 + s2_c) * (z + ratio)
    return logZ, mu_hat, torch.clamp(s2_hat, min=1e-10)


def _cavity(tau, nu, mu, s2):
    """Cavity mean and variance; the cavity precision floored at
    _TAU_FLOOR against a negative one."""
    tau_c = torch.clamp(1.0 / s2 - tau, min=_TAU_FLOOR)
    nu_c = mu / s2 - nu
    return tau_c, nu_c, nu_c / tau_c, 1.0 / tau_c


def _ep_sweeps(K, y, num_sweeps=30, damping=0.7):
    """Parallel-EP fixed-point iteration. Returns (tau, nu, mu, s2)."""
    n = y.shape[0]
    tau = torch.full((n,), _TAU_FLOOR, dtype=K.dtype, device=K.device)
    nu = torch.zeros((n,), dtype=K.dtype, device=K.device)
    for _ in range(num_sweeps):
        mu, s2, _L, _sr = _posterior_from_sites(K, tau, nu)
        tau_c, nu_c, mu_c, s2_c = _cavity(tau, nu, mu, s2)
        _logZ, mu_hat, s2_hat = _probit_moments(y, mu_c, s2_c)
        tau_new = torch.clamp(1.0 / s2_hat - tau_c, min=_TAU_FLOOR)
        nu_new = mu_hat / s2_hat - nu_c
        tau = (1.0 - damping) * tau + damping * tau_new
        nu = (1.0 - damping) * nu + damping * nu_new
    mu, s2, _L, _sr = _posterior_from_sites(K, tau, nu)
    return tau, nu, mu, s2


def ep_lml(params, X, y, kind="rbf", jitter=1e-6, method="auto",
           num_sweeps=30, damping=0.7):
    """EP approximate log marginal likelihood (the module docstring's
    formula)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    tau, nu, mu, s2 = _ep_sweeps(K, y, num_sweeps, damping)
    n = y.shape[0]
    _tau_c, _nu_c, mu_c, s2_c = _cavity(tau, nu, mu, s2)
    logZhat, _mh, _sh = _probit_moments(y, mu_c, s2_c)
    mu_t = nu / tau
    # site normalizers: log Zhat_i - log N(mu_c - mu_t | 0, s2_c + 1/tau)
    v = s2_c + 1.0 / tau
    log_sites = torch.sum(logZhat + 0.5 * (torch.log(v) + LOG2PI)
                          + 0.5 * (mu_c - mu_t) ** 2 / v)
    # log N(mu_t | 0, K + S^-1) via B: log|K + S^-1| = log|B| - sum log tau
    _mu, _s2, L, sr = _posterior_from_sites(K, tau, nu)
    w = trsm_ops.solve_lx(L, sr * mu_t)
    quad = torch.sum(w * w)   # mu_t^T S^1/2 B^-1 S^1/2 mu_t
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(L)))
              - torch.sum(torch.log(tau)))
    return log_sites - 0.5 * (n * LOG2PI + logdet + quad)


def predict_proba(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  num_sweeps=30, damping=0.7):
    """Predictive p(y=+1 | x*) (GPML eqs. 3.60-3.61: the probit integral
    is exact for EP). Returns (prob, f_mean, f_var)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    tau, nu, _mu, _s2 = _ep_sweeps(K, y, num_sweeps, damping)
    _m, _v, L, sr = _posterior_from_sites(K, tau, nu)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind,
                                     method=method)          # (n, m)
    # mu* = k*^T (K + S^-1)^-1 mu_t = k*^T S^1/2 B^-1 S^1/2 mu_t
    w = trsm_ops.cho_solve(L, sr * (nu / tau))
    mu_s = Ks.mT @ (sr * w)
    V = trsm_ops.solve_lx(L, sr[:, None] * Ks)
    kss = kernel_ops.kernel_diag(params, Xs, kind)
    var_s = torch.clamp(kss - torch.sum(V * V, dim=0), min=1e-10)
    prob = torch.special.ndtr(mu_s / torch.sqrt(1.0 + var_s))
    return prob, mu_s, var_s


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=100, learning_rate=0.05, num_sweeps=30, damping=0.7,
        num_newton=None):
    """MAP hyperparameters by maximizing the EP marginal: Adam under
    optax.apply_if_finite's rule with 100 as its count (num_newton is
    accepted and ignored, for the facade's signature)."""
    params, losses = map_opt.adam_fit(
        init_params,
        lambda p, _step: -ep_lml(p, X, y, kind=kind, jitter=jitter,
                                 method=method, num_sweeps=num_sweeps,
                                 damping=damping),
        steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=100)
    return params, {"loss": losses, "lml": -losses[-1]}
