"""Float64 NumPy oracle for EP binary GP classification (GPML ch. 3.6).

A copy of ``cugp_tpu/oracle/gpc_ep_np.py`` (numpy and scipy only, for a
machine without jax). Mirrors models/gpc_ep (parallel EP, probit likelihood) in
double precision, plus a brute-force quasi-Monte-Carlo evaluation of the
EXACT log marginal likelihood log int N(f|0,K) prod Phi(y_i f_i) df —
the ground truth that certifies the EP approximation AND the site-based
log Z_EP formula in tests.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg as sla
from scipy import stats
from scipy.special import log_ndtr, ndtr

from cugp_tpu_torch.oracle.exact_gp_np import train_covariance

_TAU_FLOOR = 1e-6
LOG2PI = np.log(2.0 * np.pi)


def _posterior_from_sites(K, tau, nu):
    n = K.shape[0]
    sr = np.sqrt(tau)
    B = np.eye(n) + (sr[:, None] * K) * sr[None, :]
    L = sla.cholesky(B, lower=True)
    V = sla.solve_triangular(L, sr[:, None] * K, lower=True)
    Sigma = K - V.T @ V
    mu = Sigma @ nu
    return mu, np.diag(Sigma).copy(), L, sr


def _probit_moments(y, mu_c, s2_c):
    denom = np.sqrt(1.0 + s2_c)
    z = y * mu_c / denom
    logZ = log_ndtr(z)
    ratio = np.exp(stats.norm.logpdf(z) - logZ)
    mu_hat = mu_c + y * s2_c * ratio / denom
    s2_hat = s2_c - s2_c ** 2 * ratio / (1.0 + s2_c) * (z + ratio)
    return logZ, mu_hat, np.maximum(s2_hat, 1e-12)


def ep_fit_sites(K, y, num_sweeps=60, damping=0.7):
    n = y.shape[0]
    tau = np.full(n, _TAU_FLOOR)
    nu = np.zeros(n)
    for _ in range(num_sweeps):
        mu, s2, _L, _sr = _posterior_from_sites(K, tau, nu)
        tau_c = np.maximum(1.0 / s2 - tau, _TAU_FLOOR)
        nu_c = mu / s2 - nu
        _lz, mu_hat, s2_hat = _probit_moments(y, nu_c / tau_c, 1.0 / tau_c)
        tau_new = np.maximum(1.0 / s2_hat - tau_c, _TAU_FLOOR)
        nu_new = mu_hat / s2_hat - nu_c
        tau = (1.0 - damping) * tau + damping * tau_new
        nu = (1.0 - damping) * nu + damping * nu_new
    return tau, nu


def ep_lml(params, X, y, kind="rbf", jitter=1e-6, num_sweeps=60,
           damping=0.7):
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    tau, nu = ep_fit_sites(K, y, num_sweeps, damping)
    n = y.shape[0]
    mu, s2, L, sr = _posterior_from_sites(K, tau, nu)
    tau_c = np.maximum(1.0 / s2 - tau, _TAU_FLOOR)
    nu_c = mu / s2 - nu
    mu_c = nu_c / tau_c
    s2_c = 1.0 / tau_c
    logZhat, _mh, _sh = _probit_moments(y, mu_c, s2_c)
    mu_t = nu / tau
    v = s2_c + 1.0 / tau
    log_sites = np.sum(logZhat + 0.5 * (np.log(v) + LOG2PI)
                       + 0.5 * (mu_c - mu_t) ** 2 / v)
    w = sla.solve_triangular(L, sr * mu_t, lower=True)
    logdet = 2.0 * np.sum(np.log(np.diag(L))) - np.sum(np.log(tau))
    log_gauss = -0.5 * (n * LOG2PI + logdet + np.dot(w, w))
    return log_sites + log_gauss


def predict_proba(params, X, y, Xs, kind="rbf", jitter=1e-6,
                  num_sweeps=60, damping=0.7):
    from cugp_tpu_torch.oracle import exact_gp_np as onp

    K = train_covariance(params, X, kind=kind, jitter=jitter)
    tau, nu = ep_fit_sites(K, y, num_sweeps, damping)
    _m, _s, L, sr = _posterior_from_sites(K, tau, nu)
    Ks = onp.kernel_matrix(params, X, Xs, kind)
    mu_t = nu / tau
    w = sla.solve_triangular(
        L.T, sla.solve_triangular(L, sr * mu_t, lower=True), lower=False)
    mu_s = Ks.T @ (sr * w)
    V = sla.solve_triangular(L, sr[:, None] * Ks, lower=True)
    var_s = np.maximum(onp.kernel_diag(params, Xs, kind)
                       - np.sum(V * V, axis=0), 1e-12)
    return ndtr(mu_s / np.sqrt(1.0 + var_s)), mu_s, var_s


def true_lml_qmc(params, X, y, kind="rbf", jitter=1e-6,
                 num_samples=1 << 18, seed=0):
    """Brute-force exact log Z = log E_{f~N(0,K)}[prod_i Phi(y_i f_i)]
    by scrambled-Sobol QMC over the prior (log-sum-exp for stability).
    Ground truth for small n."""
    K = train_covariance(params, X, kind=kind, jitter=jitter)
    n = K.shape[0]
    L = sla.cholesky(K + 1e-10 * np.eye(n), lower=True)
    eng = stats.qmc.Sobol(d=n, scramble=True, seed=seed)
    u = eng.random(num_samples)
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    z = stats.norm.ppf(u)                    # (S, n)
    f = z @ L.T
    logp = log_ndtr(y[None, :] * f).sum(axis=1)   # (S,)
    m = logp.max()
    return float(m + np.log(np.mean(np.exp(logp - m))))
