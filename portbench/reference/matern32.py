"""Exact GP regression with an ARD Matern-3/2 kernel, in float64.

The model (Rasmussen and Williams 2006, eq. 4.17 with nu = 3/2):

    k(x, x') = sf2 (1 + sqrt(3) r) exp(-sqrt(3) r),
    r^2 = sum_j (x_j - x'_j)^2 / ell_j^2,
    K = k(X, X) + (sn2 + jitter sf2) I,

with the hyperparameters in log space: ``log_lengthscale`` (d,),
``log_signal_var`` and ``log_noise_var``. The LML is
-1/2 y^T K^-1 y - 1/2 log|K| - n/2 log 2 pi; its gradient in a
hyperparameter t is 1/2 sum_ik W_ik dK_ik/dt with W = a a^T - K^-1
(a = K^-1 y), or, for the Hutchinson estimate from the solves
a = K^-1 y and w_j = K^-1 z_j, W = a a^T - 1/s sum_j w_j z_j^T.

Every n x n quantity is formed in row blocks, so the reference fits
beside nothing else on the card at the benchmark's sizes.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
SQRT3 = math.sqrt(3.0)
LOG2PI = math.log(2.0 * math.pi)


def unpack(params, device):
    """(ell (d,), sf2, sn2) as float64 on `device` from the log-space
    dict (any tensors or numbers)."""
    def t(v):
        return torch.as_tensor(v, dtype=F64).to(device)

    return (torch.exp(t(params["log_lengthscale"])),
            torch.exp(t(params["log_signal_var"])),
            torch.exp(t(params["log_noise_var"])))


def _dist(a, b):
    """Euclidean distances between the rows of a (m, d) and b (n, d)."""
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def unit_kernel(a, b):
    """(1 + sqrt3 r) exp(-sqrt3 r) between pre-scaled rows."""
    s = SQRT3 * _dist(a, b)
    return (1.0 + s) * torch.exp(-s)


def covariance(X, params, jitter, block=4096):
    """K (n, n) float64, built in row blocks."""
    ell, sf2, sn2 = unpack(params, X.device)
    Xs = X.to(F64) / ell
    n = Xs.shape[0]
    K = torch.empty((n, n), dtype=F64, device=X.device)
    for lo in range(0, n, block):
        K[lo:lo + block] = sf2 * unit_kernel(Xs[lo:lo + block], Xs)
    K.diagonal().add_(sn2 + jitter * sf2)
    return K


def factor(X, y, params, jitter, block=4096):
    """(L, a = K^-1 y, LML) in float64."""
    K = covariance(X, params, jitter, block)
    L = torch.linalg.cholesky(K)
    del K
    y64 = y.to(F64)
    a = torch.cholesky_solve(y64[:, None], L)[:, 0]
    n = y64.shape[0]
    lml = (-0.5 * torch.dot(y64, a) - torch.log(L.diagonal()).sum()
           - 0.5 * n * LOG2PI)
    return L, a, float(lml)


def grad_from_w(X, params, jitter, w_rows, trace_w, block=2048):
    """1/2 sum_ik W_ik dK_ik/dt for each hyperparameter t, W given by row
    blocks w_rows(lo, hi) -> (hi - lo, n) and its trace. Returns the
    gradient as a dict of float64 tensors in the params' names."""
    ell, sf2, sn2 = unpack(params, X.device)
    Xs = X.to(F64) / ell
    n, d = Xs.shape
    sq = Xs * Xs
    g_ell = torch.zeros(d, dtype=F64, device=X.device)
    s_k = torch.zeros((), dtype=F64, device=X.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        Wb = w_rows(lo, hi)
        s = SQRT3 * _dist(Xs[lo:hi], Xs)
        e = torch.exp(-s)
        s_k += (Wb * ((1.0 + s) * e)).sum()
        # dk/dlog ell_j = 3 exp(-sqrt3 r) (x_j - x'_j)^2 / ell_j^2
        WE = Wb * (3.0 * e)
        rows, cols = WE.sum(1), WE.sum(0)
        M = WE @ Xs
        g_ell += (sq[lo:hi] * rows[:, None]).sum(0) + sq.T @ cols \
            - 2.0 * (Xs[lo:hi] * M).sum(0)
    trace_w = torch.as_tensor(trace_w, dtype=F64, device=X.device)
    return {"log_lengthscale": 0.5 * sf2 * g_ell,
            "log_signal_var": 0.5 * (sf2 * s_k + jitter * sf2 * trace_w),
            "log_noise_var": 0.5 * sn2 * trace_w}


def lml_and_grad(X, y, params, jitter, block=2048):
    """(LML, its exact gradient) in float64, dense."""
    L, a, lml = factor(X, y, params, jitter)
    Kinv = torch.cholesky_inverse(L)
    del L
    trace_w = torch.dot(a, a) - Kinv.diagonal().sum()
    grad = grad_from_w(
        X, params, jitter,
        lambda lo, hi: a[lo:hi, None] * a[None, :] - Kinv[lo:hi], trace_w,
        block)
    del Kinv
    return lml, grad


def estimator_grad(X, params, jitter, a, w, z, block=2048):
    """The Hutchinson gradient estimate 1/2 (a^T dK a - mean_j w_j^T dK
    z_j) from given solves a (n,), w (n, s) and probes z (n, s)."""
    a, w, z = a.to(F64), w.to(F64), z.to(F64)
    s = z.shape[1]
    trace_w = torch.dot(a, a) - (w * z).sum() / s
    return grad_from_w(
        X, params, jitter,
        lambda lo, hi: a[lo:hi, None] * a[None, :] - (w[lo:hi] @ z.T) / s,
        trace_w, block)


def apply_covariance(X, params, jitter, V, block=2048):
    """K V in float64 without forming K."""
    ell, sf2, sn2 = unpack(params, X.device)
    Xs = X.to(F64) / ell
    V = V.to(F64)
    out = torch.empty_like(V)
    for lo in range(0, Xs.shape[0], block):
        out[lo:lo + block] = sf2 * unit_kernel(Xs[lo:lo + block], Xs) @ V
    return out + (sn2 + jitter * sf2) * V


def relative_residuals(X, params, jitter, sol, rhs, block=2048):
    """||K sol - rhs|| / ||rhs|| per column (float64)."""
    rhs = rhs.to(F64)
    r = apply_covariance(X, params, jitter, sol, block) - rhs
    return torch.linalg.vector_norm(r, dim=0) / torch.linalg.vector_norm(
        rhs, dim=0)


def posterior(L, a, X, params, Xt, chunk=8192):
    """Latent posterior mean and variance (clamped at 0) at Xt, float64,
    from the reference's own factor."""
    ell, sf2, _ = unpack(params, X.device)
    Xs = X.to(F64) / ell
    Xts = Xt.to(F64) / ell
    means, vars_ = [], []
    for lo in range(0, Xts.shape[0], chunk):
        Ks = sf2 * unit_kernel(Xs, Xts[lo:lo + chunk])
        means.append(Ks.T @ a)
        V = torch.linalg.solve_triangular(L, Ks, upper=False)
        vars_.append(torch.clamp(sf2 - (V * V).sum(0), min=0.0))
    return torch.cat(means), torch.cat(vars_)
