"""Exact GP regression model, as ``cugp_tpu/models/exact_gp.py``.

Plain functions composing the ops tier (covariance build, Cholesky,
triangular solves) into the log-marginal likelihood, its gradient and
the posterior predictive. Tensors stay on the device they arrive on.

Two backwards serve the gradients. ``log_marginal_likelihood`` carries
its own autograd Function, whose backward is the closed form
dLML/dA = 1/2 (alpha alpha^T - A^{-1}) (GPML eq. 5.9) from the saved
factor (``cholesky.cho_inverse``, 2 n^3 / 3), A the matrix the jitter
ladder last factored. Every other objective (the basis, multi-output
and LOO ones, and the sparse, classification and LMC models)
differentiates L itself, through Murray's rule in ``ops/cholesky.py``
and the solves' rules.

``safe_cholesky``, ``_factorize`` and ``log_marginal_likelihood`` also
take hyperparameters whose leaves carry a leading batch B (the samplers'
chains, as ``jax.vmap`` of the JAX functions): one batched covariance
build, one batched Cholesky and batched solves give the (B,) LMLs.
"""

from __future__ import annotations

import math

import torch

from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.utils import profiling
from cugp_tpu_torch.utils.params import tree_leaves, tree_map

LOG2PI = math.log(2.0 * math.pi)


def _ladder(K, sf2, max_attempts, jitter0, factor):
    """The jitter ladder of safe_cholesky: (factor(A), A), A the matrix
    its last level factored (K, or K plus each failed element's jitter
    on the diagonal, in K's autograd graph and sf2's)."""
    A = K
    L = factor(A)
    extra = None
    for i in range(1, max_attempts):
        ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1).sum(-1))
        if profiling.read_bool(ok.all(), "chol_ladder"):
            break
        if extra is None:
            extra = torch.zeros_like(sf2)
        extra = torch.where(ok, extra, jitter0 * (100.0 ** i) * sf2)
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        A = K + extra[..., None, None] * eye
        L = factor(A)
    return L, A


def safe_cholesky(K, sf2, method="auto", max_attempts=2, jitter0=1e-6):
    """Cholesky with an escalating-jitter retry ladder.

    fp32 factorization of a barely-PD covariance can produce NaNs; each
    failed attempt multiplies the added diagonal jitter by 100x. The JAX
    version decides with lax.cond on the device; here the is-finite check
    reads one scalar back to the host: one sync per factorization.

    A batch K (B, n, n) with sf2 (B,) decides per element, as vmap of the
    JAX ladder does (K (n, n) with a 0-d sf2 is a batch of one): an
    element whose factor is not finite gets the level's jitter, the
    others keep theirs (0 for an element that factored at once), and the
    batch is factored again. Elements that keep their jitter come out
    with the same bits as before, since every element of a batched
    factorization is computed on its own; only the last factorization is
    in the autograd graph, so no element's gradient passes through a
    failed factor (the JAX version's does: its gradient is NaN wherever
    the ladder retries). One host read per ladder level for the batch.
    """
    return _ladder(K, sf2, max_attempts, jitter0,
                   lambda a: chol_ops.cholesky(a, method=method))[0]


def _factor(params, X, y, kind, jitter, method, safe, n_true, factor):
    """(L, A, y): K's factor through `factor` (safe: the jitter ladder),
    the matrix it factored, and y (a batch's for every element)."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method, n_true=n_true)
    if safe:
        L, A = _ladder(K, kernel_ops.signal_scale(params), 2,
                       max(jitter, 1e-6), factor)
    else:
        L, A = factor(K), K
    if L.ndim == 3 and y.ndim == 1:  # a batch: y for every element
        y = y.expand(L.shape[0], -1).contiguous()
    return L, A, y


def _factorize(params, X, y, kind, jitter, method, safe=True, n_true=None):
    """K -> L, alpha = K^{-1} y (the span ``cugp.factorize``), both in
    the autograd graph (Murray's rule and the solves' rules)."""
    with profiling.span("cugp.factorize", X.device):
        L, _, y = _factor(params, X, y, kind, jitter, method, safe, n_true,
                          lambda a: chol_ops.cholesky(a, method=method))
        alpha = trsm_ops.cho_solve(L, y, method=method)
    return L, alpha


class _LML(torch.autograd.Function):
    """The LML from the forward's own factor L and alpha = A^{-1} y (both
    outside the autograd graph), differentiable in A and y:
    A_bar = g/2 (alpha alpha^T - A^{-1}), y_bar = -g alpha."""

    @staticmethod
    def forward(ctx, a, y, l, alpha, n):
        ctx.save_for_backward(l, alpha)
        logdet_half = torch.sum(torch.log(torch.diagonal(l, dim1=-2,
                                                         dim2=-1)), dim=-1)
        quad = torch.sum(y * alpha, dim=-1)
        return -0.5 * quad - logdet_half - 0.5 * n * LOG2PI

    @staticmethod
    def backward(ctx, g):
        l, alpha = ctx.saved_tensors
        a_bar = y_bar = None
        with profiling.span("cugp.chol_backward", l.device):
            profiling.count("lml_backward.closed_form")
            if ctx.needs_input_grad[0]:
                a_bar = chol_ops.cho_inverse(l)
                if a_bar.ndim == 2:
                    a_bar.addr_(alpha, alpha, beta=-1.0)
                else:
                    a_bar.baddbmm_(alpha[..., :, None], alpha[..., None, :],
                                   beta=-1.0)
                a_bar.mul_(0.5 * g[..., None, None])
            if ctx.needs_input_grad[1]:
                y_bar = -g[..., None] * alpha
        return a_bar, y_bar, None, None, None


def log_marginal_likelihood(params, X, y, kind="rbf", jitter=1e-6,
                            method="auto", safe=True, n_true=None):
    """LML = -1/2 y^T alpha - sum_i log L_ii - N/2 log 2pi.

    Padded inputs: zero-pad X rows and y and pass the true count as
    n_true; the result is the unpadded LML (the identity-padded block
    has A^{-1} = I and alpha = 0 there, so its gradient is the unpadded
    one). Params with a leading batch B give the (B,) LMLs. The gradient
    is the closed form of ``_LML`` (the span ``cugp.chol_backward``).
    """
    with profiling.span("cugp.factorize", X.device):
        L, A, y = _factor(params, X, y, kind, jitter, method, safe, n_true,
                          lambda a: chol_ops.cholesky(a.detach(),
                                                      method=method))
        alpha = trsm_ops.cho_solve(L, y.detach(), method=method)
    n = n_true if n_true is not None else y.shape[-1]
    return _LML.apply(A, y, L, alpha, n)


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


# ---- Multi-output (shared kernel) regression ----
# p outputs sharing X and hyperparameters: one covariance and one Cholesky
# serve all of them; the solves take the p outputs as p right-hand sides.


def log_marginal_likelihood_multi(params, X, Y, kind="rbf", jitter=1e-6,
                                  method="auto"):
    """Sum of per-output LMLs for Y (n, p) under one shared kernel."""
    L, alpha = _factorize(params, X, Y, kind, jitter, method)  # (n, p)
    n = Y.shape[0]
    logdet_half = torch.sum(torch.log(torch.diagonal(L)))
    quad = torch.sum(Y * alpha, dim=0)  # (p,)
    return torch.sum(-0.5 * quad - logdet_half - 0.5 * n * LOG2PI)


def posterior_multi(params, X, Y, Xs, kind="rbf", jitter=1e-6,
                    method="auto", include_noise=False):
    """Posterior means (ns, p) and shared diagonal variance (ns,)."""
    return posterior(params, X, Y, Xs, kind=kind, jitter=jitter,
                     method=method, include_noise=include_noise)


# ---- Explicit basis functions (semiparametric GP, GPML section 2.7) ----
# g(x) = f(x) + h(x)^T beta with f ~ GP and beta marginalized under the
# vague-prior limit: closed-form corrections to the posterior and the
# marginal likelihood. Bases: "constant" (h = [1]) and "linear"
# (h = [1, x]). The m_b x m_b factor of A (m_b <= d + 1) goes through
# chol_ops.cholesky like every other factor.


def basis_matrix(X, basis):
    """H with rows h_j evaluated at the inputs: (m_b, n)."""
    ones = torch.ones((1, X.shape[0]), dtype=X.dtype, device=X.device)
    if basis == "constant":
        return ones
    if basis == "linear":
        return torch.cat([ones, X.T], dim=0)
    raise ValueError(f"unknown basis: {basis}")


def _basis_terms(L, y, H, method):
    """A = H K^-1 H^T (plus a 1e-8 tr(A)/m_b ridge), c = H K^-1 y, and
    K^-1 H^T (shared solves)."""
    KinvHt = trsm_ops.cho_solve(L, H.T, method=method)  # (n, m_b)
    A = H @ KinvHt
    m_b = A.shape[0]
    eye = torch.eye(m_b, dtype=A.dtype, device=A.device)
    A = A + 1e-8 * eye * torch.trace(A) / m_b
    c = (KinvHt.mT @ y[:, None])[:, 0]
    return A, c, KinvHt


def log_marginal_likelihood_basis(params, X, y, kind="rbf", jitter=1e-6,
                                  method="auto", basis="linear"):
    """LML with marginalized basis coefficients (GPML eq. 2.45, vague
    limit): lml_0 + 1/2 c^T A^-1 c - 1/2 log|A| + (m_b/2) log 2pi."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = y.shape[-1]
    logdet_half = torch.sum(torch.log(torch.diagonal(L)))
    lml0 = -0.5 * torch.sum(y * alpha) - logdet_half - 0.5 * n * LOG2PI
    H = basis_matrix(X, basis)
    A, c, _ = _basis_terms(L, y, H, method)
    La = chol_ops.cholesky(A, method=method)
    w = trsm_ops.solve_lx(La, c, method=method)
    m_b = H.shape[0]
    return (lml0 + 0.5 * torch.sum(w * w)
            - torch.sum(torch.log(torch.diagonal(La))) + 0.5 * m_b * LOG2PI)


def _basis_correction(X, y, Xs, L, Ks, method, basis):
    """(R^T beta_hat, W = La^-1 R, beta_hat) of the marginalized basis:
    R = H(Xs) - H K^-1 K*, beta_hat = A^-1 c."""
    H = basis_matrix(X, basis)
    Hs = basis_matrix(Xs, basis)
    A, c, KinvHt = _basis_terms(L, y, H, method)
    La = chol_ops.cholesky(A, method=method)
    beta = trsm_ops.cho_solve(La, c, method=method)
    R = Hs - KinvHt.mT @ Ks  # (m_b, ns)
    W = trsm_ops.solve_lx(La, R, method=method)
    return R.mT @ beta, W, beta


def posterior_basis(params, X, y, Xs, kind="rbf", jitter=1e-6, method="auto",
                    basis="linear", include_noise=False):
    """Posterior mean/variance with the marginalized basis (GPML 2.7):

    mean += R^T beta_hat,  var += diag(R^T A^-1 R),
    R = H(Xs) - H K^-1 K*,  beta_hat = A^-1 c.
    Returns (mu, var, beta_hat).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind, method=method)
    V = trsm_ops.solve_lx(L, Ks, method=method)
    var0 = kernel_ops.kernel_diag(params, Xs, kind) - torch.sum(V * V, dim=0)
    shift, W, beta = _basis_correction(X, y, Xs, L, Ks, method, basis)
    mu = Ks.mT @ alpha + shift
    var = var0 + torch.sum(W * W, dim=0)
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    return mu, torch.clamp(var, min=0.0), beta


def posterior_basis_full_cov(params, X, y, Xs, kind="rbf", jitter=1e-6,
                             method="auto", basis="linear"):
    """Posterior mean and FULL covariance with the marginalized basis
    (GPML eq. 2.42): cov = cov_0 + R^T A^-1 R with
    R = H(Xs) - H K^-1 K*. Returns (mu, cov, beta_hat)."""
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind, method=method)
    Kss = kernel_ops.cross_covariance(params, Xs, Xs, kind=kind,
                                      method=method)
    V = trsm_ops.solve_lx(L, Ks, method=method)
    shift, W, beta = _basis_correction(X, y, Xs, L, Ks, method, basis)
    mu = Ks.mT @ alpha + shift
    return mu, Kss - V.mT @ V + W.mT @ W, beta


def loo_cv(params, X, y, kind="rbf", jitter=1e-6, method="auto"):
    """Leave-one-out cross-validation from ONE factorization (GPML
    section 5.4.2, eqs 5.10-5.12), no refits.

    With alpha = K^{-1} y and c = diag(K^{-1}):
        mu_i     = y_i - alpha_i / c_i     (LOO predictive mean at x_i)
        sigma2_i = 1 / c_i                 (LOO predictive variance)
        logp_i   = -1/2 log sigma2_i - (y_i - mu_i)^2 / (2 sigma2_i)
                   - 1/2 log 2pi
    K includes the noise term, so (mu_i, sigma2_i) predict the NOISY
    observation y_i. c_i = ||(L^{-1})[:, i]||^2 from one triangular solve
    against the identity (the TRSM at k = n on the card).

    Returns (mu, var, logp), each (n,).
    """
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = y.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    Linv = trsm_ops.solve_lx(L, eye, method=method)
    c = torch.clamp(torch.sum(Linv * Linv, dim=0), min=1e-30)
    var = 1.0 / c
    mu = y - alpha / c
    logp = -0.5 * torch.log(var) - 0.5 * c * (y - mu) ** 2 - 0.5 * LOG2PI
    return mu, var, logp


def loo_pseudo_likelihood(params, X, y, kind="rbf", jitter=1e-6,
                          method="auto"):
    """Sum of LOO predictive log-densities (GPML eq 5.11): the scalar,
    differentiable objective of map_opt.fit(objective="loo")."""
    _, _, logp = loo_cv(params, X, y, kind=kind, jitter=jitter,
                        method=method)
    return torch.sum(logp)


@torch.no_grad()
def lml_gradients_analytic(params, X, y, kind="rbf", jitter=1e-6,
                           method="auto"):
    """Analytic LML gradients: 1/2 tr((alpha alpha^T - K^{-1}) dK/dtheta).

    A cross-check of autograd (lml_value_and_grad), not a replacement.
    Cost: one Cholesky, an explicit K^{-1} (two n x n solves) and a few
    n x n elementwise passes per hyperparameter; periodic forms (n, n, d)
    tensors.
    """
    kernel_ops.require_base_kind(kind, "lml_gradients_analytic")
    L, alpha = _factorize(params, X, y, kind, jitter, method)
    n = X.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    Kinv = trsm_ops.cho_solve(L, eye, method=method)
    W = torch.outer(alpha, alpha) - Kinv
    del Kinv

    ell = torch.exp(params["log_lengthscale"])
    sf2 = torch.exp(params["log_signal_var"])
    sn2 = torch.exp(params["log_noise_var"])
    g_lsn = 0.5 * sn2 * torch.trace(W)

    if kind == "linear":
        # K = sf2 (X/ell)(X'/ell)^T + b: dK/dlog sf2 = K - b (+ jitter
        # diag), dK/dlog ell_k = -2 sf2 outer(x_k, x_k)/ell_k^2,
        # dK/dlog b = b J.
        Xs = X / ell
        out = {
            "log_signal_var": 0.5 * (sf2 * torch.sum(W * (Xs @ Xs.T))
                                     + jitter * sf2 * torch.trace(W)),
            "log_noise_var": g_lsn,
            "log_lengthscale": -sf2 * torch.sum(Xs * (W @ Xs), dim=0),
        }
        if "log_bias_var" in params:
            b = torch.exp(params["log_bias_var"])
            out["log_bias_var"] = 0.5 * b * torch.sum(W)
        return out

    if kind == "periodic":
        # K = sf2 exp(-2 sum_d sin^2(u_d)/ell_d^2), u_d = pi delta_d / p_d:
        # dK/dlog ell_d = K * 4 sin^2(u_d)/ell_d^2;
        # dK/dlog p_d = K * 2 u_d sin(2 u_d) / ell_d^2.
        p = torch.exp(params["log_period"])
        u = math.pi * (X[:, None, :] - X[None, :, :]) / p  # (n, n, d)
        s2u = torch.sin(u) ** 2
        Kf = sf2 * torch.exp(-2.0 * torch.sum(s2u / ell ** 2, dim=-1))
        g_lsf = 0.5 * (torch.sum(W * Kf) + jitter * sf2 * torch.trace(W))
        WK = W * Kf
        g_ell = torch.stack([
            0.5 * torch.sum(WK * (4.0 * s2u[..., k] / ell[k] ** 2))
            for k in range(ell.shape[0])])
        g_per = torch.stack([
            0.5 * torch.sum(WK * (2.0 * u[..., k] * torch.sin(2.0 * u[..., k])
                                  / ell[k] ** 2))
            for k in range(ell.shape[0])])
        return {"log_lengthscale": g_ell, "log_signal_var": g_lsf,
                "log_noise_var": g_lsn, "log_period": g_per}

    a = (torch.exp(params["log_alpha"])
         if kind == "rq" and "log_alpha" in params else None)
    # the expansion s1 + s2 - 2 cross need not round to 0 on the diagonal
    # (a CPU GEMM sums in another order than the norms), and matern12's
    # sqrt turns that into a visible error: d2_ii is 0 by definition
    d2 = kernel_ops.scaled_sqdist(X, X, ell).fill_diagonal_(0.0)
    Kf = sf2 * kernel_ops.kernel_fn(d2, kind, a)
    g_lsf = 0.5 * (torch.sum(W * Kf) + jitter * sf2 * torch.trace(W))

    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    g_lal = None
    if kind == "rbf":
        dk_dd2 = -0.5 * Kf
    elif kind == "rq":
        a = torch.ones_like(sf2) if a is None else a
        logb = torch.log1p(d2 / (2.0 * a))
        # k = sf2 (1 + d2/2a)^{-a}: dk/dd2 = -1/2 sf2 (1+d2/2a)^{-a-1};
        # dk/dlog a = k * a * (-log(1+d2/2a) + d2/(2a + d2))
        dk_dd2 = -0.5 * sf2 * torch.exp(-(a + 1.0) * logb)
        g_lal = 0.5 * torch.sum(W * (Kf * a * (-logb + d2 / (2.0 * a + d2))))
    elif kind == "matern12":
        dk_dd2 = sf2 * torch.exp(-r) * (-0.5 / r)
    elif kind == "matern32":
        dk_dd2 = sf2 * (-1.5) * torch.exp(-math.sqrt(3.0) * r)
    elif kind == "matern52":
        s5 = math.sqrt(5.0)
        dk_dd2 = sf2 * (-(5.0 / 6.0)) * (1.0 + s5 * r) * torch.exp(-s5 * r)
    else:
        raise ValueError(kind)

    # dK/dlog ell_k = dk/dd2 * (-2 (x_k - x'_k)^2 / ell_k^2), zero on the
    # r = 0 diagonal
    dk_dd2 = dk_dd2 * (1.0 - eye)
    g_ell = torch.stack([
        0.5 * torch.sum(W * (dk_dd2 * (-2.0 * (X[:, k, None] - X[None, :, k])
                                       ** 2 / ell[k] ** 2)))
        for k in range(X.shape[1])])
    out = {"log_lengthscale": g_ell, "log_signal_var": g_lsf,
           "log_noise_var": g_lsn}
    if g_lal is not None:
        out["log_alpha"] = g_lal
    return out
