"""Stochastic variational GP (SVGP), as ``cugp_tpu/models/svgp.py``.

Hensman et al. 2013 / 2015: an uncollapsed inducing-point bound whose
per-step cost is O(b m^2) for a minibatch of b points, so
hyperparameters, inducing locations and the variational posterior all
train by SGD, and the likelihood need not be Gaussian.

Whitened parameterization: with L = chol(K_mm), the inducing outputs are
u = L v and q(v) = N(m, C C^T), C lower-triangular (log-diagonal
storage). For a batch B with A = L^{-1} K_{m,B}:

  q(f_B) = N(A^T m,  diag[k_BB - A^T A + (C^T A)^T (C^T A)])
  ELBO   = (n/b) sum_{i in B} E_{q(f_i)} log p(y_i | f_i)  -  KL(q || N(0,I))
  KL     = (||m||^2 + ||C||_F^2 - M)/2 - sum log diag C

Expected log-likelihoods: gaussian and poisson in closed form, bernoulli
(y in {-1,+1}, logistic) and student_t by Gauss-Hermite quadrature
(GH_POINTS nodes). For the Gaussian likelihood the optimal q(v) is in
closed form (``optimal_variational``), at which the bound collapses to
models/sgpr.elbo.

Every covariance, Cholesky and triangular solve goes through the port's
ops (the covariance, potrf and TRSM kernels on CUDA). The JAX package's
S = inv(B) in ``optimal_variational`` is B's Cholesky factor and two
triangular solves against I here, and m = S A y / sn2 is two triangular
solves against A y rather than S times A y (at n=131,072, m=512 the
product with the fp32 inverse costs the collapsed bound 6.8e-4 of
itself, the solves 1.9e-5). The fit's minibatch indices are a
NumPy shuffle (as the JAX package's, bit for bit), or draws from a CPU
torch.Generator (the same on every device; JAX draws its own with
jax.random), or an explicit schedule.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.models import exact_gp, sgpr
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops

LOG2PI = math.log(2.0 * math.pi)

GH_POINTS = 20
_gh_x, _gh_w = np.polynomial.hermite.hermgauss(GH_POINTS)
_GH_X = torch.as_tensor(_gh_x, dtype=torch.float32)  # nodes of int e^{-x^2}
_GH_W = torch.as_tensor(_gh_w / math.sqrt(math.pi), dtype=torch.float32)

LIKELIHOODS = ("gaussian", "bernoulli", "poisson", "student_t")

# student_t degrees of freedom default; fit() adds a learnable "log_nu"
STUDENT_T_NU = 4.0

# K_mm jitter floor, relative to the signal variance (the JAX package's:
# the whitened parameterization stores q in L-coordinates, so an
# ill-conditioned fp32 chol(K_mm) turns small hyperparameter steps into
# large swings of u = L v)
KMM_JITTER_FLOOR = 1e-4

# Above this n, optimal_variational streams K_mn in column chunks: only
# A A^T (m, m) and A y (m,) are held, never the (m, n) matrix
_WARMSTART_CHUNK = 8192


def student_t_nu(params):
    """nu from params (learnable log_nu) or the static default."""
    if isinstance(params, dict) and "log_nu" in params:
        return torch.exp(params["log_nu"])
    return torch.tensor(STUDENT_T_NU)


def chol_from_flat(flat, dim):
    """Lower-triangular C: log-diag in flat[:dim], the strict lower
    triangle after it in row-major order (as jnp.tril_indices)."""
    rows, cols = torch.tril_indices(dim, dim, offset=-1, device=flat.device)
    C = torch.zeros((dim, dim), dtype=flat.dtype, device=flat.device)
    C = C.index_put((rows, cols), flat[dim:])
    return C + torch.diag(torch.exp(flat[:dim]))


def flat_from_chol(C):
    dim = C.shape[0]
    rows, cols = torch.tril_indices(dim, dim, offset=-1, device=C.device)
    return torch.cat([torch.log(torch.diagonal(C)), C[rows, cols]])


def init_variational(num_inducing, device="cpu"):
    """q(v) = N(0, I): the whitened prior (the ELBO starts at KL = 0)."""
    m = num_inducing
    return {"m": torch.zeros((m,), device=device),
            "c": torch.zeros(((m * (m + 1)) // 2,), device=device)}


def _kmm_chol(params, Z, kind, jitter, kmm_jitter=None):
    if kmm_jitter is None:
        kmm_jitter = KMM_JITTER_FLOOR
    mm = Z.shape[0]
    sf2 = kernel_ops.signal_scale(params)
    Kmm = kernel_ops.cross_covariance(params, Z, Z, kind)
    Kmm = Kmm + (jitter + kmm_jitter) * sf2 * torch.eye(
        mm, dtype=Kmm.dtype, device=Kmm.device)
    return exact_gp.safe_cholesky(Kmm, sf2, max_attempts=3, jitter0=1e-4)


def _qf(params, Z, vp, Xb, kind, jitter, kmm_jitter=None):
    """Marginal q(f) mean/variance at the batch inputs."""
    mm = Z.shape[0]
    L = _kmm_chol(params, Z, kind, jitter, kmm_jitter)
    Kmb = kernel_ops.cross_covariance(params, Z, Xb, kind)
    A = trsm_ops.solve_lx(L, Kmb)
    C = chol_from_flat(vp["c"], mm)
    CtA = C.mT @ A
    mu = A.mT @ vp["m"]
    kbb = kernel_ops.kernel_diag(params, Xb, kind)
    var = kbb - torch.sum(A * A, dim=0) + torch.sum(CtA * CtA, dim=0)
    return mu, torch.clamp(var, min=1e-10)


def _gh_nodes(mu, var):
    """f at the Gauss-Hermite nodes (b, GH_POINTS) and the weights."""
    x, w = _GH_X.to(mu.device), _GH_W.to(mu.device)
    return mu[:, None] + torch.sqrt(2.0 * var)[:, None] * x[None, :], w


def expected_loglik(y, mu, var, likelihood, sn2=None, nu=None):
    """E_{f ~ N(mu, var)} [log p(y | f)], elementwise over the batch."""
    if likelihood == "gaussian":
        r = y - mu
        return -0.5 * (LOG2PI + torch.log(sn2)) - (r * r + var) / (2.0 * sn2)
    if likelihood == "bernoulli":
        # y in {-1,+1}; log sigmoid(y f) integrated by GH quadrature
        f, w = _gh_nodes(mu, var)
        return torch.sum(w[None, :] * F.logsigmoid(y[:, None] * f), dim=1)
    if likelihood == "poisson":
        # log link: E[e^f] = exp(mu + var/2) under q(f), closed form
        return y * mu - torch.exp(mu + 0.5 * var) - torch.lgamma(y + 1.0)
    if likelihood == "student_t":
        nu = torch.tensor(STUDENT_T_NU, device=mu.device) if nu is None \
            else nu
        const = (torch.lgamma((nu + 1.0) / 2.0) - torch.lgamma(nu / 2.0)
                 - 0.5 * torch.log(nu * math.pi * sn2))
        f, w = _gh_nodes(mu, var)
        r2 = (y[:, None] - f) ** 2
        logp = const - 0.5 * (nu + 1.0) * torch.log1p(r2 / (nu * sn2))
        return torch.sum(w[None, :] * logp, dim=1)
    raise ValueError(f"unknown likelihood: {likelihood}")


def kl_whitened(vp):
    """KL( N(m, CC^T) || N(0, I) )."""
    mm = vp["m"].shape[0]
    C = chol_from_flat(vp["c"], mm)
    logdet = 2.0 * torch.sum(vp["c"][:mm])
    return 0.5 * (torch.sum(vp["m"] ** 2) + torch.sum(C * C) - mm - logdet)


def elbo(params, Z, vp, X, y, kind="rbf", jitter=1e-6,
         likelihood="gaussian", scale=1.0, kmm_jitter=None):
    """SVGP bound on a batch; `scale` = n_total / batch for minibatches.
    With likelihood='gaussian', scale=1 and vp = optimal_variational(...)
    it equals models/sgpr.elbo at the same K_mm jitter."""
    mu, var = _qf(params, Z, vp, X, kind, jitter, kmm_jitter)
    sn2 = (torch.exp(params["log_noise_var"])
           if likelihood in ("gaussian", "student_t") else None)
    nu = student_t_nu(params) if likelihood == "student_t" else None
    ell = torch.sum(expected_loglik(y, mu, var, likelihood, sn2, nu))
    return scale * ell - kl_whitened(vp)


def optimal_variational(params, Z, X, y, kind="rbf", jitter=1e-6,
                        kmm_jitter=None):
    """Closed-form optimal whitened q(v) for the Gaussian likelihood:
    S = B^{-1}, B = I + A A^T / sn2, m = S A y / sn2. For n >
    _WARMSTART_CHUNK A A^T and A y accumulate over column chunks of K_mn.
    S and m come from B's Cholesky factor: two triangular solves against
    I and against A y."""
    mm = Z.shape[0]
    n = X.shape[0]
    sn2 = torch.exp(params["log_noise_var"])
    L = _kmm_chol(params, Z, kind, jitter, kmm_jitter)
    AAt = torch.zeros((mm, mm), dtype=torch.float32, device=X.device)
    Ay = torch.zeros((mm,), dtype=torch.float32, device=X.device)
    for lo in range(0, n, _WARMSTART_CHUNK):
        Kmc = kernel_ops.cross_covariance(
            params, Z, X[lo:lo + _WARMSTART_CHUNK], kind)
        Ac = trsm_ops.solve_lx(L, Kmc)
        AAt = AAt + Ac @ Ac.mT
        Ay = Ay + Ac @ y[lo:lo + _WARMSTART_CHUNK]
    eye = torch.eye(mm, dtype=AAt.dtype, device=AAt.device)
    LB = chol_ops.cholesky(eye + AAt / sn2)
    S = trsm_ops.cho_solve(LB, eye)
    S = 0.5 * (S + S.mT) + 1e-8 * eye
    m = trsm_ops.cho_solve(LB, Ay) / sn2
    return {"m": m, "c": flat_from_chol(chol_ops.cholesky(S))}


def posterior(params, Z, vp, Xs, kind="rbf", jitter=1e-6,
              include_noise=False, likelihood="gaussian", kmm_jitter=None):
    """Predictive q(f*) mean/variance at Xs. include_noise adds the
    observation variance: sn2 for gaussian, nu/(nu-2) sn2 for student_t
    (nu clamped above 2); other likelihoods raise (predict_rate,
    predict_proba)."""
    if include_noise and likelihood not in ("gaussian", "student_t"):
        raise ValueError(
            f"include_noise is undefined for likelihood={likelihood!r}; "
            "use predict_rate (poisson) or predict_proba (bernoulli)")
    mu, var = _qf(params, Z, vp, Xs, kind, jitter, kmm_jitter)
    if include_noise:
        sn2 = torch.exp(params["log_noise_var"])
        if likelihood == "student_t":
            nu = student_t_nu(params)
            sn2 = sn2 * nu / torch.clamp(nu - 2.0, min=1e-3)
        var = var + sn2
    return mu, var


def predict_rate(params, Z, vp, Xs, kind="rbf", jitter=1e-6):
    """Poisson predictive rate: mean and variance of e^f under q(f)."""
    mu, var = _qf(params, Z, vp, Xs, kind, jitter)
    rate = torch.exp(mu + 0.5 * var)
    rate_var = torch.exp(2.0 * mu + var) * (torch.exp(var) - 1.0)
    return rate, rate_var


def predict_proba(params, Z, vp, Xs, kind="rbf", jitter=1e-6):
    """p(y=+1 | x*) for the bernoulli likelihood (MacKay's probit
    approximation, as models/gpc.predict_proba). Returns (p, mu, var)."""
    mu, var = _qf(params, Z, vp, Xs, kind, jitter)
    kappa = 1.0 / torch.sqrt(1.0 + (math.pi / 8.0) * var)
    return torch.sigmoid(kappa * mu), mu, var


def shuffle_schedule(n, steps, batch, seed):
    """batch_sampling="shuffle": cycled shuffled epochs from NumPy's
    default_rng(seed), (steps, batch) int64, the JAX package's bits."""
    rng = np.random.default_rng(seed)
    need = steps * batch
    order = np.concatenate([rng.permutation(n)
                            for _ in range(-(-need // n))])[:need]
    return torch.as_tensor(order.reshape(steps, batch), dtype=torch.int64)


def fit(init_params, X, y, *, num_inducing=512, Z=None, kind="rbf",
        jitter=1e-6, likelihood="gaussian", steps=2000, batch=256,
        learning_rate=0.01, optimize_inducing=True, warm_start=True,
        seed=0, generator=None, grad_clip=100.0, kmm_jitter=None,
        batch_sampling="replacement", idx_schedule=None):
    """SGD on the SVGP bound over (hyperparameters, inducing locations,
    q(v)): Adam after a global-norm clip at grad_clip, under
    optax.apply_if_finite's rule with 1000 as its count.

    warm_start: for the Gaussian likelihood, q(v) starts at its closed-
    form optimum at the initial hyperparameters (else the whitened
    prior). batch_sampling: "replacement" (uniform indices from
    `generator`, a CPU generator seeded `seed` when None) or "shuffle"
    (cycled shuffled epochs, shuffle_schedule). idx_schedule: an explicit
    (steps, batch) index tensor, used as given. Returns (params, Z, vp,
    info) with info "loss" and "elbo_batch_final"."""
    if likelihood not in LIKELIHOODS:
        raise ValueError(f"unknown likelihood: {likelihood}; "
                         f"supported: {LIKELIHOODS}")
    if likelihood == "student_t" and "log_nu" not in init_params:
        init_params = dict(init_params)
        init_params["log_nu"] = torch.tensor(
            math.log(STUDENT_T_NU), dtype=torch.float32, device=X.device)
    n = X.shape[0]
    batch = min(batch, n)
    if Z is None:
        Z = sgpr.init_inducing(X, num_inducing, seed=seed)
    mm = Z.shape[0]
    if warm_start and likelihood == "gaussian":
        with torch.no_grad():
            vp = optimal_variational(init_params, Z, X, y, kind=kind,
                                     jitter=jitter, kmm_jitter=kmm_jitter)
    else:
        vp = init_variational(mm, device=X.device)
    if idx_schedule is None:
        if batch_sampling == "shuffle":
            idx_schedule = shuffle_schedule(n, steps, batch, seed)
        elif batch_sampling == "replacement":
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            idx_schedule = torch.randint(0, n, (steps, batch),
                                         generator=generator,
                                         device=generator.device)
        else:
            raise ValueError(f"unknown batch_sampling: {batch_sampling!r}")
    idx_schedule = torch.as_tensor(idx_schedule, dtype=torch.int64,
                                   device=X.device)
    if tuple(idx_schedule.shape) != (steps, batch):
        raise ValueError(f"idx_schedule must be ({steps}, {batch}), got "
                         f"{tuple(idx_schedule.shape)}")
    trainables = {"params": init_params, "m": vp["m"], "c": vp["c"]}
    if optimize_inducing:
        trainables["Z"] = Z
    scale = n / batch

    def loss_fn(tr, step):
        idx = idx_schedule[step]
        z = tr["Z"] if optimize_inducing else Z
        return -elbo(tr["params"], z, {"m": tr["m"], "c": tr["c"]}, X[idx],
                     y[idx], kind=kind, jitter=jitter, likelihood=likelihood,
                     scale=scale, kmm_jitter=kmm_jitter)

    # the clip keeps one minibatch whose gradient spikes through L^{-1}
    # (K_mm conditioning degrading mid-trajectory) from ejecting q
    tr, losses = map_opt.adam_fit(
        trainables, loss_fn, steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=1000, grad_clip=grad_clip)
    z_out = tr["Z"] if optimize_inducing else Z
    return tr["params"], z_out, {"m": tr["m"], "c": tr["c"]}, {
        "loss": losses, "elbo_batch_final": -losses[-1]}
