"""LMC / intrinsic-coregionalization multi-output GP, as
``cugp_tpu/models/lmc.py``.

ICM model: p outputs with joint prior covariance B (x) K(X,X) + sn2 I_{pn},
where B = A A^T + diag(softplus(raw_d)) is a learnable low-rank-plus-
diagonal p x p coregionalization matrix and K is any base/composite
kernel. With the eigendecomposition B = V diag(lam) V^T,

    B (x) K + sn2 I = (V (x) I) (diag(lam) (x) K + sn2 I) (V^T (x) I),

so rotating the outputs Y' = Y V decouples the problem into p single-
output GPs with covariances lam_j K + sn2 I: one covariance build and
ONE batched Cholesky of shape (p, n, n) (potrf's cooperative route for
p < 9, its batch route from 9 up), where the JAX package vmaps XLA's
Cholesky. The solves are one batched TRSM recursion each.

Rank-Q LMC: sum_q (a_q a_q^T) (x) K_q with a distinct unit-amplitude
kernel per latent. No common rotation diagonalizes it, so the dense path
builds the joint (pn, pn) covariance one (a, b) output block at a time
into one preallocated tensor and factors it with ``ops.cholesky``; the
matrix-free path runs CG/SLQ on the joint operator, one kernel matvec
per latent per product (the fused matvec kernel for a base family; JAX
runs the blocked XLA route there).

Every covariance is ``ops.kernels.cross_covariance`` (the covariance
kernel on CUDA), every Cholesky ``ops.cholesky`` (the potrf kernel at
the base) and every triangular solve ``ops.trsm`` (the TRSM kernel at
the base). Output-major vec layout throughout: row a*n + i is output a,
input i.

Random initial mixing factors come from a CPU ``torch.Generator`` seeded
``seed`` (so the same numbers on every device); they are not the JAX
package's ``jax.random.normal(key(seed))`` draws, which torch cannot
redraw: pass JAX's init explicitly to reproduce a JAX fit. The iterative
LML takes its probes ``Z`` (or a ``generator``) in place of JAX's
``key``. The matrix-free posterior's ``segment_iters`` runs CG on the
joint operator in segments (``iterative.run_cg_segments``, one host
read a segment), as the JAX package's schedule does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cugp_tpu_torch.inference import iterative, map_opt
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.utils.params import tree_leaves

LOG2PI = math.log(2.0 * math.pi)

# the latent operators' log noise: exp(-60) ~ 8.8e-27 is below fp32's
# resolution of any covariance entry (an exactly-zero noise would need a
# separate code path), as in the JAX package
_LATENT_LOG_NOISE = -60.0


def _normal(shape, seed, device):
    """Standard normals from a CPU generator seeded `seed`, on device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).to(device)


def init_lmc_params(d, p, q=1, lengthscale=1.0, signal_var=1.0,
                    noise_var=0.1, seed=0, device="cpu"):
    """Kernel params + coregionalization factors.

    lmc_A: (p, q) mixing factors, lmc_raw_d: (p,) softplus-parameterized
    output diagonal; B = A A^T + diag(softplus(raw_d)).
    """
    params = kernel_ops.init_params(d=d, lengthscale=lengthscale,
                                    signal_var=signal_var,
                                    noise_var=noise_var, device=device)
    # small asymmetric init: distinct generic eigenvalues for eigh's VJP
    params["lmc_A"] = 0.5 * _normal((p, q), seed, device)
    params["lmc_raw_d"] = torch.full((p,), -1.0, dtype=torch.float32,
                                     device=device)
    return params


def coregionalization(params):
    """B = A A^T + diag(softplus(raw_d)): SPD by construction."""
    A = params["lmc_A"]
    d = F.softplus(params["lmc_raw_d"]) + 1e-6
    return A @ A.mT + torch.diag(d)


def _rotated_factorizations(params, X, kind, jitter, method):
    """eig(B), one K build, one (p, n, n) batched Cholesky.

    Returns (lam (p,), V (p, p), Ls (p, n, n)) with Ls[j] = chol(lam_j Kf
    + (sn2 + jitter sf2 lam_j) I); Kf is the NOISE-FREE kernel.
    """
    lam, V = torch.linalg.eigh(coregionalization(params))
    lam = torch.clamp(lam, min=1e-8)
    Kf = kernel_ops.cross_covariance(params, X, X, kind, method=method)
    sf2 = kernel_ops.signal_scale(params)
    sn2 = torch.exp(params["log_noise_var"])
    Kj = lam[:, None, None] * Kf
    Kj.diagonal(dim1=-2, dim2=-1).add_((sn2 + jitter * sf2 * lam)[:, None])
    return lam, V, chol_ops.cholesky(Kj, method=method)


def log_marginal_likelihood_lmc(params, X, Y, kind="rbf", jitter=1e-6,
                                method="auto"):
    """Exact LML of the ICM model, O(p n^3) via the rotation identity:

    log N(vec(Y) | 0, B (x) K + sn2 I)
      = sum_j [ -1/2 y'_j^T (lam_j K + sn2 I)^{-1} y'_j
                - log det^(1/2) - n/2 log 2pi ],   Y' = Y V.
    """
    _, V, Ls = _rotated_factorizations(params, X, kind, jitter, method)
    Yr = (Y @ V).mT                                        # (p, n)
    alpha = trsm_ops.cho_solve(Ls, Yr, method=method)      # (p, n)
    logdet_half = torch.sum(torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1)))
    n, p = Y.shape
    return (-0.5 * torch.sum(Yr * alpha) - logdet_half
            - 0.5 * n * p * LOG2PI)


def posterior_lmc(params, X, Y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  include_noise=False, full_output_cov=False):
    """Posterior mean and variance of all p outputs at Xs.

    Rotated space: mean'_j = lam_j Ks^T (lam_j K + sn2 I)^{-1} y'_j,
    var'_j = lam_j kss - lam_j^2 || L_j^{-1} Ks ||^2. Back-rotation:
    mu = mu' V^T; per-point output covariance Sigma(x) = V diag(var'(x))
    V^T, returned in full when full_output_cov=True ((m, p, p)), else its
    diagonal ((m, p)).
    """
    lam, V, Ls = _rotated_factorizations(params, X, kind, jitter, method)
    p = V.shape[0]
    Yr = (Y @ V).mT                                        # (p, n)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind, method=method)
    kss = kernel_ops.kernel_diag(params, Xs, kind)         # (m,)
    alpha = trsm_ops.cho_solve(Ls, Yr, method=method)      # (p, n)
    mus = lam[:, None] * (alpha @ Ks)                      # (p, m)
    v = trsm_ops.solve_lx(Ls, Ks.expand(p, -1, -1), method=method)
    vars_ = torch.clamp(lam[:, None] * kss
                        - lam[:, None] ** 2 * torch.sum(v * v, dim=1),
                        min=0.0)                           # (p, m)
    mean = mus.mT @ V.mT                                   # (m, p)
    sn2 = torch.exp(params["log_noise_var"])
    if full_output_cov:
        cov = torch.einsum("ab,mb,cb->mac", V, vars_.mT, V)
        if include_noise:
            cov = cov + sn2 * torch.eye(p, dtype=cov.dtype,
                                        device=cov.device)
        return mean, cov
    var = vars_.mT @ (V ** 2).mT
    if include_noise:
        var = var + sn2
    return mean, var


def fit(init_params, X, Y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=200, learning_rate=0.05):
    """MAP fit of kernel + coregionalization params: Adam under
    optax.apply_if_finite's rule with 100 as its count
    (map_opt.adam_fit). lmc_A / lmc_raw_d are unconstrained (B stays SPD
    by construction); the log-space leaves are box-clamped. Returns
    (params, {"loss": (steps,), "lml": -loss[-1]})."""
    def loss_fn(p, _step):
        return -log_marginal_likelihood_lmc(p, X, Y, kind=kind,
                                            jitter=jitter, method=method)

    params, losses = map_opt.adam_fit(
        init_params, loss_fn, steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=100)
    return params, {"loss": losses, "lml": -losses[-1]}


# ---- rank-Q LMC: sum_q B_q (x) K_q with DISTINCT latent kernels ----
# Rank-1 coregionalization per latent (B_q = a_q a_q^T, the
# semiparametric-latent-factor form); latent kernels carry UNIT
# amplitude: a_q holds the scale.


def init_lmcq_params(d, p, kinds, lengthscale=1.0, noise_var=0.1, seed=0,
                     device="cpu"):
    """Params for the rank-Q LMC: one unit-amplitude kernel param dict
    per latent (kinds[q] sets its family) + mixing vectors a_q.

    Returns {"log_noise_var", "lmc_a": (Q, p), "latents": [fp_q, ...]}
    where each fp_q has log_lengthscale (+ family extras), NO
    log_signal_var / log_noise_var.
    """
    latents = []
    for kind in kinds:
        fp = kernel_ops.default_init(kind, d=d, lengthscale=lengthscale,
                                     device=device)
        fp.pop("log_signal_var", None)
        fp.pop("log_noise_var", None)
        latents.append(fp)
    # distinct non-degenerate init so latents specialize during fitting
    a0 = 1.0 + 0.3 * _normal((len(kinds), p), seed, device)
    return {"log_noise_var": torch.tensor(math.log(noise_var),
                                          dtype=torch.float32, device=device),
            "lmc_a": a0, "latents": latents}


def _latent_unit_params(fp):
    out = dict(fp)
    out["log_signal_var"] = torch.zeros((), dtype=torch.float32,
                                        device=tree_leaves(fp)[0].device)
    return out


def lmcq_covariance(params, X1, X2, kinds):
    """(p*n1, p*n2) joint cross-covariance sum_q (a_q a_q^T) (x) K_q,
    output-major (row a*n1 + i <-> output a, input i). Each latent's
    n1 x n2 tile is one covariance build; output block (a, b) is the
    tiles' combination with weights a_q[a] a_q[b], written one block at a
    time into one preallocated tensor (no (Q, p, n1, p, n2)
    intermediate)."""
    A = params["lmc_a"]                                    # (Q, p)
    Q, p = A.shape
    n1, n2 = X1.shape[0], X2.shape[0]
    Kq = torch.empty((Q, n1, n2), dtype=torch.float32, device=X1.device)
    for q, (fp, kind) in enumerate(zip(params["latents"], kinds)):
        Kq[q] = kernel_ops.cross_covariance(_latent_unit_params(fp), X1, X2,
                                            kind)
    S = torch.empty((p * n1, p * n2), dtype=torch.float32, device=X1.device)
    for a in range(p):
        for b in range(p):
            w = A[:, a] * A[:, b]
            blk = w[0] * Kq[0]
            for q in range(1, Q):
                blk = torch.addcmul(blk, Kq[q], w[q])
            S[a * n1:(a + 1) * n1, b * n2:(b + 1) * n2] = blk
    return S


def _lmcq_diag_add(params, jitter):
    """sn2 + jitter * max_a sum_q a_qa^2: the jitter scales with the
    largest output's total prior variance."""
    scale = torch.max(torch.sum(params["lmc_a"] ** 2, dim=0))
    return torch.exp(params["log_noise_var"]) + jitter * scale


def _lmcq_chol(params, X, kinds, jitter):
    S = lmcq_covariance(params, X, X, kinds)
    S.diagonal().add_(_lmcq_diag_add(params, jitter))
    return chol_ops.cholesky(S)


def log_marginal_likelihood_lmcq(params, X, Y, kinds, jitter=1e-6):
    """Exact LML of the rank-Q LMC: log N(vec(Y^T) | 0, Sigma)."""
    n, p = Y.shape
    L = _lmcq_chol(params, X, kinds, jitter)
    yv = Y.mT.reshape(-1)                                  # output-major
    alpha = trsm_ops.cho_solve(L, yv)
    return (-0.5 * torch.dot(yv, alpha)
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * p * LOG2PI)


def _latent_prior_var(params, Xs, kinds):
    """Prior variance of output b at xs: sum_q a_qb^2 k_q(xs, xs), (m, p)."""
    diags = torch.stack([
        kernel_ops.kernel_diag(_latent_unit_params(fp), Xs, kind)
        for fp, kind in zip(params["latents"], kinds)])    # (Q, m)
    return diags.mT @ params["lmc_a"] ** 2


def posterior_lmcq(params, X, Y, Xs, kinds, jitter=1e-6,
                   include_noise=False):
    """Posterior mean (m, p) and per-output variance (m, p) at Xs."""
    p, m = Y.shape[1], Xs.shape[0]
    L = _lmcq_chol(params, X, kinds, jitter)
    alpha = trsm_ops.cho_solve(L, Y.mT.reshape(-1))
    Kcross = lmcq_covariance(params, X, Xs, kinds)         # (pn, pm)
    mu = (Kcross.mT @ alpha).reshape(p, m).mT              # (m, p)
    v = trsm_ops.solve_lx(L, Kcross)                       # (pn, pm)
    var = (_latent_prior_var(params, Xs, kinds)
           - torch.sum(v * v, dim=0).reshape(p, m).mT)
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    return mu, torch.clamp(var, min=0.0)


def fit_lmcq(init_params, X, Y, *, kinds, jitter=1e-6, steps=200,
             learning_rate=0.05):
    """MAP fit of the rank-Q LMC on the dense LML (as fit() above: Adam
    under apply_if_finite's count of 100; lmc_a unconstrained, the
    log-space leaves box-clamped)."""
    def loss_fn(p, _step):
        return -log_marginal_likelihood_lmcq(p, X, Y, kinds, jitter=jitter)

    params, losses = map_opt.adam_fit(
        init_params, loss_fn, steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=100)
    return params, {"loss": losses, "lml": -losses[-1]}


# ---- matrix-free rank-Q LMC ----
# The joint operator Sigma = sum_q (a_q a_q^T) (x) K_q + diag_add I has a
# matvec that is Q kernel matvecs on mixed vectors:
#   (Sigma v)[a,:] = sum_q a_q[a] * K_q (sum_b a_q[b] v[b,:]) + diag_add v[a,:]
# so CG + SLQ take the rank-Q model to the n of the single-output
# iterative tier. Layout matches _lmcq_chol.


def make_lmcq_matvec(params, X, kinds, jitter=1e-6, block=4096):
    """v (pn,) or (pn, r) -> Sigma v without forming Sigma.

    Each latent contributes one kernel matvec
    (``iterative.make_matvec`` on a copy of its unit-amplitude params
    with the -60 log-noise, never a leaf the fit's clamp sees): the fused
    route (the matvec kernel) for a base family, the blocked route (the
    JAX package's "xla") for a composite. The fused route has no
    gradient.
    """
    A = params["lmc_a"]                                    # (Q, p)
    Q, p = A.shape
    n = X.shape[0]
    diag_add = _lmcq_diag_add(params, jitter)
    mvs = []
    for fp, kind in zip(params["latents"], kinds):
        lp = _latent_unit_params(fp)
        lp["log_noise_var"] = torch.full_like(lp["log_signal_var"],
                                              _LATENT_LOG_NOISE)
        mvs.append(iterative.make_matvec(lp, X, kind=kind, jitter=0.0,
                                         block=block))

    def matvec(v):
        vec = v.ndim == 1
        V = (v[:, None] if vec else v).reshape(p, n, -1)   # (p, n, r)
        out = diag_add * V
        for q in range(Q):
            u = mvs[q](torch.einsum("a,anr->nr", A[q], V))  # (n, r)
            out = out + A[q][:, None, None] * u
        out = out.reshape(p * n, -1)
        return out[:, 0] if vec else out

    return matvec


def log_marginal_likelihood_lmcq_iterative(
        params, X, Y, kinds, Z=None, generator=None, jitter=1e-6,
        block=4096, tol=1e-5, max_iters=1000, num_probes=16, num_steps=32):
    """Matrix-free LML of the rank-Q LMC: CG on the joint operator for
    the quadratic term + SLQ for the logdet, Sigma (pn x pn) never
    formed. Z: the (pn, num_probes) Rademacher probes, drawn from
    `generator` (a CPU generator seeded 0 by default) when not given.
    Matches log_marginal_likelihood_lmcq at small n to SLQ MC error."""
    n, p = Y.shape
    mv = make_lmcq_matvec(params, X, kinds, jitter=jitter, block=block)
    yv = Y.mT.reshape(-1)
    alpha, _ = iterative.cg_solve(mv, yv, tol=tol, max_iters=max_iters)
    logdet = iterative.slq_logdet(mv, p * n, Z=Z, num_probes=num_probes,
                                  num_steps=num_steps, generator=generator,
                                  device=X.device)
    return (-0.5 * torch.dot(yv, alpha) - 0.5 * logdet
            - 0.5 * n * p * LOG2PI)


@torch.no_grad()
def posterior_lmcq_iterative(params, X, Y, Xs, kinds, jitter=1e-6,
                             block=4096, tol=1e-6, max_iters=1000,
                             include_noise=False, col_batch=256,
                             segment_iters=0, stats=None):
    """Matrix-free posterior of the rank-Q LMC: mean (m, p) and
    per-output variance (m, p), Sigma never formed, everything on X's
    device.

    Test points stream in `col_batch` chunks; per chunk the p*mc cross
    columns (lmcq_covariance) give the mean C^T alpha and are solved with
    batched CG on the joint operator for the variance. segment_iters:
    k > 0 runs every solve in segments (iterative.run_cg_segments): the mean
    solve's of k iterations, a chunk's of max(1, 16 k // max(16, p mc)),
    as the JAX package scales them; "auto" or 0: one tolerance loop a
    solve. stats: optional dict that receives the mean solve's "alpha"
    and the CG counts "mean_iters" / "var_iters".
    """
    seg = map_opt.resolve_iterative_schedule(segment_iters)[0]
    A = params["lmc_a"]
    n, p = X.shape[0], A.shape[1]
    mv = make_lmcq_matvec(params, X, kinds, jitter=jitter, block=block)

    def solve(b, iters_per_program):
        if seg:
            x, it, _rel = iterative.run_cg_segments(
                mv, b, tol=tol, iters_per_program=iters_per_program,
                max_iters=max_iters)
            return x, it
        return iterative.cg_solve(mv, b, tol=tol, max_iters=max_iters)

    alpha, it_mean = solve(Y.mT.reshape(-1), seg)
    mus, quads, it_var = [], [], []
    for j0 in range(0, Xs.shape[0], col_batch):
        Xs_c = Xs[j0:j0 + col_batch]
        mc = Xs_c.shape[0]
        C = lmcq_covariance(params, X, Xs_c, kinds)        # (pn, p mc)
        mus.append((C.mT @ alpha).reshape(p, mc).mT)
        W, it = solve(C, max(1, (seg * 16) // max(16, p * mc)))
        quads.append(torch.sum(C * W, dim=0).reshape(p, mc).mT)
        it_var.append(it)
    var = _latent_prior_var(params, Xs, kinds) - torch.cat(quads)
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    if stats is not None:
        stats.update(alpha=alpha, mean_iters=it_mean, var_iters=it_var)
    return torch.cat(mus), torch.clamp(var, min=0.0)
