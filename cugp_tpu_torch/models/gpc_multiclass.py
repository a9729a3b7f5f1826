"""Multiclass GP classification by the softmax Laplace approximation
(GPML Algorithms 3.3 / 3.4), as ``cugp_tpu/models/gpc_multiclass.py``.

Model: C classes, one latent function per class with a shared GP prior
f_c ~ N(0, K) (one kernel, one covariance build), softmax likelihood
p(y=c | f_i) = exp(f_ic) / sum_c' exp(f_ic').

The per-class factorizations L_c = chol(I + D_c^{1/2} K D_c^{1/2}) and
the per-class E_c are one batch over the class axis: one batched
Cholesky of (C, n, n) and one batched triangular solve (the potrf and
TRSM kernels' batched launches on CUDA), where the JAX package vmaps.
The fixed-length Newton ``lax.scan`` is a plain loop, with the
hyperparameter gradient by autograd through it.

With W = D - Pi Pi^T (GPML sec. 3.5),
  |I_{Cn} + W^{1/2} K W^{1/2}| = prod_c |L_c|^2 * |sum_c E_c|
so -1/2 log|B| = - sum_c sum_i log (L_c)_ii - sum_i log M_ii with
M = chol(sum_c E_c) and E_c = D_c^{1/2} B_c^{-1} D_c^{1/2}.

``predict_proba``'s Monte Carlo normals come from a CPU torch.Generator
(seeded 0 by default; the same numbers on every device) or are passed
in; JAX draws its own from key(0).
"""

from __future__ import annotations

import numpy as np
import torch

from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops

_M_JITTER = 1e-8  # sum_c E_c is SPD but can be tiny when pi saturates


def one_hot(y, num_classes, device="cpu"):
    return torch.nn.functional.one_hot(
        torch.as_tensor(y, dtype=torch.int64, device=device),
        num_classes).to(torch.float32)


def _class_factors(K, pi):
    """Batched per-class factorizations at the softmax probabilities pi
    (n, C). Returns (L, E, M): L[c] = chol(I + sw_c K sw_c), E[c] GPML's
    E_c, M = chol(sum_c E_c + jitter I)."""
    n = K.shape[0]
    sw = torch.sqrt(pi).T  # (C, n)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    B = eye[None] + sw[:, :, None] * K[None] * sw[:, None, :]
    L = chol_ops.cholesky(B)
    # E_c = (L_c^{-1} diag(sw_c))^T (L_c^{-1} diag(sw_c))
    A = trsm_ops.solve_lx(L, sw[:, :, None] * eye[None])
    E = A.mT @ A
    M = chol_ops.cholesky(torch.sum(E, dim=0) + _M_JITTER * eye)
    return L, E, M


def _laplace_mode(K, Y, num_newton=20):
    """Newton iterations for the softmax-Laplace mode (GPML Alg 3.3). Y is
    one-hot (n, C). Returns (f, a, obj) with f, a (n, C); obj =
    -1/2 sum(a*f) + log p(y|f)."""
    f = torch.zeros_like(Y)
    a = torch.zeros_like(Y)
    for _ in range(num_newton):
        pi = torch.softmax(f, dim=1)
        _L, E, M = _class_factors(K, pi)
        # b = W f + (y - pi); (W f)_i = diag(pi_i) f_i - pi_i (pi_i.f_i)
        b = pi * f - pi * torch.sum(pi * f, dim=1, keepdim=True) + Y - pi
        kb = K @ b                                      # (n, C)
        c = (E @ kb.T[:, :, None])[:, :, 0].T           # E_c K b_c
        s = trsm_ops.cho_solve(M, torch.sum(c, dim=1))  # R^T c
        a = b - c + (E @ s).T                           # + E R s
        f = K @ a
    obj = (-0.5 * torch.sum(a * f) + torch.sum(Y * f)
           - torch.sum(torch.logsumexp(f, dim=1)))
    return f, a, obj


def laplace_lml(params, X, Y, kind="rbf", jitter=1e-6, method="auto",
                num_newton=20):
    """Approximate multiclass log marginal likelihood (GPML eq. 3.44):
    -1/2 a^T f + y^T f - sum_i logsumexp(f_i) - sum_c sum_i log (L_c)_ii
    - sum_i log M_ii."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    f, _a, obj = _laplace_mode(K, Y, num_newton)
    L, _E, M = _class_factors(K, torch.softmax(f, dim=1))
    logdet_half = (torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)))
                   + torch.sum(torch.log(torch.diagonal(M))))
    return obj - logdet_half


def predict_proba(params, X, Y, Xs, kind="rbf", jitter=1e-6, method="auto",
                  num_newton=20, num_samples=512, generator=None,
                  normals=None):
    """Predictive class probabilities at Xs (GPML Alg 3.4).

    Latent predictive: mu*_c = k*^T (y_c - pi_c) and, per test point,
    Sigma*_{cc'} = delta_{cc'} (k** - k*^T E_c k*) + u_c^T u_{c'} with
    u_c = M^{-1} E_c k*. The softmax integral is a Monte Carlo mean over
    f* = mu* + chol(Sigma* + 1e-6 I) z with z the (num_samples, C)
    standard normals `normals`, else drawn from `generator` (a CPU
    generator seeded 0 when None). Returns (probs (m, C), mu (m, C),
    Sigma (m, C, C))."""
    K = kernel_ops.train_covariance(params, X, kind=kind, jitter=jitter,
                                    method=method)
    f, _a, _obj = _laplace_mode(K, Y, num_newton)
    pi = torch.softmax(f, dim=1)
    _L, E, M = _class_factors(K, pi)
    Ks = kernel_ops.cross_covariance(params, X, Xs, kind=kind,
                                     method=method)          # (n, m)
    n, m = Ks.shape
    C = Y.shape[1]
    mu = Ks.mT @ (Y - pi)                                    # (m, C)
    b = E @ Ks                                               # (C, n, m)
    q = torch.sum(Ks[None] * b, dim=1)                       # k* E_c k*
    # one solve against M for every class's columns
    U = trsm_ops.solve_lx(M, b.permute(1, 0, 2).reshape(n, C * m))
    U = U.reshape(n, C, m).permute(1, 0, 2)                  # (C, n, m)
    cross = torch.einsum("cim,dim->mcd", U, U)
    kss = kernel_ops.kernel_diag(params, Xs, kind)           # (m,)
    diag = torch.clamp(kss[None, :] - q, min=1e-10)          # (C, m)
    Sigma = cross + torch.diag_embed(diag.T)                 # (m, C, C)

    eyeC = torch.eye(C, dtype=Sigma.dtype, device=Sigma.device)
    Ls = chol_ops.cholesky(Sigma + 1e-6 * eyeC[None])
    if normals is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        z = torch.randn((num_samples, C), generator=generator,
                        device=generator.device)
    else:
        z = (normals.to(torch.float32) if isinstance(normals, torch.Tensor)
             else torch.tensor(np.asarray(normals), dtype=torch.float32))
        if tuple(z.shape) != (num_samples, C):
            raise ValueError(f"normals must be ({num_samples}, {C}), got "
                             f"{tuple(z.shape)}")
    z = z.to(Sigma.device)
    fs = mu[:, None, :] + torch.einsum("mcd,sd->msc", Ls, z)  # (m, S, C)
    probs = torch.mean(torch.softmax(fs, dim=-1), dim=1)
    return probs, mu, Sigma


def fit(init_params, X, Y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=100, learning_rate=0.05, num_newton=20):
    """MAP hyperparameters by maximizing the Laplace marginal: Adam under
    optax.apply_if_finite's rule with 100 as its count."""
    params, losses = map_opt.adam_fit(
        init_params,
        lambda p, _step: -laplace_lml(p, X, Y, kind=kind, jitter=jitter,
                                      method=method, num_newton=num_newton),
        steps=steps, learning_rate=learning_rate,
        max_consecutive_errors=100)
    return params, {"loss": losses, "lml": -losses[-1]}
