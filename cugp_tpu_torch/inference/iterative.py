"""Matrix-free (CG/Lanczos) exact-GP inference, as the JAX package's
``cugp_tpu/inference/iterative.py``.

The covariance is never materialized: posterior solves run batched
conjugate gradients against a covariance matvec, and the log-determinant
is estimated by stochastic Lanczos quadrature (the BBMM recipe, PAPERS.md).
Memory is O(n r) for the solves instead of the dense path's O(n^2), so this
tier runs N = 100,000 on one H100, where K alone would be 40 GB.

Two matvec routes (``make_matvec``):
  - "fused": the CUDA kernel ``csrc/cov_matvec.cu`` (its plain version on
    CPU tensors) for every base family, periodic at any width included;
    no gradient;
  - "blocked": (block, n) row tiles built per factor through the covariance
    tile kernel (``cov_cuda.CovTile``), combined over terms and factors
    and contracted with ``@``; every family and composite, differentiable,
    each block under ``torch.utils.checkpoint`` when a gradient is asked
    for (O(block * n) backward memory, as ``jax.checkpoint`` in the JAX
    package).

JAX's ``lax.while_loop`` / ``scan`` become Python loops: the tolerance
loop of ``cg_solve`` syncs the host once per iteration to test
convergence; ``fixed_iters=True`` never syncs.

Batched hyperparameters (the samplers' chains, every leaf with a leading
B, X shared; the counterpart of ``jax.vmap`` over params) run through
the same functions: ``make_matvec`` maps v (B, n, r) to (B, n, r) in one
batched launch (the fused matvec kernel, or the covariance tile's batch
for the blocked route), ``precond_apply_from_factors`` applies one shared
preconditioner with the chains folded into the right-hand-side columns,
``cg_solve`` freezes each chain once it has converged (as ``vmap`` of
the JAX ``while_loop`` does) and returns its iteration count, and
``lanczos_tridiag_batched`` / ``slq_logdet`` give one estimate a chain.

Random probes are an optional tensor argument everywhere (so the tests
feed both packages the same numbers), drawn from a ``torch.Generator``
otherwise.

The segmented schedule (``cg_solve_segmented``, ``lml_iterative_segmented``,
``posterior_iterative_segmented``) runs CG ``iters_per_program``
iterations at a time from a carried ``CGState`` and reads the host once
a segment (CG's relative residuals) instead of once an iteration; the
segments compose bit for bit: k segments of s iterations are the
fixed-iteration solve of k s iterations. Lanczos reads nothing from the
host, so ``slq_logdet_segmented`` is ``slq_logdet`` under the JAX
package's signature. ``precond_factors_host`` builds the
preconditioner in NumPy float64 on the host from the oracle's kernel
columns, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import cov_cuda, cov_matvec_cuda
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.ops.kernels import _bcast
from cugp_tpu_torch.utils.params import tree_leaves, tree_map

LOG2PI = math.log(2.0 * math.pi)
MATVEC_METHODS = ("auto", "fused", "blocked")


def _batched(params):
    """Whether params carry a leading chain dimension (the noise leaf is
    () for one set, (B,) for a batch, in every family and composite)."""
    return params["log_noise_var"].ndim == 1


def _requires_grad(params):
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in tree_leaves(params))


def rademacher(n, p, device, generator=None):
    """(n, p) float32 Rademacher probes on device, drawn on the
    generator's own device; a fresh seed-0 CPU generator when none is
    given (the JAX package's default key(0)), so the default probes are
    the same bits on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (n, p), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(device=device, dtype=torch.float32)


def make_matvec(params, X, kind="rbf", jitter=1e-6, block=4096,
                method="auto"):
    """v -> (K(X, X) + noise I) v without materializing K; v is (n,) or
    (n, r), or with batched params (B, n) or (B, n, r).

    method: "auto" takes "fused" for base families and "blocked" for
    composites; "fused" is the matvec kernel (no gradient: it raises);
    "blocked" builds (block, n) tiles through the covariance tile kernel.
    """
    if method not in MATVEC_METHODS:
        hint = " (the port's XLA-free twin is 'blocked')" if method in (
            "xla", "pallas") else ""
        raise ValueError(f"unknown matvec method {method!r}{hint}; "
                         f"expected one of {MATVEC_METHODS}")
    if method == "auto":
        method = "blocked" if kernel_ops.is_composite(kind) else "fused"
    if method == "fused":
        kernel_ops.require_base_kind(kind, "make_matvec(method='fused')")
        if torch.is_grad_enabled() and _requires_grad(params):
            raise RuntimeError(cov_matvec_cuda._NO_GRAD)

        def matvec_fused(v):
            return cov_matvec_cuda.train_cov_matvec(params, X, v, kind=kind,
                                                    jitter=jitter)

        return matvec_fused

    n = X.shape[0]
    vdim = 2 if _batched(params) else 1  # v's ndim as a vector
    diag_add = (torch.exp(params["log_noise_var"])
                + jitter * kernel_ops.signal_scale(params))
    amps, term_sizes, views = [], [], []
    for amp, factors in kernel_ops.flatten_terms(params, kind):
        amps.append(amp)
        term_sizes.append(len(factors))
        for base, fp in factors:
            xs, b2, extra = kernel_ops.factor_view(fp, X, base)
            e = extra.to(torch.float32)
            # unit amplitude, no diagonal, the family scalar
            scal = torch.stack([torch.ones_like(e), torch.zeros_like(e), e],
                               dim=-1)
            views.append((xs, b2, scal))

    def block_out(lo, hi, v2):
        """One (block, n) composite tile (a (B, block, n) batch of them)
        times v2: sum_t amp_t prod_f."""
        kb, f = None, 0
        for amp, nf in zip(amps, term_sizes):
            term = None
            for _ in range(nf):
                xs, base, scal = views[f]
                kf = cov_cuda.CovTile.apply(xs[..., lo:hi, :], xs, scal,
                                            base, False, hi - lo, n)
                term = kf if term is None else term * kf
                f += 1
            term = _bcast(amp, term) * term
            kb = term if kb is None else kb + term
        return kb @ v2

    def matvec(v):
        vec = v.ndim == vdim
        v2 = v[..., None] if vec else v
        grad = torch.is_grad_enabled() and (v2.requires_grad
                                            or _requires_grad(params))
        outs = []
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            if grad:
                # the backward rebuilds each tile instead of saving it
                outs.append(checkpoint(block_out, lo, hi, v2,
                                       use_reentrant=False))
            else:
                outs.append(block_out(lo, hi, v2))
        out = torch.cat(outs, dim=-2) + _bcast(diag_add, v2) * v2
        return out[..., 0] if vec else out

    return matvec


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor
    it: int


def pivoted_cholesky(params, X, rank, kind="rbf"):
    """Rank-`rank` partial pivoted Cholesky of the NOISE-FREE kernel
    matrix (Harbrecht et al.; the BBMM preconditioner recipe).

    Greedy: pick the column with the largest residual diagonal, evaluate
    that one kernel column exactly (O(n d); K is never formed), deflate.
    The argmax stays on the device: no host sync per pivot. Returns
    (Lk (n, rank), residual trace) with Kf ~ Lk Lk^T.
    """
    n = X.shape[0]
    dres = torch.broadcast_to(kernel_ops.kernel_diag(params, X, kind),
                              (n,)).to(torch.float32).clone()
    amps, term_sizes, views = [], [], []
    for amp, factors in kernel_ops.flatten_terms(params, kind):
        amps.append(amp)
        term_sizes.append(len(factors))
        for base, fp in factors:
            views.append(kernel_ops.factor_view(fp, X, base))

    def col(j):
        out, f = None, 0
        for amp, nf in zip(amps, term_sizes):
            term = None
            for _ in range(nf):
                xs, base, extra = views[f]
                kf = kernel_ops.tile_eval(xs, xs.index_select(0, j), base,
                                          extra)[:, 0]
                term = kf if term is None else term * kf
                f += 1
            term = amp * term
            out = term if out is None else out + term
        return out

    Lk = torch.zeros((n, rank), dtype=torch.float32, device=X.device)
    for i in range(rank):
        j = torch.argmax(dres).reshape(1)
        c = col(j)
        lj = Lk.index_select(0, j)[0]  # (rank,): zeros beyond step i
        ci = c - Lk @ lj
        piv = torch.sqrt(torch.clamp(dres.index_select(0, j), min=1e-12))
        li = (ci / piv).scatter_(0, j, piv)  # exact pivot; guards fp noise
        Lk[:, i] = li
        dres = torch.clamp(dres - li * li, min=0.0).index_fill_(0, j, 0.0)
    return Lk, torch.sum(dres)


@torch.no_grad()
def precond_factors(params, X, rank, kind="rbf", jitter=1e-6):
    """(Lk, Lg, s2) for P = Lk Lk^T + s2 I (s2 = noise + jitter * signal):
    the pivoted Cholesky, then the rank x rank Cholesky of
    G = s2 I + Lk^T Lk through the port's cholesky (the potrf kernel on
    CUDA). One set of factors serves every solve at the same params."""
    s2 = (torch.exp(params["log_noise_var"])
          + jitter * kernel_ops.signal_scale(params))
    Lk, _resid = pivoted_cholesky(params, X, rank, kind=kind)
    G = s2 * torch.eye(rank, dtype=X.dtype, device=X.device) + Lk.mT @ Lk
    return Lk, chol_ops.cholesky(G), s2


def pivoted_cholesky_host(params, X, rank, kind="rbf"):
    """pivoted_cholesky on the host in NumPy float64: each pivot's kernel
    column from the float64 oracle (oracle/exact_gp_np, every family and
    composite). The params and X are read from the device once. Returns
    (Lk (n, rank) float32 numpy, residual trace)."""
    import numpy as np

    from cugp_tpu_torch.oracle import exact_gp_np as onp
    from cugp_tpu_torch.utils.params import params_to_numpy

    p = params_to_numpy(params)
    Xh = X.detach().cpu().numpy().astype(np.float64)
    n = Xh.shape[0]
    dres = np.broadcast_to(np.asarray(onp.kernel_diag(p, Xh, kind),
                                      np.float64), (n,)).copy()
    Lk = np.zeros((n, rank))
    for i in range(rank):
        j = int(np.argmax(dres))
        c = onp.kernel_matrix(p, Xh, Xh[j:j + 1], kind)[:, 0]
        if i:
            c = c - Lk[:, :i] @ Lk[j, :i]
        piv = np.sqrt(max(dres[j], 1e-12))
        li = c / piv
        li[j] = piv
        Lk[:, i] = li
        dres = np.maximum(dres - li * li, 0.0)
        dres[j] = 0.0
    return Lk.astype(np.float32), float(dres.sum())


@torch.no_grad()
def precond_factors_host(params, X, rank, kind="rbf", jitter=1e-6,
                         verbose=False):
    """precond_factors built on the host, as the JAX package's: the
    pivoted Cholesky (pivoted_cholesky_host), s2 and the rank x rank
    Cholesky of G = s2 I + Lk^T Lk all in NumPy float64 (a composite's
    signal scale is the sum of its terms' amplitudes). Returns (Lk fp32,
    Lg fp32, s2 fp32) on X's device, a drop-in for precond_factors."""
    import sys

    import numpy as np

    from cugp_tpu_torch.utils.params import params_to_numpy

    def log(msg):
        if verbose:
            print(f"#   precond_host: {msg}", file=sys.stderr, flush=True)

    log("pivot loop")
    Lk, _resid = pivoted_cholesky_host(params, X, rank, kind=kind)
    ph = params_to_numpy(params)
    if "terms" in ph:
        sf2 = float(sum(np.exp(np.float64(t["log_signal_var"]))
                        for t in ph["terms"]))
    else:
        sf2 = float(np.exp(np.float64(ph["log_signal_var"])))
    s2 = float(np.exp(np.float64(ph["log_noise_var"]))) + jitter * sf2
    L64 = Lk.astype(np.float64)
    Lg = np.linalg.cholesky(s2 * np.eye(rank) + L64.T @ L64)
    log("device upload")

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=X.device)

    return dev(Lk), dev(Lg), dev(s2)


def build_precond(params, X, rank, kind="rbf", jitter=1e-6, where="device",
                  verbose=False):
    """(Lk, Lg, s2) built where `where` says: "host"
    (precond_factors_host), else on the device (precond_factors)."""
    if where == "host":
        return precond_factors_host(params, X, rank, kind=kind,
                                    jitter=jitter, verbose=verbose)
    return precond_factors(params, X, rank, kind=kind, jitter=jitter)


def _sum_rows(x):
    """torch.sum(x, dim=-2); a batch of chains (B, n, r) one chain at a
    time, so that each chain's sums add in the order they have when it
    runs alone (a reduction's order follows its tensor's shape, and CG
    and Lanczos amplify the difference): a chain's iterates are then the
    same bits in any batch."""
    if x.ndim < 3:
        return torch.sum(x, dim=-2)
    return torch.stack([torch.sum(c, dim=-2) for c in x])


def _norm_rows(x, keepdim=False):
    """torch.linalg.vector_norm(x, dim=-2), a batch one chain at a time
    (as _sum_rows)."""
    if x.ndim < 3:
        return torch.linalg.vector_norm(x, dim=-2, keepdim=keepdim)
    return torch.stack([torch.linalg.vector_norm(c, dim=-2, keepdim=keepdim)
                        for c in x])


class RowReduce(NamedTuple):
    """How CG and Lanczos reduce over the rows of their (n, r) vectors
    (or (B, n, r) batches): ``dot(a, b)`` the per-column sums of a * b,
    ``norm(x)`` the per-column 2-norms. LOCAL holds every row;
    parallel/sp_iterative's ring reduce holds this rank's rows and
    all-reduces each partial sum."""

    dot: Callable
    norm: Callable


LOCAL = RowReduce(lambda a, b: _sum_rows(a * b), _norm_rows)


def precond_apply_from_factors(Lk, Lg, s2):
    """P^-1 apply from precomputed factors, via Woodbury:
    P^-1 r = (r - Lk (s2 I_k + Lk^T Lk)^-1 Lk^T r) / s2; the rank-k solve
    is two triangular solves (the TRSM kernel on CUDA). r is (n, c), or
    (B, n, c) for a batch of chains sharing the preconditioner, applied
    one chain at a time: the GEMMs and the TRSM then see a chain's own
    (n, c) block, as when it runs alone, and give it the same bits."""

    def apply_2d(r):
        t = trsm_ops.cho_solve(Lg, Lk.mT @ r)
        return (r - Lk @ t) / s2

    def apply_p(r):
        if r.ndim == 2:
            return apply_2d(r)
        return torch.stack([apply_2d(c) for c in r])

    return apply_p


def make_pivoted_precond(params, X, rank, kind="rbf", jitter=1e-6):
    """precond_factors + apply closure (the BBMM preconditioner)."""
    return precond_apply_from_factors(
        *precond_factors(params, X, rank, kind=kind, jitter=jitter))


def _cg_apply_m(precond_apply, precond_diag):
    minv = (1.0 / precond_diag)[:, None] if precond_diag is not None else None

    def apply_m(r):
        if precond_apply is not None:
            return precond_apply(r)
        return r * minv if minv is not None else r

    return apply_m


def _cg_step(matvec, apply_m, s, reduce=LOCAL):
    """One CG iteration on (n, r) or, for a batch, (B, n, r)."""
    ap = matvec(s.p)
    denom = reduce.dot(s.p, ap)
    alpha = (s.rs / torch.where(denom == 0, 1.0, denom)).unsqueeze(-2)
    x = s.x + alpha * s.p
    r = s.r - alpha * ap
    z = apply_m(r)
    rs_new = reduce.dot(r, z)
    beta = (rs_new / torch.where(s.rs == 0, 1.0, s.rs)).unsqueeze(-2)
    p = z + beta * s.p
    return CGState(x=x, r=r, p=p, rs=rs_new, it=s.it + 1)


def cg_init(b, precond_apply=None, precond_diag=None, x0=None, matvec=None,
            reduce=LOCAL):
    """Initial CGState for K x = b (b is (n, r), or (B, n, r)).

    x0: optional warm start (same shape as b); pays one matvec to form
    the true residual r0 = b - K x0, so it needs `matvec`.
    """
    apply_m = _cg_apply_m(precond_apply, precond_diag)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        if matvec is None:
            raise ValueError("cg_init(x0=...) needs the matvec for r0")
        x, r = x0, b - matvec(x0)
    z0 = apply_m(r)
    return CGState(x=x, r=r, p=z0, rs=reduce.dot(r, z0), it=0)


def cg_segment(matvec, state, num_iters, precond_apply=None,
               precond_diag=None, reduce=LOCAL):
    """Exactly num_iters CG iterations from `state` (no host sync)."""
    apply_m = _cg_apply_m(precond_apply, precond_diag)
    for _ in range(num_iters):
        state = _cg_step(matvec, apply_m, state, reduce)
    return state


def cg_solve(matvec, b, tol=1e-6, max_iters=1000, precond_diag=None,
             fixed_iters=False, precond_apply=None, x0=None, reduce=LOCAL):
    """Batched conjugate gradients for SPD systems; b is (n,) or (n, r),
    or a batch of chains (B, n, r) (matvec and precond_apply taking the
    batch).

    precond_diag: optional (n,) Jacobi diagonal; precond_apply: optional
    r -> M^-1 r (takes precedence). fixed_iters: exactly max_iters
    iterations, no convergence test. x0: optional warm start.
    Returns (x, iterations used). The loop runs while any column's
    ||r|| / ||b|| exceeds tol; the iterations are an int. For a batch, as
    ``jax.vmap`` of the JAX package's ``while_loop``: a chain stops (its
    state frozen, so its iterate is its solo solve's) once its own
    columns are within tol or it reaches max_iters, the loop ends when
    every chain has stopped, and the iterations are a (B,) int tensor,
    each chain's count (the loop ran their max). reduce: how inner
    products sum over the rows (RowReduce; LOCAL holds them all).
    """
    if b.ndim == 3 and not fixed_iters:
        return _cg_solve_chains(matvec, b, tol, max_iters, precond_diag,
                                precond_apply, x0, reduce)
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if x0 is not None and x0.ndim == 1:
        x0 = x0[:, None]
    s = cg_init(b2, precond_apply, precond_diag, x0=x0, matvec=matvec,
                reduce=reduce)
    if fixed_iters:
        s = cg_segment(matvec, s, max_iters, precond_apply, precond_diag,
                       reduce)
    else:
        apply_m = _cg_apply_m(precond_apply, precond_diag)
        bnorm = torch.clamp(reduce.norm(b2), min=1e-30)
        while s.it < max_iters and bool(torch.any(
                reduce.norm(s.r) / bnorm > tol)):
            s = _cg_step(matvec, apply_m, s, reduce)
    return (s.x[:, 0] if vec else s.x), s.it


def _cg_solve_chains(matvec, b, tol, max_iters, precond_diag,
                     precond_apply, x0, reduce):
    """cg_solve's tolerance loop for a batch b (B, n, r): one host read
    an iteration (whether any chain is still running)."""
    s = cg_init(b, precond_apply, precond_diag, x0=x0, matvec=matvec,
                reduce=reduce)
    apply_m = _cg_apply_m(precond_apply, precond_diag)
    bnorm = torch.clamp(reduce.norm(b), min=1e-30)
    its = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)

    def running(s, its):
        rel = reduce.norm(s.r) / bnorm
        return (its < max_iters) & torch.any(rel > tol, dim=-1)

    run = running(s, its)
    while bool(torch.any(run)):
        new = _cg_step(matvec, apply_m, s, reduce)
        m = run[:, None, None]
        s = CGState(x=torch.where(m, new.x, s.x),
                    r=torch.where(m, new.r, s.r),
                    p=torch.where(m, new.p, s.p),
                    rs=torch.where(run[:, None], new.rs, s.rs), it=new.it)
        its = its + run.to(its.dtype)
        run = running(s, its)
    return s.x, its


def lanczos_tridiag(matvec, z, num_steps):
    """Lanczos from start vector z (no reorthogonalization, as for SLQ):
    returns (alphas (m,), betas (m-1,))."""
    alphas, betas = lanczos_tridiag_batched(
        lambda q: matvec(q[:, 0])[:, None], z[:, None], num_steps)
    return alphas[:, 0], betas[:, 0]


def lanczos_tridiag_batched(matvec, Z, num_steps, reduce=LOCAL):
    """Lanczos for a block of start vectors Z (n, p), or (B, n, p) for a
    batch of chains: each step is ONE multi-RHS matvec, so p probes cost
    about one (the BBMM batching). Probes stay independent. Returns
    (alphas (m, p), betas (m-1, p)), or (m, B, p) and (m-1, B, p).
    reduce: as cg_solve's."""
    q = Z / reduce.norm(Z).unsqueeze(-2)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(Z.shape[:-2] + Z.shape[-1:], dtype=Z.dtype,
                            device=Z.device)
    alphas, betas = [], []
    for _ in range(num_steps):
        v = matvec(q) - beta_prev.unsqueeze(-2) * q_prev
        alpha = reduce.dot(q, v)
        v = v - alpha.unsqueeze(-2) * q
        beta = reduce.norm(v)
        q_prev, q = q, v / torch.where(beta == 0, 1.0, beta).unsqueeze(-2)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def slq_logdet(matvec, n, Z=None, num_probes=16, num_steps=32,
               generator=None, device="cpu", reduce=LOCAL):
    """Stochastic Lanczos quadrature estimate of log det(K).

    E_z[z^T log(K) z] with Rademacher probes Z (n, p) (drawn on `device`
    from `generator` when not given); each probe's quadratic form comes
    from the eigendecomposition of its Lanczos tridiagonal, batched over
    probes in float64 on the device. Z (B, n, p) with a batched matvec
    (the same probes expanded over the chains) gives a (B,) estimate.
    reduce: as cg_solve's (Z then holds this rank's rows; n is global).
    """
    if Z is None:
        Z = rademacher(n, num_probes, device, generator)
    alphas, betas = lanczos_tridiag_batched(matvec, Z, num_steps, reduce)
    a = alphas.movedim(0, -1).to(torch.float64)   # (..., p, m)
    b = betas.movedim(0, -1).to(torch.float64)    # (..., p, m - 1)
    T = (torch.diag_embed(a) + torch.diag_embed(b, 1)
         + torch.diag_embed(b, -1))
    # a non-finite tridiagonal (a sampler's proposal where K overflows)
    # gives a NaN estimate, as jnp.linalg.eigh does; torch's raises, so
    # such probes get the identity and their NaN back afterwards
    bad = ~torch.isfinite(T).all(dim=-1).all(dim=-1)
    T = torch.where(bad[..., None, None],
                    torch.eye(T.shape[-1], dtype=T.dtype, device=T.device),
                    T)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-30)
    w = evecs[..., 0, :] ** 2  # (e1^T v_i)^2 per probe
    quad = torch.sum(w * torch.log(evals), dim=-1) * float(n)
    quad = torch.where(bad, torch.nan, quad)
    return torch.mean(quad, dim=-1).to(torch.float32)


def _precond(params, X, kind, jitter, precond, precond_rank):
    if precond is not None:
        return precond_apply_from_factors(*precond)
    if precond_rank:
        return make_pivoted_precond(params, X, precond_rank, kind=kind,
                                    jitter=jitter)
    return None


@torch.no_grad()
def lml_iterative(params, X, y, Z=None, kind="rbf", jitter=1e-6,
                  block=4096, tol=1e-5, max_iters=500, num_probes=16,
                  num_steps=32, precond_rank=0, precond=None,
                  generator=None):
    """LML via CG (quadratic term) + SLQ (logdet); matrix-free.

    Stochastic in the logdet: MC error ~ O(1/sqrt(num_probes)). Z: the
    (n, num_probes) probes, drawn from `generator` when not given.
    precond: precomputed (Lk, Lg, s2) factors (take precedence);
    precond_rank > 0 builds them here.
    """
    kernel_ops.validate_kind(kind)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = _precond(params, X, kind, jitter, precond, precond_rank)
    alpha, _ = cg_solve(mv, y, tol=tol, max_iters=max_iters,
                        precond_apply=pre)
    n = y.shape[0]
    logdet = slq_logdet(mv, n, Z=Z, num_probes=num_probes,
                        num_steps=num_steps, generator=generator,
                        device=X.device)
    return -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * n * LOG2PI


@torch.no_grad()
def posterior_iterative(params, X, y, Xs, kind="rbf", jitter=1e-6,
                        block=4096, tol=1e-6, max_iters=1000,
                        include_noise=False, precond=None, precond_rank=0,
                        col_batch=None, stats=None):
    """Posterior mean + diagonal variance via CG solves (matrix-free).

    mean: K*^T (K^-1 y); variance: k** - diag(K*^T K^-1 K*), with the
    test columns solved as a batched right-hand side, `col_batch` columns
    at a time (None: all at once, as the JAX package). K* comes from the
    covariance tile kernel. stats: optional dict that receives the mean
    solve's "alpha" and the CG counts "mean_iters" / "var_iters".
    """
    kernel_ops.validate_kind(kind)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = _precond(params, X, kind, jitter, precond, precond_rank)

    def solve(b):
        return cg_solve(mv, b, tol=tol, max_iters=max_iters,
                        precond_apply=pre)

    return _posterior_by_chunks(params, X, y, Xs, kind, solve, solve,
                                col_batch or max(Xs.shape[0], 1),
                                include_noise, stats)


def _posterior_by_chunks(params, X, y, Xs, kind, solve_mean, solve_chunk,
                         col_batch, include_noise, stats):
    """The posterior's assembly around its solves: alpha = solve_mean(y),
    then for each chunk of col_batch test points K* from the covariance
    tile kernel, the mean K*^T alpha and the variance's quadratic form
    diag(K*^T solve_chunk(K*)); each solve returns (x, iterations)."""
    alpha, it_mean = solve_mean(y)
    mus, quads, it_var = [], [], []
    for lo in range(0, Xs.shape[0], col_batch):
        Ks = kernel_ops.cross_covariance(params, X, Xs[lo:lo + col_batch],
                                         kind)
        mus.append(Ks.mT @ alpha)
        w, it = solve_chunk(Ks)
        quads.append(torch.sum(Ks * w, dim=0))
        it_var.append(it)
    var = kernel_ops.kernel_diag(params, Xs, kind) - torch.cat(quads)
    if include_noise:
        var = var + torch.exp(params["log_noise_var"])
    if stats is not None:
        stats.update(alpha=alpha, mean_iters=it_mean, var_iters=it_var)
    return torch.cat(mus), torch.clamp(var, min=0.0)


def _dk_tile(rows, cols, ell, sf2, kind, wrt, k_dim, alpha=None,
             period=None):
    """One (b, n) tile of dK/d(log theta) from UNSCALED inputs.

    wrt in {"log_signal_var", "log_lengthscale", "log_alpha",
    "log_period", "log_bias_var"} (noise is closed form in the caller);
    alpha doubles as the linear bias variance (the tile kernels' scalar
    slot).
    """
    if kind == "linear":
        rs, cs = rows / ell, cols / ell
        if wrt == "log_signal_var":
            return sf2 * (rs @ cs.T)
        if wrt == "log_bias_var":
            b = 0.0 if alpha is None else alpha
            return b * torch.ones((rows.shape[0], cols.shape[0]),
                                  dtype=rows.dtype, device=rows.device)
        if wrt == "log_lengthscale":
            return -2.0 * sf2 * torch.outer(rs[:, k_dim], cs[:, k_dim])
        raise ValueError(f"{wrt} gradient undefined for kind='linear'")
    if kind == "periodic":
        if period is None:
            raise ValueError("periodic _dk_tile needs the period vector")
        u = math.pi * (rows[:, None, :] - cols[None, :, :]) / period
        s2u = torch.sin(u) ** 2
        kf = sf2 * torch.exp(-2.0 * torch.sum(s2u / ell ** 2, dim=-1))
        if wrt == "log_signal_var":
            return kf
        if wrt == "log_lengthscale":
            return kf * (4.0 * s2u[..., k_dim] / ell[k_dim] ** 2)
        if wrt == "log_period":
            uk = u[..., k_dim]
            return kf * (2.0 * uk * torch.sin(2.0 * uk) / ell[k_dim] ** 2)
        raise ValueError(f"{wrt} gradient undefined for kind='periodic'")
    rs, cs = rows / ell, cols / ell
    d2 = (torch.sum(rs ** 2, -1)[:, None] + torch.sum(cs ** 2, -1)[None, :]
          - 2.0 * (rs @ cs.T))
    d2 = torch.clamp(d2, min=0.0)
    kf = sf2 * kernel_ops.kernel_fn(d2, kind, alpha)
    if wrt == "log_signal_var":
        return kf
    if wrt == "log_alpha":
        if kind != "rq":
            raise ValueError("log_alpha gradient only exists for kind='rq'")
        a = 1.0 if alpha is None else alpha
        logb = torch.log1p(d2 / (2.0 * a))
        return kf * a * (-logb + d2 / (2.0 * a + d2))
    # d k / d d2
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    if kind == "rbf":
        dk_dd2 = -0.5 * kf
    elif kind == "rq":
        a = 1.0 if alpha is None else alpha
        dk_dd2 = -0.5 * sf2 * torch.exp(-(a + 1.0) * torch.log1p(
            d2 / (2.0 * a)))
    elif kind == "matern12":
        dk_dd2 = sf2 * torch.exp(-r) * (-0.5 / r)
    elif kind == "matern32":
        dk_dd2 = sf2 * (-1.5) * torch.exp(-math.sqrt(3.0) * r)
    elif kind == "matern52":
        s5 = math.sqrt(5.0)
        dk_dd2 = sf2 * (-(5.0 / 6.0)) * (1.0 + s5 * r) * torch.exp(-s5 * r)
    else:
        raise ValueError(kind)
    diff2 = ((rows[:, None, k_dim] - cols[None, :, k_dim]) ** 2
             / ell[k_dim] ** 2)
    dK = dk_dd2 * (-2.0 * diff2)
    # r = 0 diagonal entries have zero derivative (mask numerical noise)
    return torch.where(d2 <= 1e-30, 0.0, dK)


def make_dk_matvec(params, X, wrt, k_dim=0, kind="rbf", block=4096):
    """v -> (dK/d log theta) v, matrix-free (same blocking as make_matvec)."""
    n = X.shape[0]
    ell = torch.exp(params["log_lengthscale"])
    sf2 = torch.exp(params["log_signal_var"])
    if kind == "rq" and "log_alpha" in params:
        alpha = torch.exp(params["log_alpha"])
    elif kind == "linear" and "log_bias_var" in params:
        alpha = torch.exp(params["log_bias_var"])  # bias rides alpha's slot
    else:
        alpha = None
    period = torch.exp(params["log_period"]) if kind == "periodic" else None

    def matvec(v):
        v2 = v[:, None] if v.ndim == 1 else v
        out = torch.cat([
            _dk_tile(X[lo:lo + block], X, ell, sf2, kind, wrt, k_dim, alpha,
                     period) @ v2 for lo in range(0, n, block)])
        return out[:, 0] if v.ndim == 1 else out

    return matvec


def _tree_like(params, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def hutchinson_grads_program(params, X, alpha, w, z, kind="rbf",
                             jitter=1e-6, block=4096):
    """The gradient sweep given the solves (alpha = K^-1 y, w = K^-1 z):
    one reverse-mode pass of g(p) = 1/2 (alpha^T K(p) alpha - mean_z
    w^T K(p) z) with alpha, w, z held constant, through the blocked
    (rematerialized) matvec. Serves every family and composite. One
    matvec on [alpha | z] gives both terms (K is symmetric), so each
    tile is built once per sweep. Returns grads in params' nesting.
    """
    alpha, w, z = alpha.detach(), w.detach(), z.detach()
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        est = hutchinson_estimator(p, X, alpha, w, z, kind=kind,
                                   jitter=jitter, block=block)
        grads = torch.autograd.grad(est, leaves, allow_unused=True)
    return _tree_like(params, [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, grads)])


def hutchinson_estimator(params, X, alpha, w, z, kind="rbf", jitter=1e-6,
                         block=4096):
    """1/2 (alpha^T K alpha - mean_j w_j^T K z_j) through the blocked
    matvec: its gradient in params is the LML's (the JAX package's
    ``estimator``). alpha (n,), w (n, p), z (n, p); with batched params
    alpha (B, n), w (B, n, p) and z (n, p) shared: a (B,) estimate."""
    mvp = make_matvec(params, X, kind=kind, jitter=jitter, block=block,
                      method="blocked")
    if alpha.ndim == 1:
        out = mvp(torch.cat([alpha[:, None], z], dim=1))
        quad = torch.dot(alpha, out[:, 0])
        return 0.5 * (quad - torch.mean(torch.sum(w * out[:, 1:], dim=0)))
    zb = z.expand(alpha.shape[0], *z.shape)
    out = mvp(torch.cat([alpha[..., None], zb], dim=-1))
    quad = torch.sum(alpha * out[..., 0], dim=-1)
    tr = torch.mean(torch.sum(w * out[..., 1:], dim=-2), dim=-1)
    return 0.5 * (quad - tr)


@torch.no_grad()
def lml_value_and_grad_iterative(params, X, y, z=None, kind="rbf",
                                 jitter=1e-6, block=4096, tol=1e-5,
                                 max_iters=500, num_probes=16, precond=None,
                                 grad_method="ad", generator=None):
    """Matrix-free LML gradient (the BBMM training step).

    dLML/dtheta = 1/2 (alpha^T dK alpha - tr(K^-1 dK)), the trace by
    Hutchinson probes z (n, num_probes; drawn from `generator` when not
    given) solved in one batched CG with y. Returns (the quad-form value
    -1/2 y^T alpha WITHOUT the logdet, grads in params' nesting).
    grad_method "ad": one reverse sweep of the estimator through the
    blocked matvec (every family and composite); "analytic": the
    hand-derived dK tiles (base families; the cross-check).
    precond: optional (Lk, Lg, s2) factors for the CG solve.
    """
    if grad_method not in ("ad", "analytic"):
        raise ValueError(f"unknown grad_method {grad_method!r}")
    if grad_method == "analytic":
        kernel_ops.require_base_kind(
            kind, "lml_value_and_grad_iterative(grad_method='analytic')")
    else:
        kernel_ops.validate_kind(kind)
    n, d = X.shape
    if z is None:
        z = rademacher(n, num_probes, X.device, generator)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = (precond_apply_from_factors(*precond) if precond is not None
           else None)
    # one batched CG for [y | z]: each iteration's tiles are built once
    # and contracted against rhs and probes together
    sol, _ = cg_solve(mv, torch.cat([y[:, None], z], dim=1), tol=tol,
                      max_iters=max_iters, precond_apply=pre)
    alpha, w = sol[:, 0], sol[:, 1:]
    value = -0.5 * torch.dot(y, alpha)  # quad term only (no logdet)
    if grad_method == "ad":
        return value, hutchinson_grads_program(params, X, alpha, w, z,
                                               kind=kind, jitter=jitter,
                                               block=block)

    def half_trace_form(dmv, extra=0.0):
        """1/2 (alpha^T dK alpha - mean_z w^T dK z), dK = dmv + extra I."""
        return 0.5 * (torch.dot(alpha, dmv(alpha) + extra * alpha)
                      - torch.mean(torch.sum(w * (dmv(z) + extra * z),
                                             dim=0)))

    sn2 = torch.exp(params["log_noise_var"])
    grads = {"log_noise_var": 0.5 * sn2 * (
        torch.dot(alpha, alpha) - torch.mean(torch.sum(w * z, dim=0)))}
    # signal variance (the jitter * sf2 diagonal moves with it)
    sf2 = torch.exp(params["log_signal_var"])
    grads["log_signal_var"] = half_trace_form(
        make_dk_matvec(params, X, "log_signal_var", kind=kind, block=block),
        jitter * sf2)
    grads["log_lengthscale"] = torch.stack([
        half_trace_form(make_dk_matvec(params, X, "log_lengthscale",
                                       k_dim=k, kind=kind, block=block))
        for k in range(d)])
    if kind == "rq" and "log_alpha" in params:
        grads["log_alpha"] = half_trace_form(
            make_dk_matvec(params, X, "log_alpha", kind=kind, block=block))
    if kind == "periodic":
        grads["log_period"] = torch.stack([
            half_trace_form(make_dk_matvec(params, X, "log_period",
                                           k_dim=k, kind=kind, block=block))
            for k in range(d)])
    if kind == "linear" and "log_bias_var" in params:
        grads["log_bias_var"] = half_trace_form(
            make_dk_matvec(params, X, "log_bias_var", kind=kind,
                           block=block))
    return value, _tree_like(params, [grads[k] for k in params])


@torch.no_grad()
def cg_solve_program(params, X, b, precond=None, kind="rbf", jitter=1e-6,
                     block=4096, tol=1e-5, max_iters=500, x0=None):
    """One CG solve of (K + noise I) x = b at these params, optionally
    preconditioned by (Lk, Lg, s2) factors and warm-started from x0 (one
    extra matvec forms the true residual). Returns (x, iterations). With
    batched params and b (B, n, r), the chains' solves (cg_solve)."""
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = (precond_apply_from_factors(*precond) if precond is not None
           else None)
    return cg_solve(mv, b, tol=tol, max_iters=max_iters, precond_apply=pre,
                    x0=x0)


# ---- the segmented schedule: CG and Lanczos resumed segment by segment,
# one host read a segment ----


def run_cg_segments(matvec, b, *, tol=1e-4, iters_per_program=64,
                    max_iters=1024, precond_apply=None, x0=None,
                    verbose=False):
    """CG on any operator in segments of `iters_per_program` iterations
    (cg_segment), the state carried between them; after each segment ONE
    host read, the columns' largest relative residual from the carried r,
    stops the solve once it is within tol or max_iters are spent.
    b is (n,) or (n, r); x0 an optional warm start (one matvec forms the
    true residual, cg_init). Returns (x, total_iters, max_rel):
    total_iters is a multiple of iters_per_program, and x is bitwise the
    fixed-iteration cg_solve of total_iters from the same start."""
    import sys

    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if x0 is not None and x0.ndim == 1:
        x0 = x0[:, None]
    bnorm = torch.clamp(LOCAL.norm(b2), min=1e-30)
    state = cg_init(b2, precond_apply, x0=x0, matvec=matvec)
    total, rel = 0, math.inf
    while total < max_iters:
        state = cg_segment(matvec, state, iters_per_program, precond_apply)
        total += iters_per_program
        rel = float(torch.max(LOCAL.norm(state.r) / bnorm))
        if verbose:
            print(f"#   cg_segmented: it={total} max_rel={rel:.3e}",
                  file=sys.stderr, flush=True)
        if rel <= tol:
            break
    return (state.x[:, 0] if vec else state.x), total, rel


@torch.no_grad()
def cg_solve_segmented(params, X, b, *, kind="rbf", jitter=1e-6, block=4096,
                       tol=1e-4, iters_per_program=64, max_iters=1024,
                       precond=None, x0=None, verbose=False):
    """CG solve of (K + noise I) x = b in segments of iters_per_program
    iterations (run_cg_segments on make_matvec), optionally
    preconditioned by (Lk, Lg, s2) factors (precond_factors or
    precond_factors_host) and warm-started from x0. b is (n,) or (n, r).
    Returns (x, total_iters, max_rel) with the residual from the carried
    r (a caller wanting a certificate recomputes it with one matvec)."""
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    return run_cg_segments(
        mv, b, tol=tol, iters_per_program=iters_per_program,
        max_iters=max_iters, x0=x0, verbose=verbose,
        precond_apply=_precond(params, X, kind, jitter, precond, 0))


@torch.no_grad()
def slq_logdet_segmented(params, X, n, Z=None, *, generator=None,
                         kind="rbf", jitter=1e-6, block=4096, num_probes=16,
                         num_steps=32, iters_per_program=8, verbose=False):
    """slq_logdet on make_matvec under the JAX package's segmented
    signature. iters_per_program and verbose have no effect: the eager
    Lanczos loop reads nothing from the host, so a segment boundary
    would change nothing, and the estimate on Z is slq_logdet's."""
    return slq_logdet(make_matvec(params, X, kind=kind, jitter=jitter,
                                  block=block), n, Z, num_probes=num_probes,
                      num_steps=num_steps, generator=generator,
                      device=X.device)


@torch.no_grad()
def lml_iterative_segmented(params, X, y, Z=None, *, generator=None,
                            kind="rbf", jitter=1e-6, block=4096, tol=1e-4,
                            iters_per_program=16, max_iters=1024,
                            num_probes=16, num_steps=32, precond=None,
                            verbose=False):
    """lml_iterative's estimator (CG quadratic term + SLQ logdet) with
    the CG solve in segments of iters_per_program (run_cg_segments) and
    the logdet from slq_logdet (its Lanczos loop reads nothing from the
    host, so it has no segments to cut). Z / generator: the probes, as
    slq_logdet's (drawn on X's device). Returns a float."""
    kernel_ops.validate_kind(kind)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    alpha, _it, _rel = run_cg_segments(
        mv, y, tol=tol, iters_per_program=iters_per_program,
        max_iters=max_iters, verbose=verbose,
        precond_apply=_precond(params, X, kind, jitter, precond, 0))
    n = y.shape[0]
    logdet = slq_logdet(mv, n, Z, num_probes=num_probes,
                        num_steps=num_steps, generator=generator,
                        device=X.device)
    quad = float(torch.dot(y, alpha))
    return -0.5 * quad - 0.5 * float(logdet) - 0.5 * n * LOG2PI


@torch.no_grad()
def posterior_iterative_segmented(params, X, y, Xs, *, kind="rbf",
                                  jitter=1e-6, block=4096, tol=1e-4,
                                  iters_per_program=16, max_iters=1024,
                                  include_noise=False, precond=None,
                                  col_batch=256, verbose=False, stats=None):
    """posterior_iterative on the segmented schedule: the mean solve in
    segments of iters_per_program, then the test points in col_batch
    chunks, each chunk's K(X, X*) from the covariance tile kernel and
    its variance solve in segments of max(1, iters_per_program 16 //
    max(16, chunk width)) (a wider right-hand side, fewer iterations a
    segment), as the JAX package scales them. The mean and variance stay
    on X's device (the JAX package assembles them in host NumPy).
    stats: optional dict that receives the mean solve's "alpha" and the
    CG counts "mean_iters" / "var_iters"."""
    kernel_ops.validate_kind(kind)
    mv = make_matvec(params, X, kind=kind, jitter=jitter, block=block)
    pre = _precond(params, X, kind, jitter, precond, 0)

    def solve(b, iters):
        x, it, _rel = run_cg_segments(mv, b, tol=tol, iters_per_program=iters,
                                      max_iters=max_iters,
                                      precond_apply=pre, verbose=verbose)
        return x, it

    return _posterior_by_chunks(
        params, X, y, Xs, kind, lambda b: solve(b, iters_per_program),
        lambda b: solve(b, max(1, iters_per_program * 16
                               // max(16, b.shape[1]))),
        col_batch, include_noise, stats)
