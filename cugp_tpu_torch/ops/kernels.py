"""Covariance (kernel-matrix) construction, as ``cugp_tpu/ops/kernels.py``.

``train_covariance`` / ``cross_covariance`` build K through the
covariance tile of ``cov_cuda`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors) inside the ``CovTile`` autograd Function. There
is no size threshold: a small N on CUDA still runs the kernel.
Lengthscale scaling, the periodic cos/sin view and composite combination
are ordinary torch ops around the Function, so autograd carries their
gradients. ``*_plain`` are the counterparts of the JAX package's
``*_xla`` functions (distance expansion + ``kernel_fn``).

Hyperparameters are the JAX package's log-space dict as fp32 tensors:
``log_lengthscale`` (d,), ``log_signal_var`` (), ``log_noise_var`` (),
plus ``log_alpha`` (rq), ``log_period`` (d,) (periodic) or
``log_bias_var`` (linear); composites use the nested terms/factors dict:
  {"log_noise_var": (),
   "terms": [{"log_signal_var": (), "factors": [<factor dict>, ...]}, ...]}

Batched hyperparameters (chains or Monte Carlo draws of the samplers,
the counterpart of ``jax.vmap`` over params): every leaf carries a
leading B (``log_lengthscale`` (B, d), ``log_noise_var`` (B,), ...) while
X stays shared; ``train_covariance`` / ``cross_covariance`` then return
(B, m, n) from one batched launch of the tile per base family (periodic
through its rbf view, composites combined elementwise with broadcasting).
Unbatched params take the same code with no batch dimension.
"""

from __future__ import annotations

import math

import torch

from cugp_tpu_torch.ops import cov_cuda
from cugp_tpu_torch.ops.trsm import check_method

SUPPORTED_KERNELS = ("rbf", "matern12", "matern32", "matern52", "rq",
                     "periodic", "linear")

_TWO_PI = 2.0 * math.pi


def is_composite(kind):
    return ("+" in kind) or ("*" in kind)


def parse_kind(kind):
    """'a*b+c' -> (('a','b'), ('c',)). Validates every base family."""
    terms = []
    for term in kind.split("+"):
        factors = tuple(f.strip() for f in term.split("*"))
        if not all(factors):
            raise ValueError(f"malformed composite kernel kind: {kind!r}")
        for f in factors:
            if f not in SUPPORTED_KERNELS:
                raise ValueError(
                    f"unknown kernel kind {f!r} in composite {kind!r}; "
                    f"supported bases: {SUPPORTED_KERNELS}")
        terms.append(factors)
    return tuple(terms)


def require_base_kind(kind, where):
    """Paths that specialize per family (the analytic-gradient estimator,
    the fused single-family matvec) serve base kinds only; composites go
    through the AD / per-factor tile routes."""
    if is_composite(kind):
        raise NotImplementedError(
            f"{where} supports base kernel families only, got composite "
            f"{kind!r}; use the blocked route (method='auto'/'blocked')")


def validate_kind(kind):
    """Raise ValueError unless kind is a supported base family or a
    well-formed composite of them."""
    parse_kind(kind)


def _bcast(s, like):
    """A per-element scalar s (() or (B,)) shaped to broadcast against
    like (..., m, n) or (..., n)."""
    return s if s.ndim == 0 else s.reshape(s.shape + (1,) * (like.ndim - 1))


def _scale(X, v):
    """X (n, d) divided by v (d,), or by each row of v (B, d): (B, n, d)."""
    return X / v if v.ndim == 1 else X / v[..., None, :]


def signal_scale(params):
    """exp(log_signal_var) for base families, the sum of term amplitudes
    for composites."""
    if "terms" in params:
        return sum(torch.exp(t["log_signal_var"]) for t in params["terms"])
    return torch.exp(params["log_signal_var"])


def _unit_amplitude(fparams, like):
    p = dict(fparams)
    p["log_signal_var"] = torch.zeros_like(like)
    return p


def _check_terms(params, kind):
    terms = parse_kind(kind)
    if len(params.get("terms", ())) != len(terms):
        raise ValueError(
            f"composite params have {len(params.get('terms', ()))} terms, "
            f"kind {kind!r} needs {len(terms)}")
    return terms


def _composite_combine(params, kind, factor_fn):
    """Sum over terms of (amplitude * product over factors of
    factor_fn(unit-amplitude factor params, base))."""
    terms = _check_terms(params, kind)
    like = params["log_noise_var"]
    K = None
    for tparams, bases in zip(params["terms"], terms):
        Kt = None
        for fparams, base in zip(tparams["factors"], bases):
            Kf = factor_fn(_unit_amplitude(fparams, like), base)
            Kt = Kf if Kt is None else Kt * Kf
        Kt = _bcast(torch.exp(tparams["log_signal_var"]), Kt) * Kt
        K = Kt if K is None else K + Kt
    return K


def flatten_terms(params, kind):
    """[(amplitude, [(base, unit_factor_params), ...]), ...] for any kind;
    a base kind is one one-factor term (see the JAX twin)."""
    like = params["log_noise_var"]
    if not is_composite(kind):
        fp = _unit_amplitude(params, like)
        if kind == "linear" and "log_bias_var" in params:
            # base-linear puts the bias outside the amplitude
            fp["log_bias_var"] = (params["log_bias_var"]
                                  - params["log_signal_var"])
        return [(torch.exp(params["log_signal_var"]), [(kind, fp)])]
    terms = _check_terms(params, kind)
    return [(torch.exp(tparams["log_signal_var"]),
             [(base, _unit_amplitude(fp, like))
              for fp, base in zip(tparams["factors"], bases)])
            for tparams, bases in zip(params["terms"], terms)]


def factor_view(fparams, X, base):
    """Scale X into a factor's evaluation space.

    Returns (Xs, base', extra) such that the factor's unit-amplitude tile
    between row/col chunks of Xs is ``tile_eval(rows, cols, base',
    extra)``; periodic is rewritten to rbf on the cos/sin embedding.
    """
    if base == "periodic":
        fparams, X = periodic_rbf_view(fparams, X)
        base = "rbf"
    ell = torch.exp(fparams["log_lengthscale"])
    return _scale(X, ell).to(torch.float32), base, extra_scalar(fparams, base)


def tile_eval(rows_s, cols_s, base, extra):
    """Unit-amplitude kernel tile between pre-scaled row/col chunks, in
    plain torch ops (the JAX version is XLA too). base is post-factor_view
    (no 'periodic'); extra is the rq alpha or the linear bias."""
    cross = rows_s @ cols_s.T
    if base == "linear":
        return cross + extra
    r2 = torch.sum(rows_s * rows_s, dim=-1)[:, None]
    c2 = torch.sum(cols_s * cols_s, dim=-1)[None, :]
    d2 = torch.clamp(r2 + c2 - 2.0 * cross, min=0.0)
    return kernel_fn(d2, base, extra if base == "rq" else None)


def kernel_fn(d2, kind, alpha=None):
    """Kernel value as a function of scaled squared distance (unit
    amplitude); alpha is the rq mixture parameter (default 1)."""
    if kind == "rq" and alpha is None:
        alpha = 1.0
    return cov_cuda.kernel_fn_plain(d2, kind, alpha)


def periodic_features(X, log_period):
    """phi(x) = [cos(2 pi x/p), sin(2 pi x/p)] per dim: rbf on phi(X) with
    each lengthscale duplicated is the exp-sine-squared kernel."""
    ang = _scale(_TWO_PI * X, torch.exp(log_period))
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def periodic_rbf_view(params, *Xs):
    """(params', phi(X)...) such that rbf on them == periodic on inputs."""
    ll = params["log_lengthscale"]
    p2 = {k: v for k, v in params.items() if k != "log_period"}
    p2["log_lengthscale"] = torch.cat([ll, ll], dim=-1)
    feats = tuple(periodic_features(X, params["log_period"]) for X in Xs)
    return (p2,) + feats


def extra_scalar(params, kind):
    """The family scalar of the covariance tile: rq mixture alpha, linear
    bias variance, else 1.0 (unused)."""
    like = params["log_lengthscale"][..., 0]
    if kind == "rq" and "log_alpha" in params:
        return torch.exp(params["log_alpha"])
    if kind == "linear":
        if "log_bias_var" in params:
            return torch.exp(params["log_bias_var"])
        return torch.zeros_like(like)
    return torch.ones_like(like)


def kernel_diag(params, X, kind="rbf"):
    """Prior variance diag k(x, x) at the inputs (no noise)."""
    if is_composite(kind):
        return _composite_combine(
            params, kind, lambda fp, base: kernel_diag(fp, X, base))
    sf2 = torch.exp(params["log_signal_var"])
    if kind == "linear":
        Xs = _scale(X, torch.exp(params["log_lengthscale"]))
        q = torch.sum(Xs * Xs, dim=-1)
        bias = (_bcast(torch.exp(params["log_bias_var"]), q)
                if "log_bias_var" in params else 0.0)
        return _bcast(sf2, q) * q + bias
    ones = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    return _bcast(sf2, ones) * ones


# ---- plain versions (the counterparts of the JAX *_xla functions) ----


def scaled_sqdist(X1, X2, lengthscale):
    """Pairwise squared distance after per-dim scaling."""
    X1 = X1 / lengthscale
    X2 = X2 / lengthscale
    n1 = torch.sum(X1 * X1, dim=-1)[:, None]
    n2 = torch.sum(X2 * X2, dim=-1)[None, :]
    return torch.clamp(n1 + n2 - 2.0 * (X1 @ X2.T), min=0.0)


def _mask_rows(K, n_true):
    if n_true is not None and n_true < K.shape[0]:
        rows = torch.arange(K.shape[0], device=K.device)[:, None]
        K = torch.where(rows >= n_true, 0.0, K)
    return K


def _identity_pad(K, n_true):
    n = K.shape[0]
    if n_true is not None and n_true < n:
        rows = torch.arange(n, device=K.device)[:, None]
        cols = torch.arange(n, device=K.device)[None, :]
        pad = (rows >= n_true) | (cols >= n_true)
        K = torch.where(pad, (rows == cols).to(K.dtype), K)
    return K


def cross_covariance_plain(params, X1, X2, kind="rbf", n_true=None):
    """K(X1, X2) without noise, in plain torch ops (cross_covariance_xla)."""
    if is_composite(kind):
        K = _composite_combine(
            params, kind,
            lambda fp, base: cross_covariance_plain(fp, X1, X2, base))
        return _mask_rows(K, n_true)
    if kind == "periodic":
        params, X1, X2 = periodic_rbf_view(params, X1, X2)
        kind = "rbf"
    ell = torch.exp(params["log_lengthscale"])
    sf2 = torch.exp(params["log_signal_var"])
    if kind == "linear":
        bias = (torch.exp(params["log_bias_var"])
                if "log_bias_var" in params else 0.0)
        K = sf2 * ((X1 / ell) @ (X2 / ell).T) + bias
    else:
        alpha = (torch.exp(params["log_alpha"])
                 if kind == "rq" and "log_alpha" in params else None)
        K = sf2 * kernel_fn(scaled_sqdist(X1, X2, ell), kind, alpha)
    return _mask_rows(K, n_true)


def train_covariance_plain(params, X, kind="rbf", jitter=1e-6, n_true=None):
    """K(X, X) + (noise_var + jitter*signal_var) I (train_covariance_xla)."""
    K = cross_covariance_plain(params, X, X, kind)
    diag_add = torch.exp(params["log_noise_var"]) + jitter * signal_scale(
        params)
    K = K + diag_add * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return _identity_pad(K, n_true)


# ---- the tile route (kernel on CUDA, plain version on CPU) ----


def _tile(params, X1, X2, kind, square, diag_add, n1_true, n2_true):
    """One base family through cov_cuda.CovTile (a batch of builds when
    the params carry a leading B)."""
    if kind == "periodic":
        params, X1, X2 = periodic_rbf_view(params, X1, X2)
        kind = "rbf"
    ell = torch.exp(params["log_lengthscale"])
    xs1 = _scale(X1, ell)
    xs2 = xs1 if X2 is X1 else _scale(X2, ell)
    sf2 = torch.exp(params["log_signal_var"])
    scal = torch.stack([sf2,
                        torch.broadcast_to(torch.as_tensor(
                            diag_add, dtype=torch.float32,
                            device=sf2.device), sf2.shape),
                        extra_scalar(params, kind)], dim=-1).to(torch.float32)
    return cov_cuda.CovTile.apply(xs1.to(torch.float32),
                                  xs2.to(torch.float32), scal, kind, square,
                                  n1_true, n2_true)


def cross_covariance(params, X1, X2, kind="rbf", method="auto", n_true=None):
    """K(X1, X2) without noise; rows of X1 at or beyond n_true are zero."""
    check_method(method)
    m, n = X1.shape[0], X2.shape[0]
    if is_composite(kind):
        # each factor is its own tile build; the combine is elementwise
        K = _composite_combine(
            params, kind,
            lambda fp, base: _tile(fp, X1, X2, base, False, 0.0, m, n))
        return _mask_rows(K, n_true)
    n1 = m if n_true is None else min(m, n_true)
    return _tile(params, X1, X2, kind, False, 0.0, n1, n)


def train_covariance(params, X, kind="rbf", jitter=1e-6, method="auto",
                     n_true=None):
    """K(X, X) + noise/jitter diagonal; rows/cols at or beyond n_true
    become an exact identity block (the padding contract)."""
    check_method(method)
    n = X.shape[0]
    diag_add = torch.exp(params["log_noise_var"]) + jitter * signal_scale(
        params)
    if is_composite(kind):
        K = cross_covariance(params, X, X, kind, method=method)
        K = K + _bcast(diag_add, K) * torch.eye(n, dtype=K.dtype,
                                                device=K.device)
        return _identity_pad(K, n_true)
    nt = n if n_true is None else min(n, n_true)
    return _tile(params, X, X, kind, True, diag_add, nt, nt)


def init_params(d=1, lengthscale=1.0, signal_var=1.0, noise_var=0.1,
                alpha=None, period=None, bias_var=None, device="cpu"):
    """The log-space hyperparameter dict as fp32 tensors on device."""
    def full(shape, v):
        return torch.full(shape, math.log(v), dtype=torch.float32,
                          device=device)

    p = {"log_lengthscale": full((d,), lengthscale),
         "log_signal_var": full((), signal_var),
         "log_noise_var": full((), noise_var)}
    if alpha is not None:
        p["log_alpha"] = full((), alpha)
    if period is not None:
        p["log_period"] = full((d,), period)
    if bias_var is not None:
        p["log_bias_var"] = full((), bias_var)
    return p


def default_init(kind, d=1, **kw):
    """init_params with the family's extra hyperparameter; composites get
    the nested terms/factors structure."""
    if is_composite(kind):
        return composite_init(kind, d=d, **kw)
    if kind == "rq":
        kw.setdefault("alpha", 1.0)
    elif kind == "periodic":
        kw.setdefault("period", 1.0)
    elif kind == "linear":
        kw.setdefault("bias_var", 1.0)
    return init_params(d=d, **kw)


def composite_init(kind, d=1, lengthscale=1.0, signal_var=1.0,
                   noise_var=0.1, device="cpu"):
    """Nested params for a composite kind: one amplitude per additive
    term, lengthscale + family extras per factor."""
    terms = []
    for bases in parse_kind(kind):
        factors = []
        for base in bases:
            fp = default_init(base, d=d, lengthscale=lengthscale,
                              device=device)
            fp.pop("log_signal_var")
            fp.pop("log_noise_var")
            factors.append(fp)
        terms.append({"log_signal_var": torch.full(
            (), math.log(signal_var), dtype=torch.float32, device=device),
            "factors": factors})
    return {"log_noise_var": torch.full((), math.log(noise_var),
                                        dtype=torch.float32, device=device),
            "terms": terms}
