"""User-facing API facades, as ``cugp_tpu/api.py``'s ``GP`` (dense and
matrix-free parts, the sparse SGPR fit, hyperparameter HMC/NUTS and VI,
persistence), ``GPClassifier`` (Laplace, EP and multiclass GP
classification), ``SVGP``, and the LMC multi-output facades
``MultiOutputGP`` (ICM) and ``MultiOutputGPQ`` (rank-Q, dense and
matrix-free).

Each facade runs where its ``device`` says, "cuda" unless the caller
asks for the CPU: data, hyperparameters and every kernel launch live
there. There is no fallback: without a CUDA device, a facade left on
"cuda" fails with torch's own error when data is placed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.utils.params import tree_map


def _as_f32(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _tree_struct(p):
    """JSON-serializable shape of a params tree (leaves -> None), saved
    beside the arrays so that load can rebuild the tree for any kernel,
    composite terms/factors included."""
    if isinstance(p, dict):
        return {k: _tree_struct(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_tree_struct(v) for v in p]
    return None


def _probe_from_struct(s):
    if isinstance(s, dict):
        return {k: _probe_from_struct(v) for k, v in s.items()}
    if isinstance(s, list):
        return [_probe_from_struct(v) for v in s]
    return np.zeros(())


@dataclasses.dataclass
class GP:
    """Exact Gaussian-process regression.

    kind: kernel family — 'rbf' | 'matern12' | 'matern32' | 'matern52' |
        'rq' | 'periodic' | 'linear', or a '+'/'*' composite of them.
    jitter: diagonal jitter (times signal variance) for PD safety.
    method: 'auto' | 'pallas' — the CUDA kernels for a CUDA device, their
        plain versions on the CPU.
    basis: None | 'constant' | 'linear' — explicit basis functions with
        marginalized coefficients (GPML 2.7).
    normalize_y: standardize targets internally.
    device: where data, hyperparameters and computation live ("cuda" by
        default; "cpu" runs the kernels' plain versions).
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    basis: Optional[str] = None
    normalize_y: bool = False
    device: Any = "cuda"
    params: Optional[dict] = None
    X: Optional[Any] = None
    y: Optional[Any] = None
    y_mean: float = 0.0
    y_std: float = 1.0

    def __post_init__(self):
        kernel_ops.validate_kind(self.kind)
        kernel_ops.check_method(self.method)
        if self.basis not in (None, "constant", "linear"):
            raise ValueError(f"unknown basis {self.basis!r}")
        self.device = torch.device(self.device)

    def _data(self, X, y):
        """Validate; with normalize_y, standardize targets and record the
        stats. self.y is always the internal (standardized) targets."""
        X = _as_f32(X, self.device)
        y = _as_f32(y, self.device)
        if X.ndim != 2:
            raise ValueError(f"X must be (n, d), got shape {tuple(X.shape)}")
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError(f"y must be (n,) matching X (n={X.shape[0]}), "
                             f"got {tuple(y.shape)}")
        if self.normalize_y:
            self.y_mean = float(torch.mean(y))
            self.y_std = max(float(torch.std(y, correction=0)), 1e-12)
            y = (y - self.y_mean) / self.y_std
        return X, y

    def _out_mean(self, mu):
        return mu * self.y_std + self.y_mean if self.normalize_y else mu

    def _out_var(self, v):
        return v * (self.y_std ** 2) if self.normalize_y else v

    def _out_lml(self, lml):
        """log p(y) = log p(y_std) - n log(sigma_y)."""
        if not self.normalize_y:
            return lml
        return lml - self.y.shape[0] * math.log(self.y_std)

    def _params(self, params):
        """Tensors on this GP's device; numpy/jax leaves become fp32."""
        return tree_map(lambda v: _as_f32(v, self.device), params)

    def fit(self, X, y, *, steps=200, optimizer="adam", learning_rate=0.05,
            init=None, generator=None, log_prior=None, objective="lml",
            restarts=1):
        """MAP hyperparameter fit by maximizing the LML (inference/map_opt)
        with Adam or L-BFGS ("lbfgs"); with log_prior (callable params ->
        scalar) the log posterior (map_opt.weak_log_prior matches the
        samplers' default prior); objective="loo" maximizes the
        leave-one-out pseudo-likelihood instead (see loo()). restarts > 1:
        map_opt.fit_restarts from starts perturbed with draws from
        `generator`; the best final objective wins. Returns the info dict
        ("loss", "lml", ...)."""
        from cugp_tpu_torch.inference import map_opt

        X, y = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1],
                                           device=self.device)
        kw = dict(kind=self.kind, jitter=self.jitter, method=self.method,
                  steps=steps, optimizer=optimizer,
                  learning_rate=learning_rate, basis=self.basis,
                  log_prior=log_prior, objective=objective)
        if restarts > 1:
            params, info = map_opt.fit_restarts(
                self._params(init), X, y, restarts=restarts,
                generator=generator, **kw)
        else:
            params, info = map_opt.fit(self._params(init), X, y, **kw)
        self.params, self.X, self.y = params, X, y
        return info

    def condition(self, X, y, params=None):
        """Attach data (and optionally hyperparameters) without fitting."""
        self.X, self.y = self._data(X, y)
        if params is not None:
            self.params = self._params(params)
        elif self.params is None:
            self.params = kernel_ops.default_init(
                self.kind, d=self.X.shape[1], device=self.device)
        return self

    @torch.no_grad()
    def log_marginal_likelihood(self, params=None):
        p = self._params(params) if params is not None else self.params
        if self.basis is not None:
            lml = exact_gp.log_marginal_likelihood_basis(
                p, self.X, self.y, kind=self.kind, jitter=self.jitter,
                method=self.method, basis=self.basis)
        else:
            lml = exact_gp.log_marginal_likelihood(
                p, self.X, self.y, kind=self.kind, jitter=self.jitter,
                method=self.method)
        return self._out_lml(lml)

    @torch.no_grad()
    def loo(self, params=None):
        """Leave-one-out cross-validation at the training points from ONE
        factorization (GPML section 5.4.2; exact_gp.loo_cv), no refits.
        Returns a dict with the per-point predictive "mean"/"var" (of the
        noisy observation, in y units), per-point "logp", and the scalar
        "pseudo_likelihood" = sum(logp). fit(objective="loo") maximizes
        it."""
        if self.basis is not None:
            raise NotImplementedError(
                "loo() is defined for the zero-mean model (basis=None)")
        p = self._params(params) if params is not None else self.params
        mu, var, logp = exact_gp.loo_cv(
            p, self.X, self.y, kind=self.kind, jitter=self.jitter,
            method=self.method)
        if self.normalize_y:
            logp = logp - math.log(self.y_std)
        return {"mean": self._out_mean(mu), "var": self._out_var(var),
                "logp": logp, "pseudo_likelihood": torch.sum(logp)}

    @torch.no_grad()
    def predict(self, Xs, *, include_noise=False, full_cov=False,
                batch=4096):
        """Posterior mean/variance at Xs, in test batches of `batch` rows
        against one factorization (full_cov: the full covariance). With a
        basis the semiparametric corrections apply (one batch) and the
        fitted coefficients land in self.beta."""
        Xs = _as_f32(Xs, self.device)
        if full_cov and include_noise:
            raise ValueError("full_cov returns the latent posterior "
                             "covariance; include_noise applies to the "
                             "diagonal path only")
        if self.basis is not None:
            if full_cov:
                mu, cov, self.beta = exact_gp.posterior_basis_full_cov(
                    self.params, self.X, self.y, Xs, kind=self.kind,
                    jitter=self.jitter, method=self.method,
                    basis=self.basis)
                return self._out_mean(mu), self._out_var(cov)
            mu, var, self.beta = exact_gp.posterior_basis(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method, basis=self.basis,
                include_noise=include_noise)
            return self._out_mean(mu), self._out_var(var)
        if full_cov:
            mu, cov = exact_gp.posterior_full_cov(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, method=self.method)
            return self._out_mean(mu), self._out_var(cov)
        L, alpha = exact_gp._factorize(self.params, self.X, self.y,
                                       self.kind, self.jitter, self.method)
        mus, vars_ = [], []
        for lo in range(0, Xs.shape[0], batch):
            mu, var = exact_gp.predict_from_factor(
                self.params, self.X, L, alpha, Xs[lo:lo + batch],
                kind=self.kind, method=self.method,
                include_noise=include_noise)
            mus.append(mu)
            vars_.append(var)
        return (self._out_mean(torch.cat(mus)),
                self._out_var(torch.cat(vars_)))

    @torch.no_grad()
    def sample_posterior(self, Xs, num_samples=8, generator=None,
                         jitter=1e-6, draws=None):
        """Function draws (num_samples, m) from the posterior at Xs:
        f = mu + L_s eps, L_s the Cholesky factor of the full posterior
        covariance (use a moderate m). eps: `draws`, an explicit
        (m, num_samples) standard-normal tensor, or else drawn from
        `generator` (a CPU generator seeded 0 by default)."""
        Xs = _as_f32(Xs, self.device)
        mu, cov = exact_gp.posterior_full_cov(
            self.params, self.X, self.y, Xs, kind=self.kind,
            jitter=self.jitter, method=self.method)
        m = cov.shape[0]
        # the fp32 posterior covariance can be numerically indefinite:
        # scale the jitter by its diagonal and climb the jitter ladder
        scale = torch.clamp(torch.mean(torch.diagonal(cov)), min=1e-12)
        eye = torch.eye(m, dtype=cov.dtype, device=cov.device)
        Ls = exact_gp.safe_cholesky(
            cov + jitter * scale * eye, scale, method=self.method,
            max_attempts=3, jitter0=max(jitter, 1e-6))
        if draws is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            eps = torch.randn((m, num_samples), generator=generator,
                              device=generator.device).to(self.device)
        else:
            eps = _as_f32(draws, self.device)
            if tuple(eps.shape) != (m, num_samples):
                raise ValueError(f"draws must be ({m}, {num_samples}), got "
                                 f"{tuple(eps.shape)}")
        return self._out_mean(mu[None, :] + (Ls @ eps).T)

    def save(self, path):
        """Persist hyperparameters and conditioning data
        (utils.checkpoint); the directory loads in either package."""
        from cugp_tpu_torch.utils import checkpoint

        checkpoint.save(path, {"params": self.params, "X": self.X,
                               "y": self.y},
                        extra_json={"kind": self.kind, "jitter": self.jitter,
                                    "method": self.method,
                                    "basis": self.basis,
                                    "normalize_y": self.normalize_y,
                                    "y_mean": self.y_mean,
                                    "y_std": self.y_std,
                                    "param_keys": sorted(self.params),
                                    "param_struct": _tree_struct(
                                        self.params)})

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a GP saved with save() by either package, with its
        tensors on `device`.

        The params tree is rebuilt from the saved structure (or, for
        checkpoints that predate it, from the saved key names). The JAX
        package's XLA routes ("xla", "blocked") load as "auto".
        """
        from cugp_tpu_torch.utils import checkpoint

        meta0 = checkpoint.peek_meta(path)
        if meta0 is None:
            raise FileNotFoundError(path)
        extra = meta0.get("extra", {})
        struct = extra.get("param_struct")
        if struct is not None:
            pprobe = _probe_from_struct(struct)
        else:
            keys = extra.get("param_keys")
            if keys is None:
                keys = ["log_lengthscale", "log_noise_var", "log_signal_var"]
                if meta0.get("num_leaves") == 6:
                    keys.append("log_alpha")
            pprobe = {k: np.zeros(()) for k in keys}
        probe = {"params": pprobe, "X": np.zeros((1, 1)), "y": np.zeros(1)}
        tree, meta = checkpoint.restore(path, probe)
        if tree is None:
            raise FileNotFoundError(path)
        extra = meta["extra"]
        method = extra["method"]
        gp = cls(kind=extra["kind"], jitter=extra["jitter"],
                 method=method if method in ("auto", "pallas") else "auto",
                 basis=extra.get("basis"), device=device)
        # condition with normalize_y off: the saved y is already
        # standardized; the recorded stats are restored afterwards
        gp.condition(tree["X"], tree["y"], params=tree["params"])
        gp.normalize_y = extra.get("normalize_y", False)
        gp.y_mean = extra.get("y_mean", 0.0)
        gp.y_std = extra.get("y_std", 1.0)
        return gp

    def _rng(self, generator, draws):
        """The samplers' random numbers: explicit draws (an hmc.Draws),
        else `generator`, else a CPU generator seeded 0 (its draws move to
        this GP's device, so they are the same on every device)."""
        from cugp_tpu_torch.inference import hmc

        if draws is not None:
            if not isinstance(draws, hmc.Draws):
                raise TypeError("draws must be an hmc.Draws")
            return draws
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return hmc.Draws(generator)

    def _sampler_init(self, init):
        if init is not None:
            return self._params(init)
        if self.params is not None:
            return self.params
        return kernel_ops.default_init(self.kind, d=self.X.shape[1],
                                       device=self.device)

    def sample_hyperparams(self, *, num_samples=512, num_chains=8,
                           num_warmup=256, sampler="nuts", generator=None,
                           draws=None, init=None, max_tree_depth=8,
                           chain_block=0):
        """Posterior over hyperparameters via NUTS/HMC (inference/
        sampling), the chains one batch on this GP's device. generator: a
        torch.Generator (a CPU one seeded 0 when None); or draws, an
        hmc.Draws replaying given standard normals and uniforms in the
        samplers' order. Returns a dict with "samples" (the params tree,
        (num_samples, num_chains, ...) leaves) and the sampler's
        diagnostics.

        With normalize_y=True the posterior is over the STANDARDIZED
        model's hyperparameters (signal/noise variances are in units of
        sigma_y^2; lengthscales are unaffected)."""
        from cugp_tpu_torch.inference import sampling

        return sampling.sample_hyperparams(
            self._sampler_init(init), self.X, self.y, kind=self.kind,
            jitter=self.jitter, method=self.method, num_samples=num_samples,
            num_chains=num_chains, num_warmup=num_warmup, sampler=sampler,
            rng=self._rng(generator, draws), max_tree_depth=max_tree_depth,
            chain_block=chain_block)

    def fit_vi(self, *, steps=2000, learning_rate=0.01, rank="meanfield",
               num_mc=8, generator=None, draws=None, init=None):
        """Variational posterior over hyperparameters (inference/vi), the
        ELBO's num_mc draws one batch on this GP's device; generator and
        draws as in sample_hyperparams. Same normalize_y caveat as
        sample_hyperparams."""
        from cugp_tpu_torch.inference import vi

        return vi.fit(
            self._sampler_init(init), self.X, self.y, kind=self.kind,
            jitter=self.jitter, method=self.method, steps=steps,
            learning_rate=learning_rate, rank=rank, num_mc=num_mc,
            rng=self._rng(generator, draws))

    def fit_sparse(self, X, y, *, num_inducing=512, steps=500,
                   learning_rate=0.05, optimize_inducing=True, seed=0):
        """SGPR fit (Titsias collapsed bound, models/sgpr.py): O(n m^2).
        Stores the inducing points in self.Z; predict_sparse serves the
        sparse posterior. Returns the info dict ("loss", "elbo")."""
        from cugp_tpu_torch.models import sgpr

        X, y = self._data(X, y)
        init = self.params or kernel_ops.default_init(
            self.kind, d=X.shape[1], device=self.device)
        params, Z, info = sgpr.fit(
            self._params(init), X, y, num_inducing=num_inducing,
            kind=self.kind, jitter=self.jitter, steps=steps,
            learning_rate=learning_rate,
            optimize_inducing=optimize_inducing, seed=seed)
        self.params, self.X, self.y = params, X, y
        self.Z = Z
        return info

    @torch.no_grad()
    def predict_sparse(self, Xs, *, include_noise=False):
        """Posterior mean/variance through the fitted inducing points."""
        from cugp_tpu_torch.models import sgpr

        mu, var = sgpr.posterior(self.params, self.Z, self.X, self.y,
                                 _as_f32(Xs, self.device), kind=self.kind,
                                 jitter=self.jitter,
                                 include_noise=include_noise)
        return self._out_mean(mu), self._out_var(var)

    def fit_classifier(self, X, y, **kw):
        """A GPClassifier with this GP's kind, jitter, method and device,
        fitted to (X, y)."""
        clf = GPClassifier(kind=self.kind, jitter=self.jitter,
                           method=self.method, device=self.device)
        clf.fit(X, y, **kw)
        return clf

    def fit_iterative(self, X, y, *, steps=50, learning_rate=0.05,
                      init=None, generator=None, log_prior=None, **kw):
        """Matrix-free MAP hyperparameter fit (map_opt.fit_iterative) for N
        beyond the dense ceiling: per step, preconditioned CG solves and a
        Hutchinson/AD gradient sweep; K is never formed. Extra kwargs
        (precond_rank, num_probes, tol, block, probes, probe_mode,
        checkpoint_dir, checkpoint_every, ...) pass through. Returns the
        info dict."""
        from cugp_tpu_torch.inference import map_opt

        X, y = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1],
                                           device=self.device)
        params, info = map_opt.fit_iterative(
            self._params(init), X, y, kind=self.kind, jitter=self.jitter,
            steps=steps, learning_rate=learning_rate, generator=generator,
            log_prior=log_prior, **kw)
        self.params, self.X, self.y = params, X, y
        self._precond_cache = None
        return info

    def _iterative_precond(self, precond_rank, params, key=None):
        """(Lk, Lg, s2) pivoted-Cholesky factors of `params` for the
        iterative entry points, cached by (key, X, rank) object identity;
        key is the caller's own dict (`params` by default), as the JAX GP
        caches the dict it was handed. "auto": rank 128 at n >= 8192, none
        below (small problems converge in few CG iterations anyway)."""
        from cugp_tpu_torch.inference import iterative

        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = 128 if n >= 8192 else 0
        if not precond_rank:
            return None
        key = params if key is None else key
        cached = getattr(self, "_precond_cache", None)
        if cached is not None:
            c_key, c_X, c_rank, fac = cached
            if c_key is key and c_X is self.X and c_rank == precond_rank:
                return fac
        fac = iterative.precond_factors(params, self.X, precond_rank,
                                        kind=self.kind, jitter=self.jitter)
        self._precond_cache = (key, self.X, precond_rank, fac)
        return fac

    def log_marginal_likelihood_iterative(self, params=None, *, block=4096,
                                          num_probes=16, num_steps=32,
                                          probes=None, generator=None,
                                          precond_rank="auto",
                                          segment_iters="auto"):
        """Matrix-free LML (CG + stochastic Lanczos quadrature). probes:
        the (n, num_probes) Rademacher probes, drawn from `generator`
        (seed 0 by default) when not given. CG runs under the pivoted-
        Cholesky preconditioner at n >= 8192 (precond_rank="auto"; 0
        disables it). segment_iters k > 0: CG in segments of k
        iterations (iterative.lml_iterative_segmented, its tolerance
        1e-4), a float back; "auto" is 0 off a TPU, as in the JAX
        package."""
        from cugp_tpu_torch.inference import iterative, map_opt

        p = self._params(params) if params is not None else self.params
        # keyed on the caller's dict: p is a new dict on every call
        pre = self._iterative_precond(precond_rank, p, key=params)
        seg = map_opt.resolve_iterative_schedule(segment_iters)[0]
        if seg:
            return self._out_lml(iterative.lml_iterative_segmented(
                p, self.X, self.y, Z=probes, generator=generator,
                kind=self.kind, jitter=self.jitter, block=block,
                iters_per_program=seg, num_probes=num_probes,
                num_steps=num_steps, precond=pre))
        return self._out_lml(iterative.lml_iterative(
            p, self.X, self.y, Z=probes, kind=self.kind, jitter=self.jitter,
            block=block, num_probes=num_probes, num_steps=num_steps,
            precond=pre, generator=generator))

    def predict_iterative(self, Xs, *, block=4096, tol=1e-6,
                          include_noise=False, precond_rank="auto",
                          segment_iters="auto", col_batch=256, stats=None):
        """Matrix-free posterior via batched CG solves (no N x N storage):
        the test columns are solved `col_batch` at a time, so memory stays
        O(n col_batch). stats: optional dict filled with the mean solve's
        alpha and the CG counts (iterative.posterior_iterative).
        segment_iters k > 0: the segmented schedule
        (iterative.posterior_iterative_segmented, tol at least 1e-5, as
        in the JAX package); "auto" is 0 off a TPU."""
        from cugp_tpu_torch.inference import iterative, map_opt

        Xs = _as_f32(Xs, self.device)
        pre = self._iterative_precond(precond_rank, self.params)
        seg = map_opt.resolve_iterative_schedule(segment_iters)[0]
        if seg:
            mu, var = iterative.posterior_iterative_segmented(
                self.params, self.X, self.y, Xs, kind=self.kind,
                jitter=self.jitter, block=block, tol=max(tol, 1e-5),
                iters_per_program=seg, include_noise=include_noise,
                precond=pre, col_batch=col_batch, stats=stats)
            return self._out_mean(mu), self._out_var(var)
        mu, var = iterative.posterior_iterative(
            self.params, self.X, self.y, Xs, kind=self.kind,
            jitter=self.jitter, block=block, tol=tol,
            include_noise=include_noise, precond=pre, col_batch=col_batch,
            stats=stats)
        return self._out_mean(mu), self._out_var(var)


def _restore(path, probe_of):
    """(tree, extra) of a checkpoint directory written by either package;
    probe_of(extra) gives the tree's shape."""
    from cugp_tpu_torch.utils import checkpoint

    meta0 = checkpoint.peek_meta(path)
    if meta0 is None:
        raise FileNotFoundError(path)
    extra = meta0.get("extra", {})
    tree, _meta = checkpoint.restore(path, probe_of(extra))
    if tree is None:
        raise FileNotFoundError(path)
    return tree, extra


@dataclasses.dataclass
class GPClassifier:
    """GP classification.

    Two classes route to the binary model: inference="laplace"
    (models/gpc, logistic likelihood, GPML Alg 3.1/3.2, MacKay's probit
    predictive) or inference="ep" (models/gpc_ep, probit likelihood,
    parallel EP, GPML ch. 3.6; its predictive probit integral is exact).
    Three or more classes route to the multiclass softmax-Laplace model
    (models/gpc_multiclass, GPML Alg 3.3/3.4; predict_proba returns an
    (m, C) matrix in classes_ order; EP is binary-only). Labels may be
    anything NumPy can sort; predict() returns them in their original
    form via classes_. device: as GP's ("cuda" by default).
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    inference: str = "laplace"   # laplace | ep (binary only)
    device: Any = "cuda"
    params: Optional[dict] = None
    X: Optional[Any] = None
    y: Optional[Any] = None
    classes_: Optional[Any] = None

    def __post_init__(self):
        kernel_ops.validate_kind(self.kind)
        kernel_ops.check_method(self.method)
        self.device = torch.device(self.device)

    def _data(self, X, y):
        from cugp_tpu_torch.models import gpc_multiclass

        X = _as_f32(X, self.device)
        y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
        classes = np.unique(y)
        if classes.shape[0] < 2:
            raise ValueError(f"need at least 2 classes, got {classes}")
        self.classes_ = classes
        if classes.shape[0] == 2:
            ypm = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
            return X, _as_f32(ypm, self.device)
        return X, gpc_multiclass.one_hot(np.searchsorted(classes, y),
                                         classes.shape[0], self.device)

    @property
    def _multiclass(self):
        return self.classes_ is not None and len(self.classes_) > 2

    def _model(self):
        from cugp_tpu_torch.models import gpc, gpc_ep, gpc_multiclass

        if self._multiclass:
            if self.inference == "ep":
                raise ValueError("inference='ep' is binary-only; "
                                 "multiclass uses the softmax Laplace")
            return gpc_multiclass
        if self.inference == "ep":
            return gpc_ep
        if self.inference == "laplace":
            return gpc
        raise ValueError(f"unknown inference {self.inference!r}")

    def fit(self, X, y, *, steps=100, learning_rate=0.05, init=None,
            num_newton=20):
        """MAP hyperparameters by Adam on the approximate marginal
        likelihood; returns the info dict ("loss", "lml")."""
        X, yenc = self._data(X, y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1],
                                           device=self.device)
        params, info = self._model().fit(
            tree_map(lambda v: _as_f32(v, self.device), init), X, yenc,
            kind=self.kind, jitter=self.jitter, method=self.method,
            steps=steps, learning_rate=learning_rate, num_newton=num_newton)
        self.params, self.X, self.y = params, X, yenc
        return info

    @torch.no_grad()
    def predict_proba(self, Xs, *, num_newton=20, normals=None):
        """p(y = classes_[1]) (binary) or the (m, C) class probabilities
        (multiclass; their Monte Carlo normals are `normals`, a (512, C)
        tensor, else a CPU generator's seeded 0)."""
        kw = dict(kind=self.kind, jitter=self.jitter, method=self.method)
        if self._multiclass:
            kw.update(num_newton=num_newton, normals=normals)
        elif self.inference != "ep":
            kw.update(num_newton=num_newton)
        p, _, _ = self._model().predict_proba(
            self.params, self.X, self.y, _as_f32(Xs, self.device), **kw)
        return p

    def predict(self, Xs):
        """Labels in the original label set."""
        proba = self.predict_proba(Xs)
        if self._multiclass:
            return self.classes_[torch.argmax(proba, dim=1).cpu().numpy()]
        return self.classes_[(proba > 0.5).cpu().numpy().astype(np.int64)]

    def save(self, path):
        """Persist hyperparameters, conditioning data and the label set
        (utils.checkpoint); the directory loads in either package."""
        from cugp_tpu_torch.utils import checkpoint

        checkpoint.save(
            path, {"params": self.params, "X": self.X, "y": self.y,
                   "classes": np.asarray(self.classes_)},
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "method": self.method, "model": "gpc",
                        "inference": self.inference,
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a classifier saved by either package, its tensors on
        `device` (the JAX package's XLA routes load as "auto")."""
        tree, extra = _restore(path, lambda extra: {
            "params": _probe_from_struct(extra["param_struct"]),
            "X": np.zeros((1, 1)), "y": np.zeros(1), "classes": np.zeros(1)})
        method = extra["method"]
        clf = cls(kind=extra["kind"], jitter=extra["jitter"],
                  method=method if method in ("auto", "pallas") else "auto",
                  inference=extra.get("inference", "laplace"), device=device)
        clf.params = tree_map(lambda v: _as_f32(v, clf.device),
                              tree["params"])
        clf.X = _as_f32(tree["X"], clf.device)
        clf.y = _as_f32(tree["y"], clf.device)
        clf.classes_ = np.asarray(tree["classes"])
        return clf


@dataclasses.dataclass
class SVGP:
    """Stochastic variational GP (models/svgp): minibatch SGD on the
    uncollapsed inducing-point bound, past both the exact model and SGPR
    in n, and with non-Gaussian likelihoods.

    likelihood: 'gaussian' (regression) | 'bernoulli' (classification,
    labels mapped to {-1, +1}) | 'poisson' (counts, log link) |
    'student_t' (robust regression, learnable nu). device: as GP's
    ("cuda" by default).
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    likelihood: str = "gaussian"
    device: Any = "cuda"
    params: Optional[dict] = None
    Z: Optional[Any] = None
    vp: Optional[dict] = None

    def __post_init__(self):
        from cugp_tpu_torch.models import svgp as svgp_mod

        kernel_ops.validate_kind(self.kind)
        if self.likelihood not in svgp_mod.LIKELIHOODS:
            raise ValueError(
                f"unknown likelihood {self.likelihood!r}; supported: "
                f"{svgp_mod.LIKELIHOODS}")
        self.device = torch.device(self.device)

    def _encode(self, y):
        """y -> {-1,+1} for bernoulli. Reuses the classes recorded at fit
        time when present, so elbo() on a single-class slice encodes
        consistently instead of re-inferring labels per call."""
        if self.likelihood != "bernoulli":
            return _as_f32(y, self.device), None
        y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
        classes = getattr(self, "_classes", None)
        if classes is None:
            classes = np.unique(y)
            if classes.shape[0] != 2:
                raise ValueError(f"need exactly 2 classes, got {classes}")
        elif not np.isin(y, classes).all():
            raise ValueError(
                f"labels {np.unique(y)} not within fitted classes {classes}")
        return _as_f32(np.where(y == classes[1], 1.0, -1.0), self.device), \
            classes

    def fit(self, X, y, *, num_inducing=256, steps=2000, batch=256,
            learning_rate=0.01, optimize_inducing=True, init=None, seed=0):
        """svgp.fit with its defaults (minibatch indices drawn with
        replacement from a CPU generator seeded `seed`); returns the info
        dict ("loss", "elbo_batch_final")."""
        from cugp_tpu_torch.models import svgp as svgp_mod

        X = _as_f32(X, self.device)
        y, self._classes = self._encode(y)
        if init is None:
            init = kernel_ops.default_init(self.kind, d=X.shape[1],
                                           device=self.device)
        self.params, self.Z, self.vp, info = svgp_mod.fit(
            tree_map(lambda v: _as_f32(v, self.device), init), X, y,
            num_inducing=num_inducing, kind=self.kind, jitter=self.jitter,
            likelihood=self.likelihood, steps=steps, batch=batch,
            learning_rate=learning_rate,
            optimize_inducing=optimize_inducing, seed=seed)
        return info

    @torch.no_grad()
    def predict(self, Xs, *, include_noise=False):
        """Predictive mean/variance (gaussian/student_t), rate and its
        variance (poisson), or hard labels in the original label set
        (bernoulli)."""
        from cugp_tpu_torch.models import svgp as svgp_mod

        Xs = _as_f32(Xs, self.device)
        if self.likelihood == "bernoulli":
            pos = (self.predict_proba(Xs) > 0.5).cpu().numpy()
            classes = getattr(self, "_classes", None)
            if classes is None:
                return np.where(pos, 1, -1)
            return np.where(pos, classes[1], classes[0])
        if self.likelihood == "poisson":
            return svgp_mod.predict_rate(self.params, self.Z, self.vp, Xs,
                                         kind=self.kind, jitter=self.jitter)
        return svgp_mod.posterior(self.params, self.Z, self.vp, Xs,
                                  kind=self.kind, jitter=self.jitter,
                                  include_noise=include_noise,
                                  likelihood=self.likelihood)

    @torch.no_grad()
    def predict_proba(self, Xs):
        from cugp_tpu_torch.models import svgp as svgp_mod

        if self.likelihood != "bernoulli":
            raise ValueError("predict_proba needs likelihood='bernoulli'")
        p, _, _ = svgp_mod.predict_proba(self.params, self.Z, self.vp,
                                         _as_f32(Xs, self.device),
                                         kind=self.kind, jitter=self.jitter)
        return p

    @torch.no_grad()
    def elbo(self, X, y):
        """Full-batch bound at the fitted state (diagnostic)."""
        from cugp_tpu_torch.models import svgp as svgp_mod

        y, _ = self._encode(y)
        return svgp_mod.elbo(self.params, self.Z, self.vp,
                             _as_f32(X, self.device), y, kind=self.kind,
                             jitter=self.jitter, likelihood=self.likelihood)

    def save(self, path):
        """Persist hyperparameters, inducing points and q(v): the whole
        predictive state (the training data is not needed to predict);
        the directory loads in either package."""
        from cugp_tpu_torch.utils import checkpoint

        tree = {"params": self.params, "Z": self.Z, "vp": self.vp}
        classes = getattr(self, "_classes", None)
        if classes is not None:
            tree["classes"] = np.asarray(classes)
        checkpoint.save(
            path, tree,
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "likelihood": self.likelihood, "model": "svgp",
                        "has_classes": classes is not None,
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a model saved by either package, on `device`."""
        def probe_of(extra):
            probe = {"params": _probe_from_struct(extra["param_struct"]),
                     "Z": np.zeros((1, 1)),
                     "vp": {"m": np.zeros(1), "c": np.zeros(1)}}
            if extra.get("has_classes"):
                probe["classes"] = np.zeros(1)
            return probe

        tree, extra = _restore(path, probe_of)
        model = cls(kind=extra["kind"], jitter=extra["jitter"],
                    likelihood=extra["likelihood"], device=device)
        model.params = tree_map(lambda v: _as_f32(v, model.device),
                                tree["params"])
        model.Z = _as_f32(tree["Z"], model.device)
        model.vp = tree_map(lambda v: _as_f32(v, model.device), tree["vp"])
        if extra.get("has_classes"):
            model._classes = np.asarray(tree["classes"])
        return model


@dataclasses.dataclass
class MultiOutputGP:
    """Correlated multi-output GP regression (LMC / intrinsic
    coregionalization, models/lmc.py).

    Joint prior covariance B (x) K with learnable low-rank-plus-diagonal
    B = A A^T + diag(softplus(raw_d)) (rank: A's columns); solved exactly
    at O(p n^3) via the eigendecomposition rotation (one (p, n, n)
    batched Cholesky, no pn x pn matrix). For UNCORRELATED outputs
    sharing one kernel use GP with exact_gp.*_multi instead. device: as
    GP's ("cuda" by default).
    """

    kind: str = "rbf"
    jitter: float = 1e-6
    method: str = "auto"
    rank: int = 1
    device: Any = "cuda"
    params: Optional[dict] = None
    X: Optional[Any] = None
    Y: Optional[Any] = None

    def __post_init__(self):
        kernel_ops.validate_kind(self.kind)
        kernel_ops.check_method(self.method)
        self.device = torch.device(self.device)

    def fit(self, X, Y, *, steps=200, learning_rate=0.05, init=None,
            seed=0):
        """MAP fit of kernel + coregionalization params (lmc.fit); init
        defaults to lmc.init_lmc_params(q=rank, seed=seed), whose mixing
        factors come from a CPU generator seeded `seed`. Returns the info
        dict ("loss", "lml")."""
        from cugp_tpu_torch.models import lmc

        X, Y = _multi_data(X, Y, self.device)
        if init is None:
            init = lmc.init_lmc_params(d=X.shape[1], p=Y.shape[1],
                                       q=self.rank, seed=seed,
                                       device=self.device)
        params, info = lmc.fit(
            tree_map(lambda v: _as_f32(v, self.device), init), X, Y,
            kind=self.kind, jitter=self.jitter, method=self.method,
            steps=steps, learning_rate=learning_rate)
        self.params, self.X, self.Y = params, X, Y
        return info

    def _fitted(self):
        if self.params is None:
            raise RuntimeError("call fit() first")

    @torch.no_grad()
    def predict(self, Xs, *, include_noise=False, full_output_cov=False):
        """Mean (m, p) and per-point output variance (m, p), or the full
        (m, p, p) cross-output covariance with full_output_cov=True."""
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.posterior_lmc(
            self.params, self.X, self.Y, _as_f32(Xs, self.device),
            kind=self.kind, jitter=self.jitter, method=self.method,
            include_noise=include_noise, full_output_cov=full_output_cov)

    @torch.no_grad()
    def log_marginal_likelihood(self):
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.log_marginal_likelihood_lmc(
            self.params, self.X, self.Y, kind=self.kind,
            jitter=self.jitter, method=self.method)

    @torch.no_grad()
    def output_correlation(self):
        """Fitted B normalized to a correlation matrix (p, p)."""
        from cugp_tpu_torch.models import lmc

        B = lmc.coregionalization(self.params)
        s = torch.sqrt(torch.diagonal(B))
        return B / (s[:, None] * s[None, :])

    def save(self, path):
        """Persist hyperparameters and conditioning data; the directory
        loads in either package."""
        from cugp_tpu_torch.utils import checkpoint

        checkpoint.save(
            path, {"params": self.params, "X": self.X, "Y": self.Y},
            extra_json={"kind": self.kind, "jitter": self.jitter,
                        "method": self.method, "rank": self.rank,
                        "model": "lmc",
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a model saved by either package, on `device` (the JAX
        package's XLA routes load as "auto")."""
        tree, extra = _restore(path, _multi_probe)
        method = extra["method"]
        model = cls(kind=extra["kind"], jitter=extra["jitter"],
                    method=method if method in ("auto", "pallas") else "auto",
                    rank=extra.get("rank", 1), device=device)
        _multi_restore(model, tree)
        return model


@dataclasses.dataclass
class MultiOutputGPQ:
    """Rank-Q LMC multi-output GP with DISTINCT latent kernels
    (models/lmc.py's lmcq family): joint prior sum_q (a_q a_q^T) (x) K_q,
    e.g. one periodic + one RBF latent process mixing into p outputs.

    Unlike MultiOutputGP (ICM: one shared kernel, eigendecomposition
    rotation), the rank-Q model has no common rotation: exact inference
    factors the dense pn x pn covariance, or, past the dense ceiling,
    runs matrix-free on the sum-of-Kronecker operator
    (predict_iterative / log_marginal_likelihood_iterative: CG + SLQ,
    Sigma never formed; one matvec-kernel launch per latent a product).
    device: as GP's ("cuda" by default).
    """

    kinds: tuple = ("rbf", "rbf")
    jitter: float = 1e-6
    device: Any = "cuda"
    params: Optional[dict] = None
    X: Optional[Any] = None
    Y: Optional[Any] = None

    def __post_init__(self):
        self.kinds = tuple(self.kinds)
        for kind in self.kinds:
            kernel_ops.validate_kind(kind)
        self.device = torch.device(self.device)

    def _init(self, seed):
        from cugp_tpu_torch.models import lmc

        return lmc.init_lmcq_params(d=self.X.shape[1], p=self.Y.shape[1],
                                    kinds=self.kinds, seed=seed,
                                    device=self.device)

    def _params(self, params):
        return tree_map(lambda v: _as_f32(v, self.device), params)

    def fit(self, X, Y, *, steps=200, learning_rate=0.05, init=None,
            seed=0):
        """MAP fit on the dense LML (lmc.fit_lmcq); init defaults to
        lmc.init_lmcq_params(seed=seed). Returns the info dict ("loss",
        "lml")."""
        from cugp_tpu_torch.models import lmc

        self.X, self.Y = _multi_data(X, Y, self.device)
        init = self._init(seed) if init is None else self._params(init)
        self.params, info = lmc.fit_lmcq(
            init, self.X, self.Y, kinds=self.kinds, jitter=self.jitter,
            steps=steps, learning_rate=learning_rate)
        return info

    def condition(self, X, Y, params=None, seed=0):
        """Attach data (and optionally params) without fitting."""
        self.X, self.Y = _multi_data(X, Y, self.device)
        self.params = (self._params(params) if params is not None
                       else self._init(seed))
        return self

    def _fitted(self):
        if self.params is None:
            raise RuntimeError("call fit() or condition() first")

    @torch.no_grad()
    def predict(self, Xs, *, include_noise=False):
        """Dense posterior: mean (m, p) and per-output variance (m, p)."""
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.posterior_lmcq(
            self.params, self.X, self.Y, _as_f32(Xs, self.device),
            self.kinds, jitter=self.jitter, include_noise=include_noise)

    def predict_iterative(self, Xs, *, include_noise=False, block=4096,
                          tol=1e-6, max_iters=1000, col_batch=256,
                          segment_iters="auto", stats=None):
        """Matrix-free posterior on the joint operator: the path past the
        dense pn ceiling, everything on this model's device. segment_iters:
        k > 0 runs CG in segments of k iterations (one host read a
        segment); "auto" is 0, as off a TPU in the JAX package. stats: as
        lmc.posterior_lmcq_iterative's."""
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.posterior_lmcq_iterative(
            self.params, self.X, self.Y, _as_f32(Xs, self.device),
            self.kinds, jitter=self.jitter, block=block, tol=tol,
            max_iters=max_iters, include_noise=include_noise,
            col_batch=col_batch, segment_iters=segment_iters, stats=stats)

    @torch.no_grad()
    def log_marginal_likelihood(self):
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.log_marginal_likelihood_lmcq(
            self.params, self.X, self.Y, self.kinds, jitter=self.jitter)

    @torch.no_grad()
    def log_marginal_likelihood_iterative(self, *, block=4096,
                                          num_probes=16, num_steps=32,
                                          tol=1e-5, max_iters=1000,
                                          probes=None, generator=None):
        """Matrix-free LML (CG + SLQ on the joint operator). probes: the
        (pn, num_probes) Rademacher probes, drawn from `generator` (a CPU
        generator seeded 0 when None) when not given."""
        from cugp_tpu_torch.models import lmc

        self._fitted()
        return lmc.log_marginal_likelihood_lmcq_iterative(
            self.params, self.X, self.Y, self.kinds,
            Z=None if probes is None else _as_f32(probes, self.device),
            generator=generator, jitter=self.jitter, block=block, tol=tol,
            max_iters=max_iters, num_probes=num_probes, num_steps=num_steps)

    def save(self, path):
        """Persist the params tree and conditioning data; the directory
        loads in either package."""
        from cugp_tpu_torch.utils import checkpoint

        checkpoint.save(
            path, {"params": self.params, "X": self.X, "Y": self.Y},
            extra_json={"kinds": list(self.kinds), "jitter": self.jitter,
                        "model": "lmcq",
                        "param_struct": _tree_struct(self.params)})

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a model saved by either package, on `device`."""
        tree, extra = _restore(path, _multi_probe)
        model = cls(kinds=tuple(extra["kinds"]), jitter=extra["jitter"],
                    device=device)
        _multi_restore(model, tree)
        return model


def _multi_data(X, Y, device):
    X, Y = _as_f32(X, device), _as_f32(Y, device)
    if Y.ndim != 2:
        raise ValueError(f"Y must be (n, p); got {tuple(Y.shape)}")
    return X, Y


def _multi_probe(extra):
    return {"params": _probe_from_struct(extra["param_struct"]),
            "X": np.zeros((1, 1)), "Y": np.zeros((1, 1))}


def _multi_restore(model, tree):
    model.params = tree_map(lambda v: _as_f32(v, model.device),
                            tree["params"])
    model.X = _as_f32(tree["X"], model.device)
    model.Y = _as_f32(tree["Y"], model.device)
