"""MAP hyperparameter optimization, as ``cugp_tpu/inference/map_opt.py``.

``fit`` (dense): the JAX package runs the optimizer as one jitted
``lax.scan``; here it is a Python loop. Adam is ``torch.optim.Adam`` on
leaf tensors (b1=0.9, b2=0.999, eps=1e-8 outside the root: the same
update as ``optax.adam``), through ``adam_fit``, which also carries
``optax.apply_if_finite``'s rule (``FiniteGuard``: a step whose gradient
is not finite is skipped and leaves the optimizer state untouched,
until ``max_consecutive_errors`` of them in a row) and, for the SVGP
fit, ``optax.clip_by_global_norm``. The model fits (sgpr, svgp, gpc,
gpc_ep, gpc_multiclass) and ``vi.fit`` run the same loop. L-BFGS is
``inference/_lbfgs`` (``optax.lbfgs`` with the same defaults) on the
flattened leaves. The objective is the negative LML, the
negative marginalized-basis LML, or the negative LOO pseudo-likelihood,
minus an optional log prior. ``fit_restarts`` runs ``fit`` from
perturbed starts and keeps the best. ``fit_iterative`` (matrix-free):
Adam over the Hutchinson gradient estimator, without the finite check
(plain ``optax.adam`` in the JAX package). Every iterate is clamped into
the box of ``_BOUNDS``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cugp_tpu_torch.inference._lbfgs import LBFGS
from cugp_tpu_torch.models import exact_gp
from cugp_tpu_torch.utils import profiling
from cugp_tpu_torch.utils.params import tree_leaves, tree_map


def _neg_lml(params, X, y, kind, jitter, method, basis=None,
             log_prior=None, objective="lml"):
    if objective not in ("lml", "loo"):
        raise ValueError(f"unknown objective {objective!r}: lml | loo")
    if objective == "loo":
        if basis is not None:
            raise NotImplementedError(
                "objective='loo' is defined for the zero-mean model; "
                "combine with basis=None (GPML 5.4.2 derives it for the "
                "plain LML factorization)")
        val = -exact_gp.loo_pseudo_likelihood(
            params, X, y, kind=kind, jitter=jitter, method=method)
    elif basis is not None:
        val = -exact_gp.log_marginal_likelihood_basis(
            params, X, y, kind=kind, jitter=jitter, method=method,
            basis=basis)
    else:
        val = -exact_gp.log_marginal_likelihood(
            params, X, y, kind=kind, jitter=jitter, method=method)
    if log_prior is not None:
        val = val - log_prior(params)
    return val


# Box constraints on log-hyperparameters: fp32 Cholesky fails (NaN) in the
# tiny-noise / huge-lengthscale corners; these keep every iterate
# factorizable (the same box as the JAX package).
_BOUNDS = {
    "log_lengthscale": (-6.0, 6.0),
    "log_signal_var": (-8.0, 8.0),
    "log_noise_var": (-9.0, 5.0),
    "log_alpha": (-4.0, 6.0),
    "log_period": (-6.0, 6.0),
    "log_bias_var": (-8.0, 8.0),
    "log_nu": (0.1, 6.0),
}


@torch.no_grad()
def _clamp(params):
    """Clip every bounded log-hyperparameter IN PLACE (Adam's leaf
    tensors), recursing through the terms/factors of composite kernels."""
    if isinstance(params, dict):
        for k, v in params.items():
            if k in _BOUNDS and isinstance(v, torch.Tensor):
                v.clamp_(*_BOUNDS[k])
            else:
                _clamp(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            _clamp(v)
    return params


class FiniteGuard:
    """``optax.apply_if_finite(inner, max_consecutive_errors)``'s rule
    around a torch optimizer: a step whose gradient is not finite is
    skipped, its optimizer state untouched, while the count of such
    steps in a row is at most max_consecutive_errors; past it the update
    is applied, non-finite as it is, until a finite step resets the
    count."""

    def __init__(self, max_consecutive_errors):
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0

    def apply(self, grads):
        """Whether this step's update is applied (one host read)."""
        finite = profiling.read_bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all(),
            "finite_guard")
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        return finite or self.notfinite_count > self.max_consecutive_errors


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm):
    """``optax.clip_by_global_norm`` in place: every gradient times
    max_norm / global_norm when global_norm >= max_norm (no epsilon)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def adam_fit(trainables, loss_fn, *, steps, learning_rate,
             max_consecutive_errors, grad_clip=None, clamp=True):
    """Adam over a tree of tensors, as the JAX package's scan of
    ``optax.apply_if_finite(optax.adam(lr), max_consecutive_errors)``
    (with ``optax.clip_by_global_norm(grad_clip)`` before Adam when
    grad_clip is given). loss_fn(trainables, step) is the scalar to
    minimize; after each step the bounded log-hyperparameters are
    clamped (``_clamp``) unless clamp is False. Returns (the trained
    tree, detached; the (steps,) losses at each step's pre-update
    point)."""
    tr = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                  trainables)
    leaves = tree_leaves(tr)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    guard = FiniteGuard(max_consecutive_errors)
    losses = []
    for step in range(steps):
        with profiling.span("cugp.step", leaves[0].device, root=True):
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = loss_fn(tr, step)
                loss.backward()
            losses.append(loss.detach())
            for p in leaves:  # a leaf the loss does not reach: zero grad
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in leaves]
            if guard.apply(grads):
                if grad_clip is not None:
                    clip_by_global_norm_(grads, grad_clip)
                opt.step()
            if clamp:
                _clamp(tr)
    return tree_map(lambda t: t.detach(), tr), torch.stack(losses)


def fit(init_params, X, y, *, kind="rbf", jitter=1e-6, method="auto",
        steps=200, optimizer="adam", learning_rate=0.05, basis=None,
        log_prior=None, objective="lml"):
    """Maximize the LML (or log posterior) over log-hyperparameters.

    objective: "lml" or "loo" (the leave-one-out pseudo-likelihood,
    exact_gp.loo_pseudo_likelihood). basis: None, "constant" or "linear"
    (the marginalized-basis LML). log_prior: optional callable params ->
    scalar log-density added to the objective (weak_log_prior is the
    samplers' default). optimizer: "adam" or "lbfgs" (learning_rate is
    ignored: the line search sets each step).

    Returns (params, info): info["loss"] holds the negative objective at
    each step's pre-update params, info["lml"] = -loss[-1]; L-BFGS adds
    info["linesearch_steps"], the trial points of each step's search.
    """
    loss_fn = functools.partial(
        _neg_lml, X=X, y=y, kind=kind, jitter=jitter, method=method,
        basis=basis, log_prior=log_prior, objective=objective)
    if optimizer == "lbfgs":
        return _fit_lbfgs(init_params, loss_fn, steps)
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer: {optimizer}")
    # optax.apply_if_finite(optax.adam(lr), 1000), as the JAX package's
    params, loss_trace = adam_fit(
        init_params, lambda p, _step: loss_fn(p), steps=steps,
        learning_rate=learning_rate, max_consecutive_errors=1000)
    return params, {"loss": loss_trace, "lml": -loss_trace[-1]}


def _fit_lbfgs(init_params, loss_fn, steps):
    """L-BFGS over the flattened leaves: per step, the objective and its
    gradient at the (clamped) iterate, one line search along the L-BFGS
    direction, then the clamp, as the JAX scan body does."""
    leaves = tree_leaves(init_params)
    sizes = [t.numel() for t in leaves]

    def unflatten(flat):
        parts = iter(torch.split(flat, sizes))
        return tree_map(lambda t: next(parts).view(t.shape), init_params)

    def value_and_grad(flat):
        x = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss_fn(unflatten(x))
            (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    x = torch.cat([t.detach().reshape(-1) for t in leaves])
    opt = LBFGS()
    losses, trials = [], []
    for _ in range(steps):
        value, grad = value_and_grad(x)
        losses.append(value)
        x, n = opt.step(x, value, grad, value_and_grad)
        _clamp(unflatten(x))  # in place, through the views
        trials.append(n)
    loss_trace = torch.stack(losses)
    params = tree_map(lambda t: t.clone(), unflatten(x))
    return params, {"loss": loss_trace, "lml": -loss_trace[-1],
                    "linesearch_steps": np.asarray(trials, np.int32)}


def weak_log_prior(params):
    """N(0, 3^2) on every log-hyperparameter leaf: the dict-space twin of
    the samplers' default prior on the flat chain vector."""
    return sum(torch.sum(-0.5 * (v / 3.0) ** 2) for v in tree_leaves(params))


def _restart_starts(init_params, restarts, generator, scale):
    """Start 0 is init_params exactly; the others add N(0, scale^2) to
    every leaf, drawn from `generator` on its own device."""
    starts = [init_params]
    for _ in range(1, restarts):
        starts.append(tree_map(
            lambda t: t + scale * torch.randn(
                t.shape, generator=generator, dtype=t.dtype,
                device=generator.device).to(t.device), init_params))
    return starts


def fit_restarts(init_params, X, y, *, restarts=4, generator=None,
                 scale=0.5, kind="rbf", jitter=1e-6, method="auto",
                 steps=200, optimizer="adam", learning_rate=0.05, basis=None,
                 log_prior=None, objective="lml"):
    """Multi-start MAP: `restarts` perturbed inits, each optimized by
    ``fit`` (the LML surface is multimodal in lengthscale/period space and
    single-start Adam gets trapped). The JAX package vmaps the starts into
    one program; here they run one after another.

    Start 0 is init_params exactly; the rest perturb every leaf with
    N(0, scale^2) noise from `generator` (a CPU generator seeded 0 by
    default). A non-finite final objective never wins. Returns
    (best_params, info) where info adds "restart_lmls" (the per-start
    final objectives) and "best_restart".
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    runs = [fit(p, X, y, kind=kind, jitter=jitter, method=method,
                steps=steps, optimizer=optimizer, learning_rate=learning_rate,
                basis=basis, log_prior=log_prior, objective=objective)
            for p in _restart_starts(init_params, restarts, generator, scale)]
    finals = torch.stack([info["loss"][-1] for _, info in runs])
    finals = torch.where(torch.isfinite(finals), finals, math.inf)
    best = int(torch.argmin(finals))
    params, info = runs[best]
    return params, {"loss": info["loss"], "lml": -finals[best],
                    "restart_lmls": -finals, "best_restart": best}


def _tree_add(a, b):
    """a + b leaf by leaf, matching dict leaves by key."""
    if isinstance(a, dict):
        return {k: _tree_add(v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_add(u, v) for u, v in zip(a, b))
    return a + b


def _value_and_grad(fn, params):
    """(fn(params), its gradient in params' nesting); a value that does not
    depend on the params has zero gradient, as under jax.value_and_grad."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        value = fn(p)
        if isinstance(value, torch.Tensor) and value.requires_grad:
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        else:
            grads = [None] * len(leaves)
    grads = iter([torch.zeros_like(t) if g is None else g
                  for t, g in zip(leaves, grads)])
    value = torch.as_tensor(value, dtype=torch.float32).detach()
    return value, tree_map(lambda _: next(grads), p)


def resolve_iterative_schedule(segment_iters="auto", precond_where="auto"):
    """(segment_iters, precond_where) with "auto" resolved as the JAX
    package resolves it off a TPU: no segments (one tolerance loop a
    solve) and the preconditioner built on the device."""
    if segment_iters in ("auto", None):
        segment_iters = 0
    if (isinstance(segment_iters, (bool, float, str))
            or int(segment_iters) < 0):
        raise ValueError(f"segment_iters must be 'auto' or an int >= 0, "
                         f"got {segment_iters!r}")
    if precond_where == "auto":
        precond_where = "device"
    if precond_where not in ("device", "host"):
        raise ValueError(f"unknown precond_where {precond_where!r}")
    return int(segment_iters), precond_where


def _adam_state(opt, params):
    """torch Adam's state over params' leaves as optax.adam's leaves
    [count (int32), mu, nu], mu and nu nested like params."""
    state = {id(p): opt.state.get(p, {}) for p in tree_leaves(params)}
    count = max((int(st["step"]) for st in state.values() if st), default=0)

    def moment(name):
        return tree_map(lambda p: state[id(p)].get(name, torch.zeros_like(p)),
                        params)

    return [np.asarray(count, np.int32), moment("exp_avg"),
            moment("exp_avg_sq")]


@torch.no_grad()
def _restore_fit_state(path, params, opt, kind, n):
    """Load a fit_iterative checkpoint at `path` (either package's) into
    params (in place) and opt's state. Returns (its step, its losses as
    floats); (0, []) when there is none."""
    from cugp_tpu_torch.utils import checkpoint
    from cugp_tpu_torch.utils.params import params_to_numpy

    p_np = params_to_numpy(params)
    tree, meta = checkpoint.restore(path, {
        "losses": np.zeros(0, np.float32),
        "opt": [np.zeros((), np.int32), p_np, p_np], "params": p_np})
    if tree is None:
        return 0, []
    extra = meta.get("extra", {})
    if (extra.get("kind", kind), extra.get("n", n)) != (kind, n):
        raise ValueError(f"{path} holds the fit state of kind="
                         f"{extra.get('kind')!r}, n={extra.get('n')}; this "
                         f"fit is kind={kind!r}, n={n}")
    count, mu, nu = tree["opt"]
    for p, v, m, s2 in zip(tree_leaves(params), tree_leaves(tree["params"]),
                           tree_leaves(mu), tree_leaves(nu)):
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{path}: a saved leaf has shape {v.shape}, "
                             f"the params' {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.asarray(v, np.float32)))
        if int(count):
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(
                    np.array(m, np.float32)).to(p.device),
                "exp_avg_sq": torch.from_numpy(
                    np.array(s2, np.float32)).to(p.device)}
    return int(meta["step"]), [float(v) for v in tree["losses"]]


def fit_iterative(init_params, X, y, *, kind="rbf", jitter=1e-6, steps=50,
                  learning_rate=0.05, block=4096, tol=1e-4, max_iters=400,
                  num_probes=16, precond_rank=128, precond_refresh="auto",
                  precond_where="auto", split_programs="auto",
                  generator=None, probes=None, log_prior=None,
                  grad_method="ad", callback=None, checkpoint_dir=None,
                  checkpoint_every=5, segment_iters="auto",
                  probe_mode="fresh", warm_start=True, refresh_factor=1.5,
                  final_lml=False, verbose=False):
    """Matrix-free MAP fit: Adam over the Hutchinson gradient estimator
    (iterative.lml_value_and_grad_iterative), K never formed.

    Per step: one preconditioned batched CG for [y | probes] and one
    rematerialized gradient sweep. Adam runs on the host over the negated
    gradients (maximization), then every iterate is clamped.

    precond_rank > 0: pivoted-Cholesky preconditioner factors, rebuilt
    every `precond_refresh` steps, or with "auto" adaptively: when a
    step's CG count exceeds `refresh_factor` x the best since the last
    rebuild. precond_where: "device" (precond_factors), "host"
    (precond_factors_host: NumPy float64) or "auto" (the device).
    split_programs: True runs solve and gradient sweep as separate calls
    (the only path that counts CG iterations, warm-starts and refreshes
    adaptively); "auto" means n >= 32768, as in the JAX package, so the
    same call follows the same trajectory in both. segment_iters: k > 0
    runs the [y | z] solve in segments of k CG iterations
    (iterative.cg_solve_segmented, one host read a segment; its counts
    are multiples of k) and final_lml through lml_iterative_segmented,
    and implies split_programs; "auto" or 0: one tolerance loop a solve.
    probe_mode: "fresh" redraws Rademacher probes from `generator` each
    step; "frozen" uses `probes` (n, num_probes) for every step (drawn
    once when not given) and lets warm_start reuse the whole previous
    [y | z] solution as x0 ("fresh" warm-starts only the y column).
    final_lml: one CG + SLQ evaluation at the fitted params (with the
    frozen probes when there are any) so info["lml"] is a real LML.
    callback: optional fn(step, params, value, grads).

    checkpoint_dir: every `checkpoint_every` steps, and at the end, the
    params, Adam's state and the loss trace are saved there
    (utils.checkpoint) in the JAX package's layout (optax's ``count``,
    ``mu``, ``nu`` for torch's ``step``, ``exp_avg``, ``exp_avg_sq``; the
    step as the checkpoint's; extra {"kind", "n"}), so a fit-state
    directory resumes in either package. A call whose directory holds a
    checkpoint resumes at its step. "fresh" probes stay those of an
    uninterrupted run: the generator first skips the draws of the steps
    already taken. Neither the preconditioner nor the warm start's x0
    is saved (as in the JAX package): a resumed run rebuilds the one and
    starts CG from zero once. A JAX-written state resumes on the port's
    probes (the JAX package's fold_in(key, step) stream cannot be
    redrawn).

    Returns (params, info): info["loss"] the per-step negative quad-form
    objective, info["quad_obj"], info["cg_iters"] (np.int32, split path),
    info["precond_rebuilds"], info["lml"] (NaN unless final_lml).
    """
    import sys

    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.ops import kernels as kernel_ops

    kernel_ops.validate_kind(kind)
    if probe_mode not in ("fresh", "frozen"):
        raise ValueError(f"unknown probe_mode {probe_mode!r}")
    segment_iters, precond_where = resolve_iterative_schedule(
        segment_iters, precond_where)
    n = X.shape[0]
    if split_programs == "auto":
        split_programs = n >= 32768
    if segment_iters:
        split_programs = True  # the segmented solver is the split layout
    if grad_method == "analytic" and split_programs:
        # the split gradient call is the AD sweep; the hand-rule path only
        # exists fused
        split_programs = False
    adaptive_refresh = precond_refresh == "auto"
    if adaptive_refresh:
        precond_refresh = 10 ** 9  # cadence disabled; staleness-driven

    if generator is None:  # on the CPU: the same probes on every device
        generator = torch.Generator().manual_seed(0)
    if probe_mode == "frozen" and probes is None:
        probes = iterative.rademacher(n, num_probes, X.device, generator)

    params = tree_map(lambda t: t.detach().clone(), init_params)
    leaves = tree_leaves(params)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, start_step = [], 0
    if checkpoint_dir:
        start_step, losses = _restore_fit_state(checkpoint_dir, params, opt,
                                                kind, n)
        if verbose and start_step:
            print(f"# fit_iterative: resumed at step {start_step}",
                  file=sys.stderr, flush=True)
        if probe_mode == "fresh":
            # the draws the steps before start_step made, so that step s
            # draws the probes of an uninterrupted run
            for _ in range(start_step):
                torch.randint(0, 2, (n, num_probes), generator=generator,
                              device=generator.device)

    def save_state(step_done):
        from cugp_tpu_torch.utils import checkpoint

        checkpoint.save(checkpoint_dir, {
            "losses": np.asarray(losses, np.float32),
            "opt": _adam_state(opt, params),
            "params": params,
        }, step=step_done, extra_json={"kind": kind, "n": int(n)})

    cg_iters = []
    precond, rebuilds = None, 0
    best_since = float("inf")  # best CG count since the last build
    need_rebuild = False
    prev_sol = None            # previous step's [y | z] solution
    for step in range(start_step, steps):
        with profiling.span("cugp.step", X.device, root=True):
            if precond_rank and (precond is None or need_rebuild
                                 or (not adaptive_refresh
                                     and step % precond_refresh == 0
                                     and step > start_step)):
                precond = iterative.build_precond(
                    params, X, precond_rank, kind=kind, jitter=jitter,
                    where=precond_where, verbose=verbose)
                rebuilds += 1
                best_since = float("inf")
                need_rebuild = False
            z = probes if probe_mode == "frozen" else iterative.rademacher(
                n, num_probes, X.device, generator)
            if split_programs:
                B = torch.cat([y[:, None], z], dim=1)
                x0 = None
                if warm_start and prev_sol is not None:
                    x0 = prev_sol
                    if probe_mode == "fresh":
                        # probes changed: only the y column warms up
                        x0 = torch.cat([prev_sol[:, :1], torch.zeros_like(
                            prev_sol[:, 1:])], 1)
                if segment_iters:
                    sol, it, _rel = iterative.cg_solve_segmented(
                        params, X, B, precond=precond, kind=kind,
                        jitter=jitter, block=block, tol=tol,
                        iters_per_program=segment_iters,
                        max_iters=max_iters, x0=x0, verbose=verbose)
                else:
                    sol, it = iterative.cg_solve_program(
                        params, X, B, precond=precond, kind=kind,
                        jitter=jitter, block=block, tol=tol,
                        max_iters=max_iters, x0=x0)
                if warm_start:
                    prev_sol = sol
                alpha, w = sol[:, 0], sol[:, 1:]
                grads = iterative.hutchinson_grads_program(
                    params, X, alpha, w, z, kind=kind, jitter=jitter,
                    block=block)
                value = -0.5 * torch.dot(y, alpha)
            else:
                value, grads = iterative.lml_value_and_grad_iterative(
                    params, X, y, z=z, kind=kind, jitter=jitter,
                    block=block, tol=tol, max_iters=max_iters,
                    num_probes=num_probes, precond=precond,
                    grad_method=grad_method)
                it = -1  # fused call: count not kept
            if log_prior is not None:
                pv, pg = _value_and_grad(log_prior, params)
                value = value + pv
                grads = _tree_add(grads, pg)
            if it >= 0:
                cg_iters.append(it)
                if adaptive_refresh and precond_rank:
                    if it > refresh_factor * best_since:
                        need_rebuild = True
                    best_since = min(best_since, it)
            # maximize: Adam minimizes, so it gets the negated gradients
            for p, g in zip(leaves, tree_leaves(grads)):
                p.grad = -g
            opt.step()
            _clamp(params)
            loss = -profiling.read_float(value, "fit_iterative_value")
            losses.append(loss)
            if checkpoint_dir and (step + 1) % checkpoint_every == 0:
                save_state(step + 1)
            if callback is not None:
                callback(step, params, -loss, grads)
            if verbose:
                it_msg = f" cg_it={it}" if it >= 0 else ""
                print(f"# fit_iterative step {step}: quad-obj={-loss:.4f}"
                      f"{it_msg}", file=sys.stderr, flush=True)
    if checkpoint_dir and start_step < steps:
        # a checkpoint already past `steps` keeps its own step
        save_state(steps)
    info = {"loss": torch.tensor(losses, dtype=torch.float32),
            "quad_obj": -losses[-1] if losses else float("nan"),
            "cg_iters": np.asarray(cg_iters, np.int32),
            "precond_rebuilds": rebuilds,
            "lml": float("nan")}
    if final_lml and segment_iters:
        info["lml"] = iterative.lml_iterative_segmented(
            params, X, y, Z=probes, generator=generator, kind=kind,
            jitter=jitter, block=block, tol=tol,
            iters_per_program=segment_iters, max_iters=max_iters,
            num_probes=num_probes, precond=precond, verbose=verbose)
    elif final_lml:
        info["lml"] = float(iterative.lml_iterative(
            params, X, y, Z=probes, kind=kind, jitter=jitter, block=block,
            tol=tol, max_iters=max_iters, num_probes=num_probes,
            precond=precond, generator=generator))
    return params, info
