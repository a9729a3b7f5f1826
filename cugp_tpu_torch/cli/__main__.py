"""Command-line interface of the PyTorch port, as ``cugp_tpu/cli/__main__.py``.

Usage:
  python -m cugp_tpu_torch.cli fit     [--data.n=8000 --model.kind=rbf ...]
      [--fit.engine=iterative]   matrix-free training (n beyond the
                                 dense ceiling; K never formed)
      [--fit.restarts=4]         multi-start sweep, best wins
  python -m cugp_tpu_torch.cli predict [--data.n=1000 ...]
  python -m cugp_tpu_torch.cli sample  [--sample.num_chains=256 ...]
      [--sample.engine=iterative] matrix-free LML per transition
  python -m cugp_tpu_torch.cli classify [--data.n=400 ...]   (Laplace GPC)
  python -m cugp_tpu_torch.cli vi      [...]
  python -m cugp_tpu_torch.cli sgpr    [--data.n=20000 ...]
  python -m cugp_tpu_torch.cli svgp    [--svgp.likelihood=bernoulli --svgp.batch=256 ...]
  python -m cugp_tpu_torch.cli info

Global flags: --device=cuda|cpu (default cuda; no fallback: without a
card the run fails), --profile=DIR (a torch.profiler Chrome trace in
DIR/trace.json), --checkpoint_dir=D, --metrics_file=F. Every other flag
is a dotted override of utils/config.py's fields, the JAX CLI's. A bad
flag or an unknown command exits 2. Each command prints one JSON object
with the JAX CLI's keys.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cugp_tpu_torch.utils import config as config_lib


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _load_data(cfg):
    from cugp_tpu_torch.data import synthetic

    d = cfg.data
    if d.dataset == "sinusoid":
        X, y, _ = synthetic.sinusoid_1d(n=d.n, noise_std=d.noise_std, seed=d.seed)
    elif d.dataset == "multidim":
        X, y, _ = synthetic.multidim_regression(n=d.n, d=d.d,
                                                noise_std=d.noise_std,
                                                seed=d.seed)
    elif d.dataset == "gp_draw":
        X, y, _ = synthetic.gp_draw(n=d.n, d=d.d, seed=d.seed,
                                    kind=cfg.model.kind)
    elif d.dataset == "npz":
        blob = np.load(d.path)
        X, y = blob["X"], blob["y"]
    else:
        raise ValueError(f"unknown dataset: {d.dataset}")
    return X, y


def _method(cfg):
    """The JAX package's XLA routes run as "auto" (as GP.load maps them)."""
    m = cfg.model.method
    return "auto" if m in ("xla", "blocked") else m


def _make_gp(cfg, device):
    from cugp_tpu_torch.api import GP

    return GP(kind=cfg.model.kind, jitter=cfg.model.jitter,
              method=_method(cfg), basis=cfg.model.basis or None,
              normalize_y=cfg.model.normalize_y, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_fit(cfg, device):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg, device)
    init = None
    if cfg.checkpoint_dir:
        try:
            init = type(gp).load(cfg.checkpoint_dir, device=device).params
        except FileNotFoundError:
            pass
    t0 = time.perf_counter()
    if cfg.fit.engine == "iterative":
        # the iterative engine is Adam / LML / single-start only: refuse
        # the flags it would otherwise ignore
        ignored = []
        if cfg.fit.optimizer != "adam":
            ignored.append(f"--fit.optimizer={cfg.fit.optimizer}")
        if cfg.fit.objective != "lml":
            ignored.append(f"--fit.objective={cfg.fit.objective}")
        if cfg.fit.restarts != 1:
            ignored.append(f"--fit.restarts={cfg.fit.restarts}")
        if ignored:
            raise ValueError(
                "fit.engine=iterative supports only Adam/LML/single-start; "
                "incompatible flags: " + ", ".join(ignored))
        # the optimizer state checkpoints at the SIBLING <dir>_fit_state
        # (utils.checkpoint.save replaces a whole directory, so state
        # nested under <dir> would be wiped by the facade's save at the
        # end), so a killed fit resumes mid-trajectory
        fit_ckpt = (cfg.checkpoint_dir.rstrip("/") + "_fit_state"
                    if cfg.checkpoint_dir else None)
        info = gp.fit_iterative(
            X, y, steps=cfg.fit.steps,
            learning_rate=cfg.fit.learning_rate, init=init,
            precond_rank=cfg.fit.precond_rank,
            precond_refresh=(cfg.fit.precond_refresh or "auto"),
            num_probes=cfg.fit.num_probes, tol=cfg.fit.cg_tol,
            max_iters=cfg.fit.cg_max_iters, block=cfg.fit.block,
            segment_iters=("auto" if cfg.fit.segment_iters < 0
                           else cfg.fit.segment_iters),
            probe_mode=cfg.fit.probe_mode,
            final_lml=True,  # info["lml"]: a CG+SLQ LML, comparable with
                             # the dense engine's
            checkpoint_dir=fit_ckpt)
    elif cfg.fit.engine == "dense":
        info = gp.fit(X, y, steps=cfg.fit.steps, optimizer=cfg.fit.optimizer,
                      learning_rate=cfg.fit.learning_rate, init=init,
                      objective=cfg.fit.objective,
                      restarts=cfg.fit.restarts)
    else:
        raise ValueError(
            f"unknown fit.engine {cfg.fit.engine!r}: dense | iterative")
    _sync(device)
    dt = time.perf_counter() - t0
    if cfg.checkpoint_dir:
        gp.save(cfg.checkpoint_dir)
    if cfg.metrics_file:
        from cugp_tpu_torch.utils.metrics import MetricsLogger

        with MetricsLogger(cfg.metrics_file) as m:
            m.log_series("neg_lml", _np(info["loss"]))
            m.log(event="fit_done", seconds=dt, lml=float(info["lml"]))
    out = {
        "lml": float(info["lml"]),
        "seconds": round(dt, 3),
        "resumed": init is not None,
        "params": _params_json(gp.params),
    }
    if "quad_obj" in info:  # iterative engine: the per-step objective is
        out["quad_obj"] = float(info["quad_obj"])  # the quadratic term only
    if "cg_iters" in info and len(info["cg_iters"]):
        out["cg_iters_last"] = int(info["cg_iters"][-1])
        out["precond_rebuilds"] = int(info["precond_rebuilds"])
    print(json.dumps(out, indent=2))
    return gp


def _params_json(p):
    """JSON view of a params tree (composite terms/factors included)."""
    if isinstance(p, dict):
        return {k: _params_json(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_params_json(v) for v in p]
    return _np(p).tolist()


def cmd_predict(cfg, device):
    gp = cmd_fit(cfg, device)
    X = _np(gp.X)
    lo, hi = X.min(axis=0), X.max(axis=0)
    Xs = np.linspace(lo, hi, 256).reshape(256, -1)
    mu, var = gp.predict(Xs)
    print(json.dumps({
        "mu_head": _np(mu)[:8].tolist(),
        "var_head": _np(var)[:8].tolist(),
    }, indent=2))


def cmd_sample(cfg, device):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg, device)
    gp.condition(X, y)
    t0 = time.perf_counter()
    # the seed seeds a CPU generator, whose numbers move to the device:
    # the same draws on every device
    rng = torch.Generator().manual_seed(cfg.sample.seed)
    s = cfg.sample
    if cfg.checkpoint_dir:
        # chain-state checkpoint/resume: a killed run re-invoked with the
        # same --checkpoint_dir continues from the last saved segment;
        # composes with --sample.engine=iterative
        from cugp_tpu_torch.inference import sampling

        res = sampling.sample_hyperparams_checkpointed(
            gp.params, gp.X, gp.y, checkpoint_dir=cfg.checkpoint_dir,
            checkpoint_every=s.checkpoint_every, kind=cfg.model.kind,
            jitter=cfg.model.jitter, method=_method(cfg),
            num_samples=s.num_samples, num_chains=s.num_chains,
            num_warmup=s.num_warmup, sampler=s.sampler,
            max_tree_depth=s.max_tree_depth, chain_block=s.chain_block,
            engine=s.engine, num_probes=s.num_probes,
            precond_rank=s.precond_rank, rng=rng)
    elif s.engine == "iterative":
        # matrix-free LML per transition: hyperparameter posteriors at n
        # beyond the dense ceiling
        from cugp_tpu_torch.inference import sampling

        res = sampling.sample_hyperparams_iterative(
            gp.params, gp.X, gp.y, kind=cfg.model.kind,
            jitter=cfg.model.jitter, num_samples=s.num_samples,
            num_chains=s.num_chains, num_warmup=s.num_warmup,
            sampler=s.sampler, max_tree_depth=s.max_tree_depth,
            chain_block=s.chain_block, num_probes=s.num_probes,
            precond_rank=s.precond_rank, rng=rng)
    elif s.engine == "dense":
        res = gp.sample_hyperparams(
            num_samples=s.num_samples, num_chains=s.num_chains,
            num_warmup=s.num_warmup, sampler=s.sampler,
            max_tree_depth=s.max_tree_depth, chain_block=s.chain_block,
            generator=rng)
    else:
        raise ValueError(
            f"unknown sample.engine {s.engine!r}: dense | iterative")
    _sync(device)
    dt = time.perf_counter() - t0
    from cugp_tpu_torch.inference import sampling as sampling_lib

    stats = {}
    for k, v in res["samples"].items():
        arr = _np(v)
        flat2 = arr.reshape(arr.shape[0], arr.shape[1], -1)
        rhat = [float(sampling_lib.potential_scale_reduction(flat2[:, :, j]))
                for j in range(flat2.shape[2])]
        ess = [float(sampling_lib.effective_sample_size(flat2[:, :, j]))
               for j in range(flat2.shape[2])]
        stats[k] = {
            "mean": arr.mean(axis=(0, 1)).tolist(),
            "std": arr.std(axis=(0, 1)).tolist(),
            "r_hat": rhat if len(rhat) > 1 else rhat[0],
            "ess": ess if len(ess) > 1 else ess[0],
        }
    out = {
        "seconds": round(dt, 3),
        "accept_rate": float(_np(res["accept_rate"]).mean()),
        "posterior": stats,
    }
    if "resumed" in res:
        out["resumed"] = bool(res["resumed"])
        out["draws_done"] = int(res["draws_done"])
    print(json.dumps(out, indent=2))


def cmd_vi(cfg, device):
    X, y = _load_data(cfg)
    gp = _make_gp(cfg, device)
    gp.condition(X, y)
    res = gp.fit_vi(steps=cfg.fit.steps, learning_rate=cfg.fit.learning_rate)
    print(json.dumps({
        "elbo": float(_np(res["elbo"])[-1]),
        "mean": {k: _np(v).tolist() for k, v in res["mean"].items()},
    }, indent=2))


def cmd_sgpr(cfg, device):
    """Sparse (inducing point) fit + predictive check."""
    X, y = _load_data(cfg)
    gp = _make_gp(cfg, device)
    t0 = time.perf_counter()
    info = gp.fit_sparse(X, y, num_inducing=min(cfg.data.n // 4, 512),
                         steps=cfg.fit.steps,
                         learning_rate=cfg.fit.learning_rate)
    _sync(device)
    dt = time.perf_counter() - t0
    mu, var = gp.predict_sparse(X[:64])
    print(json.dumps({
        "elbo": float(info["elbo"]),
        "seconds": round(dt, 3),
        "num_inducing": int(gp.Z.shape[0]),
        "train_rmse_head": float(np.sqrt(np.mean(
            (_np(mu) - y[:64]) ** 2))),
    }, indent=2))


def cmd_svgp(cfg, device):
    """Stochastic variational GP: minibatch Adam on the SVGP bound.

    --svgp.likelihood=gaussian trains on the configured regression
    dataset; =bernoulli trains a classifier on two-moons."""
    from cugp_tpu_torch.api import SVGP
    from cugp_tpu_torch.data import synthetic

    if cfg.svgp.likelihood == "bernoulli":
        X, y = synthetic.two_moons(n=cfg.data.n, noise_std=cfg.data.noise_std,
                                   seed=cfg.data.seed)
    elif cfg.svgp.likelihood == "poisson":
        X, y, _ = synthetic.poisson_counts(n=cfg.data.n, seed=cfg.data.seed)
    elif cfg.svgp.likelihood == "student_t":
        X, y, _ = synthetic.sinusoid_outliers(
            n=cfg.data.n, noise_std=cfg.data.noise_std, seed=cfg.data.seed)
    else:
        X, y = _load_data(cfg)
    model = SVGP(kind=cfg.model.kind, jitter=cfg.model.jitter,
                 likelihood=cfg.svgp.likelihood, device=device)
    t0 = time.perf_counter()
    # cap against the LOADED size (for dataset=npz it can differ from
    # cfg.data.n)
    info = model.fit(X, y, num_inducing=min(cfg.svgp.num_inducing,
                                            int(np.asarray(X).shape[0]) // 2),
                     steps=cfg.fit.steps, batch=cfg.svgp.batch,
                     learning_rate=cfg.fit.learning_rate,
                     optimize_inducing=cfg.svgp.optimize_inducing)
    _sync(device)
    dt = time.perf_counter() - t0
    out = {
        "seconds": round(dt, 3),
        "num_inducing": int(model.Z.shape[0]),
        "elbo_batch_final": float(_np(info["elbo_batch_final"])),
    }
    if cfg.svgp.likelihood == "bernoulli":
        p = _np(model.predict_proba(X))
        out["train_accuracy"] = float(np.mean((p > 0.5) == (y > 0)))
    else:
        mu, _ = model.predict(X[:256])
        out["train_rmse_head"] = float(np.sqrt(np.mean(
            (_np(mu) - y[:256]) ** 2)))
    print(json.dumps(out, indent=2))


def cmd_classify(cfg, device):
    """GP classification (Laplace): two-moons (binary) by default, or the
    multiclass Gaussian-blobs dataset via --data.num_classes>=3 (softmax
    Laplace, models/gpc_multiclass)."""
    from cugp_tpu_torch.api import GPClassifier
    from cugp_tpu_torch.data import synthetic

    num_classes = cfg.data.num_classes
    if num_classes > 2:
        X, y = synthetic.gaussian_blobs(n=cfg.data.n,
                                        num_classes=num_classes,
                                        seed=cfg.data.seed)
    else:
        X, y = synthetic.two_moons(n=cfg.data.n,
                                   noise_std=cfg.data.noise_std,
                                   seed=cfg.data.seed)
    clf = GPClassifier(kind=cfg.model.kind, jitter=cfg.model.jitter,
                       method=_method(cfg), inference=cfg.model.inference,
                       device=device)
    t0 = time.perf_counter()
    info = clf.fit(X, y, steps=cfg.fit.steps,
                   learning_rate=cfg.fit.learning_rate)
    pred = np.asarray(clf.predict(X))
    acc = float(np.mean(pred == np.asarray(y)))
    print(json.dumps({
        "seconds": round(time.perf_counter() - t0, 3),
        "num_classes": int(num_classes),
        "laplace_lml": float(_np(info["lml"])),
        "train_accuracy": acc,
        "params": {k: _np(v).tolist() for k, v in clf.params.items()},
    }, indent=2))


def cmd_info(cfg, device):
    on_card = torch.cuda.is_available()
    count = torch.cuda.device_count() if on_card else 0
    print(json.dumps({
        "backend": device.type,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "torch": torch.__version__,
        "cuda_available": on_card,
        "device_count": count,
        "config": json.loads(config_lib.to_json(cfg)),
    }, indent=2))


COMMANDS = {
    "fit": cmd_fit, "predict": cmd_predict, "sample": cmd_sample,
    "classify": cmd_classify, "vi": cmd_vi, "sgpr": cmd_sgpr,
    "svgp": cmd_svgp, "info": cmd_info,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, argv = argv[0], argv[1:]
    device, profile_dir = "cuda", None
    for arg in list(argv):
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            argv.remove(arg)
        elif arg.startswith("--profile="):
            profile_dir = arg.split("=", 1)[1]
            argv.remove(arg)
    try:
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"--device={device}: cuda | cpu")
        cfg, rest = config_lib.parse_overrides(argv)
    except (KeyError, ValueError, RuntimeError) as e:
        print(f"bad flag: {e}\n{__doc__}", file=sys.stderr)
        return 2
    if rest:
        print(f"unrecognized args: {rest}\n{__doc__}", file=sys.stderr)
        return 2
    fn = COMMANDS.get(cmd)
    if fn is None:
        print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
        return 2
    if profile_dir:
        from cugp_tpu_torch.utils import profiling

        with profiling.trace(profile_dir):
            fn(cfg, device)
        print(f"torch.profiler trace written to {profile_dir}/trace.json",
              file=sys.stderr)
    else:
        fn(cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
