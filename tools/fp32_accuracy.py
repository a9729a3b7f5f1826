"""fp32 accuracy of the sparse, classification and rank-Q LMC models
against float64, the port beside the JAX package where it is importable.

    python tools/fp32_accuracy.py            # every case, on the CPU
    python tools/fp32_accuracy.py --n=16384 --cases=sgpr,warm_start
    python tools/fp32_accuracy.py --cases=lmcq_dense --lmcq_n=4096 \
        --gate_n=1024 --lmcq_params='<the params JSON of phase 10(b)>'

Cases (one line each):
  sgpr        SGPR at benchmarks/bench_sgpr.py's data and initial
              hyperparameters (multidim_regression, d=4, m=512): ELBO a
              point, predictive mean and variance at 2,000 points against
              a float64 evaluation of the same formulas; also the fp32
              covariances carried through every later step in float64
              (what fp32 inputs alone cost);
  warm_start  svgp.optimal_variational on the same data: the uncollapsed
              bound at the warm start against the float64 collapsed
              bound, with m by two triangular solves (the port) and by
              the product S A y (the JAX package's order);
  multiclass  gpc_multiclass at n=1024 (phase 9's gate problem): the
              latent mean and covariance against the float64 oracle;
  sgpr_grad   SGPR's gradient at tests/test_sgpr.py's cell against a
              float64 autograd of the same formulas;
  lmcq_dense  the dense rank-Q LMC's LML, mean and variance on
              chip_smoke.py phase 10(b)'s gate cell (the model-zoo data
              at --lmcq_n rows, default 512; --gate_n of them, default
              256; 200 test points on [-3, 3]) against the float64
              oracle, at --lmcq_params (a params JSON, as phase 10(b)
              prints for its fit on the card) or else at the params of
              --lmcq_steps (default 3) Adam steps of the port's fit from
              phase 10(b)'s init (the CPU rehearsal's); with the joint
              covariance's condition number.
The JAX columns need the JAX package (and jax) beside the port; without
them they read "n/a". Numbers are CPU numbers: the card rounds its GEMMs
in another order.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (_gpc_gate_problem, _lmcq_gate_inputs,  # noqa: E402
                        _lmcq_zoo_data, _sgpr_oracle)
from cugp_tpu_torch.data import synthetic  # noqa: E402
from cugp_tpu_torch.models import gpc_multiclass, lmc, sgpr, svgp  # noqa: E402
from cugp_tpu_torch.ops import cholesky as chol_ops  # noqa: E402
from cugp_tpu_torch.ops import kernels as kernel_ops  # noqa: E402
from cugp_tpu_torch.ops import trsm as trsm_ops  # noqa: E402
from cugp_tpu_torch.oracle import gpc_multiclass_np, lmc_np  # noqa: E402
from cugp_tpu_torch.utils.params import (params_from_numpy,  # noqa: E402
                                         params_to_numpy)


def _jax():
    """The JAX package's models, or None."""
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from cugp_tpu.models import gpc_multiclass as jmc
        from cugp_tpu.models import lmc as jlmc
        from cugp_tpu.models import sgpr as jsgpr
        from cugp_tpu.models import svgp as jsvgp
    except ImportError:
        return None
    return jax, jnp, jsgpr, jsvgp, jmc, jlmc


def _fmt(v):
    return "n/a" if v is None else f"{v:.3e}"


def _bench_data(n):
    X, y, _ = synthetic.multidim_regression(n=n, d=4, noise_std=0.2, seed=0)
    X, y = X.astype(np.float32), y.astype(np.float32)
    Xs = np.random.default_rng(3).uniform(-2.0, 2.0, (2000, 4)).astype(
        np.float32)
    p = kernel_ops.init_params(d=4, lengthscale=1.5, noise_var=0.05)
    Z = sgpr.init_inducing(torch.tensor(X), 512, seed=0)
    return p, Z, X, y, Xs


def case_sgpr(n, J):
    p, Z, X, y, Xs = _bench_data(n)
    pn = {k: v.numpy() for k, v in p.items()}
    e64, mu64, var64 = _sgpr_oracle(pn, Z.numpy(), X, y, Xs)

    def errs(elbo, mu, var):
        return (abs(float(elbo) - e64) / n,
                float(np.abs(np.asarray(mu, np.float64) - mu64).max()),
                float(np.abs(np.asarray(var, np.float64) - var64).max()))

    with torch.no_grad():
        Xt, yt, Xst = torch.tensor(X), torch.tensor(y), torch.tensor(Xs)
        port = errs(sgpr.elbo(p, Z, Xt, yt),
                    *sgpr.posterior(p, Z, Xt, yt, Xst))
        # the fp32 covariances, every later step in float64
        d = torch.float64
        sn2 = torch.exp(p["log_noise_var"]).double()
        sf2 = torch.exp(p["log_signal_var"]).double()
        Kmm = kernel_ops.cross_covariance(p, Z, Z).double() + (
            1e-6 * sf2 + 1e-6) * torch.eye(512, dtype=d)
        L = torch.linalg.cholesky(Kmm)
        A = torch.linalg.solve_triangular(
            L, kernel_ops.cross_covariance(p, Z, Xt).double(),
            upper=False) / sn2.sqrt()
        LB = torch.linalg.cholesky(torch.eye(512, dtype=d) + A @ A.T)
        c = torch.linalg.solve_triangular(LB, (A @ yt.double())[:, None],
                                          upper=False)[:, 0] / sn2.sqrt()
        t1 = torch.linalg.solve_triangular(
            L, kernel_ops.cross_covariance(p, Z, Xst).double(), upper=False)
        t2 = torch.linalg.solve_triangular(LB, t1, upper=False)
        mu_k = float(np.abs((t2.T @ c).numpy() - mu64).max())
    jax_errs = (None,) * 3
    if J is not None:
        jax, jnp, jsgpr, _, _, _ = J
        pj = {k: jnp.asarray(v) for k, v in pn.items()}
        args = (pj, jnp.asarray(Z.numpy()), jnp.asarray(X), jnp.asarray(y))
        jax_errs = errs(jsgpr.elbo(*args),
                        *jsgpr.posterior(*args, jnp.asarray(Xs)))
    print(f"[sgpr] n={n} m=512 port: elbo_per_point={_fmt(port[0])} "
          f"mean={_fmt(port[1])} var={_fmt(port[2])}; jax: "
          f"elbo_per_point={_fmt(jax_errs[0])} mean={_fmt(jax_errs[1])} "
          f"var={_fmt(jax_errs[2])}; fp32 covariances, float64 after: "
          f"mean={_fmt(mu_k)}", flush=True)


def case_warm_start(n, J):
    p, Z, X, y, Xs = _bench_data(n)
    pn = {k: v.numpy() for k, v in p.items()}
    coll64, _, _ = _sgpr_oracle(pn, Z.numpy(), X, y, Xs[:2],
                                jitter=svgp.KMM_JITTER_FLOOR)
    with torch.no_grad():
        Xt, yt = torch.tensor(X), torch.tensor(y)
        vp = svgp.optimal_variational(p, Z, Xt, yt)
        solves = float(svgp.elbo(p, Z, vp, Xt, yt))
        # m = S A y with S's fp32 inverse, the JAX package's order
        sn2 = torch.exp(p["log_noise_var"])
        L = svgp._kmm_chol(p, Z, "rbf", 1e-6)
        AAt, Ay = torch.zeros(512, 512), torch.zeros(512)
        for lo in range(0, n, 8192):
            Ac = trsm_ops.solve_lx(L, kernel_ops.cross_covariance(
                p, Z, Xt[lo:lo + 8192]))
            AAt, Ay = AAt + Ac @ Ac.mT, Ay + Ac @ yt[lo:lo + 8192]
        eye = torch.eye(512)
        S = trsm_ops.cho_solve(chol_ops.cholesky(eye + AAt / sn2), eye)
        S = 0.5 * (S + S.mT) + 1e-8 * eye
        product = float(svgp.elbo(p, Z, {"m": S @ Ay / sn2, "c": vp["c"]},
                                  Xt, yt))
    jax_rel = None
    if J is not None:
        jax, jnp, _, jsvgp, _, _ = J
        pj = {k: jnp.asarray(v) for k, v in pn.items()}
        args = (pj, jnp.asarray(Z.numpy()))
        vpj = jsvgp.optimal_variational(*args, jnp.asarray(X),
                                        jnp.asarray(y))
        jax_rel = abs(float(jsvgp.elbo(*args, vpj, jnp.asarray(X),
                                       jnp.asarray(y))) - coll64) / abs(
                                           coll64)
    def rel(v):
        return abs(v - coll64) / abs(coll64)

    print(f"[warm_start] n={n} m=512 relative to the float64 collapsed "
          f"bound: port (m by solves)={_fmt(rel(solves))} port with "
          f"m = S A y={_fmt(rel(product))} jax={_fmt(jax_rel)}", flush=True)


def case_multiclass(J):
    p_np, X, Y, Xs = _gpc_gate_problem("multiclass")
    p64 = {k: np.asarray(v, np.float64) for k, v in p_np.items()}
    mu64, sig64 = gpc_multiclass_np.latent_predictive(
        p64, X.astype(np.float64), Y.astype(np.float64),
        Xs.astype(np.float64))
    with torch.no_grad():
        _, mu, sig = gpc_multiclass.predict_proba(
            {k: torch.tensor(v) for k, v in p_np.items()}, torch.tensor(X),
            torch.tensor(Y), torch.tensor(Xs), num_newton=30, num_samples=8)
    jax_err = (None, None)
    if J is not None:
        jax, jnp, _, _, jmc, _ = J
        _, muj, sigj = jmc.predict_proba(
            {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(X),
            jnp.asarray(Y), jnp.asarray(Xs), num_newton=30, num_samples=8)
        jax_err = (float(np.abs(np.asarray(muj) - mu64).max()),
                   float(np.abs(np.asarray(sigj) - sig64).max()))
    err_mu = float(np.abs(mu.numpy() - mu64).max())
    err_sig = float(np.abs(sig.numpy() - sig64).max())
    print(f"[multiclass] n={X.shape[0]} port: mean={_fmt(err_mu)}"
          f" cov={_fmt(err_sig)}; jax: "
          f"mean={_fmt(jax_err[0])} cov={_fmt(jax_err[1])}", flush=True)


def case_sgpr_grad(J):
    X, y, _ = synthetic.sinusoid_1d(n=256, noise_std=0.1, seed=3)
    X, y = X.astype(np.float32), y.astype(np.float32)
    p = kernel_ops.init_params(d=1, lengthscale=0.8, signal_var=1.2,
                               noise_var=0.05)
    Z = sgpr.init_inducing(torch.tensor(X), 48, seed=0)
    pt = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    sgpr.elbo(pt, Z, torch.tensor(X), torch.tensor(y)).backward()

    def k(P, A, B):
        d2 = (((A[:, None, :] - B[None, :, :])
               / torch.exp(P["log_lengthscale"])) ** 2).sum(-1)
        return torch.exp(P["log_signal_var"]) * torch.exp(-0.5 * d2)

    p64 = {kk: v.detach().double().requires_grad_(True)
           for kk, v in p.items()}
    Zd, Xd, yd = Z.double(), torch.tensor(X).double(), torch.tensor(y).double()
    sn2, sf2 = torch.exp(p64["log_noise_var"]), torch.exp(
        p64["log_signal_var"])
    eye = torch.eye(48, dtype=torch.float64)
    L = torch.linalg.cholesky(k(p64, Zd, Zd) + (1e-6 * sf2 + 1e-6) * eye)
    A = torch.linalg.solve_triangular(L, k(p64, Zd, Xd), upper=False) \
        / sn2.sqrt()
    LB = torch.linalg.cholesky(eye + A @ A.T)
    c = torch.linalg.solve_triangular(LB, (A @ yd)[:, None],
                                      upper=False)[:, 0] / sn2.sqrt()
    n = 256
    e64 = (-0.5 * n * (math.log(2 * math.pi) + torch.log(sn2))
           - torch.log(torch.diagonal(LB)).sum() - 0.5 * (yd @ yd) / sn2
           + 0.5 * (c @ c) - 0.5 * n * sf2 / sn2 + 0.5 * (A * A).sum())
    e64.backward()
    names = ("log_lengthscale", "log_signal_var")
    row = {nm: (float(pt[nm].grad.reshape(-1)[0]),
                float(p64[nm].grad.reshape(-1)[0])) for nm in names}
    jax_g = {nm: None for nm in names}
    if J is not None:
        jax, jnp, jsgpr, _, _, _ = J
        g = jax.grad(lambda q: jsgpr.elbo(q, jnp.asarray(Z.numpy()),
                                          jnp.asarray(X), jnp.asarray(y)))(
            {kk: jnp.asarray(v.numpy()) for kk, v in p.items()})
        jax_g = {nm: float(np.ravel(g[nm])[0]) for nm in names}
    print("[sgpr_grad] tests/test_sgpr.py's cell " + " ".join(
        f"d/d{nm}: port={row[nm][0]:.4f} float64={row[nm][1]:.4f} jax="
        + ("n/a" if jax_g[nm] is None else f"{jax_g[nm]:.4f}")
        for nm in names), flush=True)


def _tree_f32(tree):
    """A params tree from JSON: dicts and lists of dicts stay, every other
    value (a number or a nested list of numbers) becomes a float32 array."""
    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_tree_f32(v) for v in tree]
    return np.asarray(tree, np.float32)


def case_lmcq_dense(J, n_q, gate_n, steps, params_json):
    kinds = ("periodic", "rbf")
    Xq, Yq = _lmcq_zoo_data(n_q, seed=0)
    if params_json:
        p_np = _tree_f32(json.loads(params_json))
        origin = "given params"
    else:
        init = lmc.init_lmcq_params(d=1, p=2, kinds=kinds, lengthscale=0.8,
                                    noise_var=0.05, seed=0)
        pt, _ = lmc.fit_lmcq(init, torch.tensor(Xq), torch.tensor(Yq),
                             kinds=kinds, steps=steps)
        p_np = params_to_numpy(pt)
        origin = f"{steps} steps of the port's fit"
    X, Y, Xs = _lmcq_gate_inputs(Xq, Yq, gate_n)
    lml64 = lmc_np.log_marginal_likelihood_q(p_np, X, Y, kinds)
    mu64, var64 = lmc_np.posterior_q(p_np, X, Y, Xs, kinds)
    S = lmc_np._joint_cov_q(p_np, X, X, kinds)
    S[np.diag_indices_from(S)] += (
        np.exp(np.float64(p_np["log_noise_var"]))
        + 1e-6 * np.max(np.sum(np.float64(p_np["lmc_a"]) ** 2, axis=0)))
    kappa = np.linalg.cond(S)

    def errs(lml, mu, var):
        return (abs(float(lml) - lml64) / abs(lml64),
                float(np.abs(np.asarray(mu, np.float64) - mu64).max()),
                float(np.abs(np.asarray(var, np.float64) - var64).max()))

    pt = params_from_numpy(p_np, "cpu")
    with torch.no_grad():
        port = errs(lmc.log_marginal_likelihood_lmcq(
            pt, torch.tensor(X), torch.tensor(Y), kinds),
            *lmc.posterior_lmcq(pt, torch.tensor(X), torch.tensor(Y),
                                torch.tensor(Xs), kinds))
    jx = (None, None, None)
    if J is not None:
        jax, jnp, _, _, _, jlmc = J
        pj = jax.tree.map(jnp.asarray, p_np)
        Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
        jx = errs(jlmc.log_marginal_likelihood_lmcq(pj, Xj, Yj, kinds),
                  *jlmc.posterior_lmcq(pj, Xj, Yj, jnp.asarray(Xs), kinds))
    print(f"[lmcq_dense] n={n_q} gate_n={gate_n} ({origin}) joint "
          f"condition number {kappa:.3e} (x fp32's eps {kappa * 2**-24:.1e}) "
          + "; ".join(f"{who}: lml_rel={_fmt(e[0])} mean={_fmt(e[1])} "
                      f"var={_fmt(e[2])}" for who, e in (("port", port),
                                                        ("jax", jx))),
          flush=True)


def main(argv):
    opts = dict(a.split("=", 1) for a in argv if a.startswith("--"))
    n = int(opts.get("--n", 131072))
    cases = opts.get("--cases",
                     "sgpr,warm_start,multiclass,sgpr_grad,lmcq_dense")
    torch.set_num_threads(os.cpu_count() or 1)
    J = _jax()
    for case in cases.split(","):
        if case == "sgpr":
            case_sgpr(n, J)
        elif case == "warm_start":
            case_warm_start(n, J)
        elif case == "multiclass":
            case_multiclass(J)
        elif case == "sgpr_grad":
            case_sgpr_grad(J)
        elif case == "lmcq_dense":
            case_lmcq_dense(J, int(opts.get("--lmcq_n", 512)),
                            int(opts.get("--gate_n", 256)),
                            int(opts.get("--lmcq_steps", 3)),
                            opts.get("--lmcq_params"))
        else:
            raise SystemExit(f"unknown case {case!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
