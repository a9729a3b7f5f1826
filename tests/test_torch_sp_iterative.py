"""The port's distributed matrix-free tier (parallel/sp_iterative.py) on
four gloo ranks on the CPU: the ring matvec, sharded CG and posterior,
the sharded SLQ LML, the sharded gradient sweep, the training and
sampling loops, against the JAX package's twins on the faked CPU mesh
of the same shape (make_mesh(4, dp=1): r=2, c=2) and against the port's
single-process iterative tier under the same probes and draws.

The ranks start once for the whole file (the ``ranks`` fixture) and
run every ``_case_*``; each test compares one case. This module imports
no jax at module level, so a rank process loads torch only.
"""

import numpy as np
import pytest
import torch

from tests import torch_ranks

torch.set_num_threads(1)

N = 256


def _data(n=N, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return X, y


def _rademacher(n, p, seed):
    return np.where(np.random.default_rng(seed).uniform(size=(n, p)) < 0.5,
                    -1.0, 1.0).astype(np.float32)


FIT = dict(n=128, steps=4, learning_rate=0.1, tol=1e-6, max_iters=1000,
           num_probes=8, precond_rank=0)
SAMPLE = dict(n=128, chains=2, warmup=12, samples=2, n_leapfrog=4,
              probes=4, steps=10)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---- the rank side ----------------------------------------------------


def _case_matvec(m):
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import collectives, sp_iterative
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    X, y = _t(*_data())
    p = kops.init_params(d=3, lengthscale=1.1, noise_var=0.05)
    rows = Sharding(m, ("r", None))
    collectives.reset_counts()
    u = sp_iterative.ring_matvec(p, rows.shard(X), rows.shard(y), m)
    out["calls"] = dict(collectives.CALLS)
    out["y"] = rows.gather(u).numpy()
    V = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (N, 3)).astype(np.float32))
    rc = Sharding(m, (("r", "c"), None))
    out["V"] = rc.gather(sp_iterative.ring_matvec(
        p, rc.shard(X), rc.shard(V), m, axis=("r", "c"))).numpy()
    X2, y2 = _t(*_data(d=2))
    kind = "periodic*rbf+linear"
    pc = kops.default_init(kind, d=2, noise_var=0.05)
    out["composite"] = rows.gather(sp_iterative.ring_matvec(
        pc, rows.shard(X2), rows.shard(y2), m, kind=kind)).numpy()
    return out


def _case_solves(m):
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import sp_iterative
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    rows = Sharding(m, ("r", None))
    X, y = _t(*_data())
    p = kops.init_params(d=3, lengthscale=1.1, noise_var=0.05)
    x, it = sp_iterative.cg_solve_sharded(p, rows.shard(X), rows.shard(y), m,
                                          tol=1e-7, max_iters=1000)
    out["cg"] = (rows.gather(x).numpy(), it)
    Xs = torch.as_tensor(np.random.default_rng(2).uniform(
        -2, 2, (32, 3)).astype(np.float32))
    out["posterior"] = [t.numpy() for t in
                        sp_iterative.posterior_iterative_sharded(
                            p, rows.shard(X), rows.shard(y), Xs, m,
                            tol=1e-7)]
    Z = torch.as_tensor(_rademacher(N, 32, 4))
    out["lml"] = float(sp_iterative.lml_iterative_sharded(
        p, rows.shard(X), rows.shard(y), m, Z=Z, num_probes=32,
        num_steps=40))
    ps = kops.init_params(d=3, lengthscale=1.6, noise_var=1e-3)
    pre = sp_iterative.precond_factors_sharded(ps, rows.shard(X), m, 64)
    for name, pc in (("plain", None), ("pre", pre)):
        x, it = sp_iterative.cg_solve_sharded(
            ps, rows.shard(X), rows.shard(y), m, tol=1e-6, max_iters=2000,
            precond=pc)
        out[f"stiff_{name}"] = (rows.gather(x).numpy(), it)
        print(f"stiff {name}: {it} CG iterations", flush=True)
    return out


def _case_grads(m):
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import sp_iterative
    from cugp_tpu_torch.parallel.mesh import Sharding
    from cugp_tpu_torch.utils.params import ravel_pytree

    out = {}
    rows = Sharding(m, ("r", None))
    for kind, d in (("rbf", 3), ("rbf+linear", 2)):
        X, y = _t(*_data(d=d))
        p = (kops.init_params(d=3, lengthscale=1.1, noise_var=0.05)
             if kind == "rbf" else kops.default_init(kind, d=2,
                                                     noise_var=0.05))
        z = torch.as_tensor(_rademacher(N, 8, 3))
        mv = iterative.make_matvec(p, X, kind=kind, method="blocked")
        sol, _ = iterative.cg_solve(mv, torch.cat([y[:, None], z], 1),
                                    tol=1e-7, max_iters=2000)
        alpha, w = sol[:, 0], sol[:, 1:]
        g = sp_iterative.hutchinson_grads_sharded(
            p, rows.shard(X), rows.shard(alpha), rows.shard(w),
            rows.shard(z), m, kind=kind)
        out[kind] = {"alpha": alpha.numpy(), "w": w.numpy(),
                     "g": ravel_pytree(g)[0].numpy()}
    return out


def _case_fit(m):
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import sp_iterative
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    rows = Sharding(m, ("r", None))
    f = FIT
    X, y = _t(*_data(n=f["n"]))
    params, info = sp_iterative.fit_iterative_sharded(
        kops.init_params(d=3, lengthscale=1.4, noise_var=0.3),
        rows.shard(X), rows.shard(y), m, steps=f["steps"],
        learning_rate=f["learning_rate"], tol=f["tol"],
        max_iters=f["max_iters"], num_probes=f["num_probes"],
        precond_rank=f["precond_rank"],
        generator=torch.Generator().manual_seed(5))
    out["fit"] = ({k: v.numpy() for k, v in params.items()},
                  info["loss"].numpy(), info["cg_iters"])
    return out


def _case_logprob_and_sample(m):
    from cugp_tpu_torch.inference import hmc
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import sp_iterative
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    rows = Sharding(m, ("r", None))
    X, y = _t(*_data())
    Z = torch.as_tensor(_rademacher(N, 8, 11))
    p0 = kops.init_params(d=3, lengthscale=1.0, noise_var=0.1)
    lp, _unravel, q0 = sp_iterative.make_sharded_logprob(
        p0, rows.shard(X), rows.shard(y), m, tol=1e-7, max_iters=2000,
        num_probes=8, num_steps=20, Z=Z)
    q = torch.stack([q0 + dq for dq in (0.0, 0.15, -0.2)])
    v, g = lp(q)
    out["logprob"] = (v.numpy(), g.numpy())
    s = SAMPLE
    X, y = _t(*_data(n=s["n"]))
    r = sp_iterative.sample_hyperparams_sharded(
        p0, rows.shard(X), rows.shard(y), m, num_chains=s["chains"],
        num_warmup=s["warmup"], num_samples=s["samples"],
        n_leapfrog=s["n_leapfrog"], tol=1e-5, max_iters=1000,
        num_probes=s["probes"], num_steps=s["steps"],
        Z=torch.as_tensor(_rademacher(s["n"], s["probes"], 12)),
        rng=hmc.Draws(torch.Generator().manual_seed(9)))
    out["sample"] = (r["samples_flat"].numpy(), float(r["accept_rate"]))
    return out


CASES = {"matvec": _case_matvec, "solves": _case_solves,
         "grads": _case_grads, "fit": _case_fit,
         "logprob_and_sample": _case_logprob_and_sample}


def _worker(rank, world, tmp):
    torch_ranks.init_worker(rank, world, tmp)
    from cugp_tpu_torch.parallel import mesh as mesh_lib

    m = mesh_lib.make_mesh(world, dp=1)
    out = torch_ranks.run_cases(CASES, m)
    torch_ranks.finish_worker(rank, tmp, out)


# ---- the test side ----------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.Ranks("tests.test_torch_sp_iterative",
                             tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jmesh():
    from cugp_tpu.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(4, dp=1)


def _res(ranks, case):
    return ranks.results()[0][case]


def test_ring_matvec_matches_jax_and_dense(ranks, jmesh):
    """The ring matvec (axis 'r', a vector; axis ('r', 'c'), 3 columns;
    a composite) against the dense K v and the JAX package's ring matvec
    (rtol 1e-4, atol 1e-4, as JAX's test)."""
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import sp_iterative as jsp

    X, y = _data()
    p = jk.init_params(d=3, lengthscale=1.1, noise_var=0.05)
    uj = jsp.ring_matvec(p, jnp.asarray(X), jnp.asarray(y), jmesh,
                         axis="r")
    res = _res(ranks, "matvec")
    K = np.asarray(jk.train_covariance_xla(p, jnp.asarray(X), kind="rbf",
                                           jitter=1e-6), np.float64)
    V = np.random.default_rng(1).standard_normal((N, 3))
    for got, want in ((res["y"], K @ y), (res["y"], np.asarray(uj)),
                      (res["V"], K @ V)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    X2, y2 = _data(d=2)
    kind = "periodic*rbf+linear"
    pc = jk.default_init(kind, d=2, noise_var=0.05)
    Kc = np.asarray(jk.train_covariance_xla(pc, jnp.asarray(X2), kind=kind,
                                            jitter=1e-6), np.float64)
    np.testing.assert_allclose(res["composite"], Kc @ y2, rtol=1e-4,
                               atol=1e-4)


def test_ring_matvec_collectives(ranks):
    """The matvec moves X and v around the ring (ring shifts) with no
    all_gather of X and no all_reduce."""
    for res in ranks.results():
        assert res["matvec"]["calls"] == {"ppermute": 1}


def test_sharded_cg_and_posterior_match_single_device(ranks, jmesh):
    """Sharded CG and the sharded posterior against the port's
    single-process iterative tier (CG at JAX's rtol/atol 5e-3, the
    posterior at atol 2e-3) and the JAX package's sharded posterior."""
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import sp_iterative as jsp
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.ops import kernels as tk

    X, y = _data()
    Xs = np.random.default_rng(2).uniform(-2, 2, (32, 3)).astype(np.float32)
    mu_j, var_j = jsp.posterior_iterative_sharded(
        jk.init_params(d=3, lengthscale=1.1, noise_var=0.05),
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xs), jmesh, axis="r",
        tol=1e-7)
    p = tk.init_params(d=3, lengthscale=1.1, noise_var=0.05)
    Xt, yt = _t(X, y)
    x_ref, _ = iterative.cg_solve(iterative.make_matvec(p, Xt), yt,
                                  tol=1e-7, max_iters=1000)
    res = _res(ranks, "solves")
    x, it = res["cg"]
    assert it < 1000
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=5e-3, atol=5e-3)
    mu_r, var_r = iterative.posterior_iterative(p, Xt, yt,
                                                torch.as_tensor(Xs),
                                                tol=1e-7)
    mu, var = res["posterior"]
    for a, b in ((mu, mu_r.numpy()), (var, var_r.numpy()),
                 (mu, np.asarray(mu_j)), (var, np.asarray(var_j))):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_sharded_lml_matches_single_device(ranks):
    """The sharded SLQ LML equals the single-process lml_iterative on the
    same probes to rtol 1e-4 (the same estimator; JAX's test, with
    jax.random probes on both sides, allows |diff| / n < 0.02)."""
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.ops import kernels as tk

    X, y = _t(*_data())
    ref = float(iterative.lml_iterative(
        tk.init_params(d=3, lengthscale=1.1, noise_var=0.05), X, y,
        Z=torch.as_tensor(_rademacher(N, 32, 4)), num_probes=32,
        num_steps=40))
    got = _res(ranks, "solves")["lml"]
    assert abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_sharded_preconditioned_cg(ranks):
    """The row-sharded Woodbury preconditioner cuts the iterations at
    stiff hyperparameters, and both solves sit within 5e-3 (relative to
    the solution's norm) of the float64 direct solve, as JAX's test."""
    from cugp_tpu_torch.ops import kernels as tk

    X, y = _data()
    res = _res(ranks, "solves")
    (x_plain, it_plain), (x_pre, it_pre) = res["stiff_plain"], \
        res["stiff_pre"]
    assert it_pre < it_plain, (it_pre, it_plain)
    K = tk.train_covariance_plain(
        tk.init_params(d=3, lengthscale=1.6, noise_var=1e-3),
        torch.as_tensor(X, dtype=torch.float64)).numpy()
    x_dir = np.linalg.solve(K, y.astype(np.float64))
    scale = np.linalg.norm(x_dir)
    for x in (x_pre, x_plain):
        assert np.linalg.norm(x - x_dir) / scale < 5e-3


@pytest.mark.parametrize("kind", ["rbf", "rbf+linear"])
def test_sharded_gradients_match_jax_and_single_device(ranks, jmesh, kind):
    """hutchinson_grads_sharded given the same solves and probes against
    the JAX package's hutchinson_grads_sharded and the port's
    single-process hutchinson_grads_program (rtol 2e-3, atol 1e-4 of the
    gradient's norm, JAX's composite bar)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree as jravel
    from cugp_tpu.parallel import sp_iterative as jsp
    from cugp_tpu_torch.inference import iterative
    from cugp_tpu_torch.ops import kernels as tk
    from cugp_tpu_torch.utils.params import params_to_numpy, ravel_pytree

    d = 3 if kind == "rbf" else 2
    X, y = _data(d=d)
    z = _rademacher(N, 8, 3)
    p = (tk.init_params(d=3, lengthscale=1.1, noise_var=0.05)
         if kind == "rbf" else tk.default_init(kind, d=2, noise_var=0.05))
    res = _res(ranks, "grads")[kind]
    pj = jax.tree.map(jnp.asarray, params_to_numpy(p))
    gj = jsp.hutchinson_grads_sharded(pj, jnp.asarray(X),
                                      jnp.asarray(res["alpha"]),
                                      jnp.asarray(res["w"]), jnp.asarray(z),
                                      jmesh, kind=kind, axis="r")
    g_ref = iterative.hutchinson_grads_program(
        p, torch.as_tensor(X), torch.as_tensor(res["alpha"]),
        torch.as_tensor(res["w"]), torch.as_tensor(z), kind=kind)
    for want in (np.asarray(jravel(gj)[0]), ravel_pytree(g_ref)[0].numpy()):
        np.testing.assert_allclose(res["g"], want, rtol=2e-3,
                                   atol=1e-4 * np.linalg.norm(want))


def test_fit_iterative_sharded_matches_single_device(ranks):
    """fit_iterative_sharded equals map_opt.fit_iterative's split path
    (no warm start) on the same data and probe stream: losses at rtol
    1e-4, params at atol 2e-3 (JAX's bar), CG counts within one."""
    from cugp_tpu_torch.inference import map_opt
    from cugp_tpu_torch.ops import kernels as tk

    f = FIT
    X, y = _t(*_data(n=f["n"]))
    p_ref, info = map_opt.fit_iterative(
        tk.init_params(d=3, lengthscale=1.4, noise_var=0.3), X, y,
        steps=f["steps"], learning_rate=f["learning_rate"], tol=f["tol"],
        max_iters=f["max_iters"], num_probes=f["num_probes"],
        precond_rank=f["precond_rank"], split_programs=True,
        warm_start=False, generator=torch.Generator().manual_seed(5))
    for res in ranks.results():
        params, losses, cg_iters = res["fit"]["fit"]
        np.testing.assert_allclose(losses, info["loss"].numpy(), rtol=1e-4)
        # CG's counts may differ by one (the ranks' reduction order)
        assert np.abs(cg_iters - info["cg_iters"]).max() <= 1
        for k, v in p_ref.items():
            np.testing.assert_allclose(params[k], v.numpy(), atol=2e-3)


def test_sharded_logprob_matches_iterative(ranks):
    """make_sharded_logprob equals make_iterative_logprob under the same
    frozen probes: values at rtol 1e-4, gradients at rtol/atol 5e-3
    (JAX's bar)."""
    from cugp_tpu_torch.inference import sampling
    from cugp_tpu_torch.ops import kernels as tk

    X, y = _t(*_data())
    lp, _, q0 = sampling.make_iterative_logprob(
        tk.init_params(d=3, lengthscale=1.0, noise_var=0.1), X, y,
        tol=1e-7, max_iters=2000, num_probes=8, num_steps=20,
        Z=torch.as_tensor(_rademacher(N, 8, 11)))
    v_ref, g_ref = lp(torch.stack([q0 + dq for dq in (0.0, 0.15, -0.2)]))
    v, g = _res(ranks, "logprob_and_sample")["logprob"]
    np.testing.assert_allclose(v, v_ref.numpy(), rtol=1e-4)
    np.testing.assert_allclose(g, g_ref.numpy(), rtol=5e-3, atol=5e-3)


def test_sample_hyperparams_sharded_matches_iterative(ranks):
    """The matrix-free sampler over the ring against the single-process
    sample_hyperparams_iterative with the same draws and probes: the
    same draws on every rank, accept rate above 0.5, and each
    hyperparameter's posterior mean within 3 standard deviations of the
    single-process run's (JAX's bar: the two densities agree to CG's
    tolerance, which the chains' 12 transitions amplify)."""
    from cugp_tpu_torch.inference import hmc, sampling
    from cugp_tpu_torch.ops import kernels as tk

    s = SAMPLE
    X, y = _t(*_data(n=s["n"]))
    ref = sampling.sample_hyperparams_iterative(
        tk.init_params(d=3, lengthscale=1.0, noise_var=0.1), X, y,
        num_chains=s["chains"], num_warmup=s["warmup"],
        num_samples=s["samples"], n_leapfrog=s["n_leapfrog"], tol=1e-5,
        max_iters=1000, num_probes=s["probes"], num_steps=s["steps"],
        Z=torch.as_tensor(_rademacher(s["n"], s["probes"], 12)),
        rng=hmc.Draws(torch.Generator().manual_seed(9)))
    got, accept = _res(ranks, "logprob_and_sample")["sample"]
    assert np.isfinite(got).all() and accept > 0.5
    want = ref["samples_flat"].numpy()
    np.testing.assert_allclose(got.mean(axis=(0, 1)),
                               want.mean(axis=(0, 1)),
                               atol=3 * want.std() + 1e-3)
    for res in ranks.results():
        np.testing.assert_array_equal(
            res["logprob_and_sample"]["sample"][0], got)
