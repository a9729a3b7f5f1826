"""The port's distributed tier (cugp_tpu_torch/parallel, runtime) on four
gloo ranks on the CPU, against the JAX package's twins on the faked CPU
mesh of the same shape (make_mesh(4, dp=...) over 4 of conftest's 8
devices) and against the port's single-process functions.

The ranks start once for the whole file (``ranks`` fixture): each runs
every ``_case_*`` below and saves what it found; each test compares one
case. This module imports no jax at module level, so a rank process
loads torch only. Tolerances are those of the JAX package's own tests
(tests/dist/) unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

from tests import torch_ranks

torch.set_num_threads(1)

def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return ((q * eigs) @ q.T).astype(np.float32)


def _uniform(n, d, seed):
    return np.random.default_rng(seed).uniform(-2, 2, (n, d)).astype(
        np.float32)


def _ring_params():
    """(name, kind, axis, params-builder name, builder kwargs)."""
    return [("rbf", "rbf", "r", 3), ("rq", "rq", "r", 2),
            ("periodic", "periodic", "r", 2), ("linear", "linear", "r", 2),
            ("rbf+linear", "rbf+linear", "r", 2),
            ("periodic*rbf", "periodic*rbf", "r", 2),
            ("periodic*rbf+linear", "periodic*rbf+linear", "r", 2),
            ("rbf+linear_rc", "rbf+linear", ("r", "c"), 2)]


def _ring_init(kops, kind, d):
    if kind == "rbf" and d == 3:  # conftest's default_params, 3 dims
        return {"log_lengthscale": torch.log(torch.tensor([0.8, 1.1, 0.6])),
                "log_signal_var": torch.log(torch.tensor(1.2)),
                "log_noise_var": torch.log(torch.tensor(0.05))}
    if kind in ("rq", "periodic", "linear"):
        kw = {"rq": dict(alpha=1.7), "periodic": dict(period=1.4),
              "linear": dict(bias_var=0.5)}[kind]
        return kops.init_params(d=d, lengthscale=1.1, noise_var=0.05, **kw)
    return kops.default_init(kind, d=d, noise_var=0.05)


def _bc_cases():
    """(name, n, block, dp, pipelined, relayout) for block_cyclic."""
    return [("legacy_256", 256, 64, 1, False, "all_to_all"),
            ("pipe_a2a", 512, 64, 1, True, "all_to_all"),
            ("legacy_a2a", 512, 64, 1, False, "all_to_all"),
            ("pipe_gather", 512, 64, 1, True, "gather"),
            ("legacy_gather", 512, 64, 1, False, "gather"),
            ("dp2_b64", 256, 64, 2, True, "all_to_all"),
            ("dp1_b128", 1024, 128, 1, True, "all_to_all"),
            ("depth_nb32", 1024, 32, 1, True, "all_to_all"),
            ("depth_nb64", 512, 8, 1, True, "all_to_all")]


# ---- the rank side ----------------------------------------------------


def _counted(fn):
    from cugp_tpu_torch.parallel import collectives

    collectives.reset_counts()
    out = fn()
    return out, dict(collectives.CALLS)


def _case_mesh(meshes):
    from cugp_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for dp, m in meshes.items():
        out[dp] = {"shape": dict(m.shape), "coords": dict(m.coords),
                   "sizes": {str(a): m.group(a).size for a in
                             ("dp", "r", "c", ("r", "c"), ("dp", "r"),
                              ("dp", "r", "c"))},
                   "index_rc": m.axis_index(("r", "c")),
                   "grid": mesh_lib.grid_shape(m),
                   "K_2d": mesh_lib.sharding(m, "K_2d").slices((8, 8)),
                   "chains": mesh_lib.sharding(m, "chains").slices((8,))}
    for n, dp in ((4, 3), (3, 1)):
        try:
            mesh_lib.make_mesh(n, dp=dp)
            out[f"bad_{n}_{dp}"] = False
        except ValueError:
            out[f"bad_{n}_{dp}"] = True
    return out


def _case_block_cyclic(meshes):
    from cugp_tpu_torch.parallel import block_cyclic
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    for name, n, block, dp, pipelined, relayout in _bc_cases():
        m = meshes[dp]
        sp = Sharding(m, ("r", "c"))
        A = torch.as_tensor(_spd(n, n + block))
        L, calls = _counted(lambda: block_cyclic.block_cyclic_cholesky(
            sp.shard(A), m, block=block, pipelined=pipelined,
            relayout=relayout))
        out[name] = {"L": sp.gather(L).numpy(), "calls": calls}
    m = meshes[1]
    sp = Sharding(m, ("r", "c"))
    A = torch.as_tensor(_spd(768, 7))
    out["chunks"] = [sp.gather(block_cyclic.block_cyclic_cholesky(
        sp.shard(A), m, block=64, chunk=c)).numpy() for c in (8, 5, 1)]
    for what, args in (("bad_n", (torch.eye(50), m)),
                       ("bad_chunk", (sp.shard(A), m)),
                       ("bad_pipelined", (sp.shard(A), m))):
        try:
            block_cyclic.block_cyclic_cholesky(
                *args, block=64, chunk=0 if what == "bad_chunk" else 8,
                pipelined=None if what == "bad_pipelined" else True)
            out[what] = False
        except ValueError:
            out[what] = True
    return out


def _case_distributed_cholesky(meshes):
    from cugp_tpu_torch.parallel import distributed_chol
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    for dp, n, chunk in ((1, 768, 256), (2, 512, 96), (4, 512, 200)):
        m = meshes[dp]
        sp = Sharding(m, (("dp", "r"), "c"))
        A = torch.as_tensor(_spd(n, 11))
        L, calls = _counted(lambda: distributed_chol.distributed_cholesky(
            sp.shard(A), m, chunk=chunk))
        out[dp] = {"L": sp.gather(L).numpy(), "calls": calls}
    return out


def _case_ring(meshes):
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import ring
    from cugp_tpu_torch.parallel.mesh import Sharding

    m = meshes[1]
    out = {}
    for name, kind, axis, d in _ring_params():
        X = torch.as_tensor(_uniform(256, d, d))
        p = _ring_init(kops, kind, d)
        sp = Sharding(m, (axis, None))
        K, calls = _counted(lambda: ring.ring_train_covariance(
            p, sp.shard(X), m, kind=kind, jitter=1e-6, axis=axis))
        out[name] = {"K": sp.gather(K).numpy(), "calls": calls}
    # the hyperparameters' gradient: local blocks, one sum over the ring
    X = torch.as_tensor(_uniform(256, 3, 3))
    G = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (256, 256)).astype(np.float32))
    p = {k: v.requires_grad_(True) for k, v in
         _ring_init(kops, "rbf", 3).items()}
    sp = Sharding(m, (("r", "c"), None))
    K = ring.ring_train_covariance(p, sp.shard(X), m, axis=("r", "c"))
    grads = torch.autograd.grad(torch.sum(K * sp.shard(G)), list(p.values()))
    out["grad_local"] = [g.numpy() for g in grads]
    return out


def _case_relayout(meshes):
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import (block_cyclic, distributed_chol,
                                         relayout, ring)
    from cugp_tpu_torch.parallel.mesh import Sharding

    m = meshes[1]
    rows, two_d = Sharding(m, (("r", "c"), None)), Sharding(m, ("r", "c"))
    A = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 256)).astype(np.float32))
    a2d, calls = _counted(lambda: relayout.row_to_2d(rows.shard(A), m))
    back = relayout.two_d_to_row(a2d, m)
    out = {"to_2d_equal": torch.equal(a2d, two_d.shard(A)),
           "back_equal": torch.equal(back, rows.shard(A)),
           "local_shape": tuple(a2d.shape), "calls": calls}
    try:
        relayout.row_to_2d(torch.zeros((25, 99)), m)
        out["bad_shape"] = False
    except ValueError:
        out["bad_shape"] = True
    # ring covariance -> all_to_all -> distributed Cholesky
    X = torch.as_tensor(_uniform(256, 2, 21))
    p = kops.init_params(d=2, lengthscale=1.2, noise_var=0.05)
    K_rows = ring.ring_train_covariance(p, rows.shard(X), m,
                                        axis=("r", "c"))
    L = distributed_chol.distributed_cholesky(relayout.row_to_2d(K_rows, m),
                                              m, chunk=128)
    out["pipeline_L"] = two_d.gather(L).numpy()
    cyc = []
    for block, n in ((32, 256), (16, 256), (32, 384)):
        B = torch.as_tensor(np.random.default_rng(n + block)
                            .standard_normal((n, n)).astype(np.float32))
        got, calls_c = _counted(lambda: relayout.to_block_cyclic(
            two_d.shard(B), m, block))
        rp = block_cyclic.cyclic_permutation(n // block, 2, block)
        want = two_d.shard(B[rp][:, rp])
        cyc.append((torch.equal(got, want), torch.equal(
            relayout.from_block_cyclic(got, m, block), two_d.shard(B)),
            calls_c))
    out["cyclic"] = cyc
    K = kops.train_covariance(p, X)
    out["K_bc"] = K.numpy()
    out["bc_sched"] = two_d.gather(block_cyclic.block_cyclic_cholesky(
        two_d.shard(K), m, block=32)).numpy()
    out["bc_gather"] = two_d.gather(block_cyclic.block_cyclic_cholesky(
        two_d.shard(K), m, block=32, relayout="gather")).numpy()
    return out


def _lml_grads(fn, p):
    """(value, gradient in ravel_pytree's order) of fn(params)."""
    from cugp_tpu_torch.utils.params import ravel_pytree, tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    val = fn(p)
    val.backward()
    return float(val.detach()), ravel_pytree(
        tree_map(lambda t: t.grad, p))[0].numpy()


def _case_lml(meshes):
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import distributed_chol, gspmd
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    X, y, _ = synthetic.sinusoid_1d(n=512, seed=5)
    X = torch.as_tensor(X, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    p = kops.init_params(d=1, lengthscale=0.8, noise_var=0.05)
    for dp in (1, 2, 4):
        m = meshes[dp]
        sp = Sharding(m, (("dp", "r"), None))
        out[f"chunked_dp{dp}"] = _lml_grads(
            lambda q: distributed_chol.distributed_lml(
                q, sp.shard(X), sp.shard(y), m, chunk=256 if dp == 1
                else 96), p)
    m = meshes[1]
    sp = Sharding(m, (("dp", "r"), None))
    Xg, yg, _ = synthetic.sinusoid_1d(n=256, seed=6)
    Xg = torch.as_tensor(Xg, dtype=torch.float32)
    yg = torch.as_tensor(yg, dtype=torch.float32)
    out["gspmd"] = _lml_grads(lambda q: gspmd.lml_sharded(
        q, sp.shard(Xg), sp.shard(yg), m), kops.init_params(d=1))
    # two sharded Adam steps (both backends) at config 2's width
    Xm = torch.as_tensor(synthetic.multidim_regression(n=256, d=4)[0],
                         dtype=torch.float32)
    ym = torch.as_tensor(synthetic.multidim_regression(n=256, d=4)[1],
                         dtype=torch.float32)
    for backend in ("chunked", "gspmd"):
        step, tx = gspmd.make_map_train_step(m, lml_backend=backend,
                                             chunk=64)
        state = tx.init(kops.init_params(d=4))
        params, losses = state.params, []
        for _ in range(2):
            params, state, loss = step(params, state, sp.shard(Xm),
                                       sp.shard(ym))
            losses.append(float(loss))
        out[f"map_{backend}"] = ({k: v.detach().numpy()
                                  for k, v in params.items()}, losses)
    try:
        gspmd.make_map_train_step(m, lml_backend="nope")
        out["bad_backend"] = False
    except ValueError:
        out["bad_backend"] = True
    return out


# (dp, n, chunk): the closed-form LML's cases, several blocks a rank
CLOSED_FORM = ((1, 384, 64), (2, 384, 40), (4, 384, 40))


def _closed_form_problem(n):
    X = _uniform(n, 3, 17)
    rng = np.random.default_rng(18)
    y = (np.sin(2.0 * X.sum(1)) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)
    return X, y


def _closed_form_params(kops):
    p = kops.init_params(d=3, lengthscale=0.9, noise_var=0.01)
    p["log_lengthscale"] = torch.log(torch.tensor([0.7, 1.1, 0.9]))
    return p


def _case_closed_form(meshes):
    """The distributed LML's closed-form gradient on the Matern-3/2 kernel
    (the benchmark's), and the block-cyclic inverse it takes, in float64
    on the LML's layout (rows over ('dp', 'r'), columns over 'c')."""
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import block_cyclic, distributed_chol
    from cugp_tpu_torch.parallel.mesh import Sharding

    out = {}
    for dp, n, chunk in CLOSED_FORM:
        m = meshes[dp]
        sp = Sharding(m, (("dp", "r"), None))
        X, y = (torch.as_tensor(a) for a in _closed_form_problem(n))
        out[f"lml_dp{dp}"] = _lml_grads(
            lambda q: distributed_chol.distributed_lml(
                q, sp.shard(X), sp.shard(y), m, kind="matern32",
                chunk=chunk), _closed_form_params(kops))
        A = torch.as_tensor(_spd(256, 23).astype(np.float64))
        grid = block_cyclic.Grid(m, 256 // 16, 16, rows=("dp", "r"))
        rows, cols = grid.rows_index(), grid.cols_index()
        loc = A[rows][:, cols].clone()
        with torch.no_grad():
            block_cyclic.factor_(loc, grid)
            block_cyclic.trtri_(loc, grid)
            block_cyclic.lauum_(loc, grid)
        out[f"inv_dp{dp}"] = (loc.numpy(), rows.numpy(), cols.numpy())
    return out


def _draw_arrays(num_chains, dim, transitions, seed):
    """The replayed draws of a sharded HMC run: the (C, D) initial jitter,
    then per transition the step jitter u (C,), the momentum (C, D) and
    the accept uniforms (C,)."""
    rng = np.random.default_rng(seed)
    init = rng.standard_normal((num_chains, dim)).astype(np.float32)
    mom = rng.standard_normal((transitions, num_chains, dim)).astype(
        np.float32)
    uni = rng.uniform(size=(transitions, 2, num_chains)).astype(np.float32)
    return init, mom, uni


def _rank_draws(init, mom, uni, lo, hi):
    from cugp_tpu_torch.inference import hmc

    normals = [init] + [m[lo:hi] for m in mom]
    uniforms = [u[k][lo:hi] for u in uni for k in range(2)]
    return hmc.Draws(normals=normals, uniforms=uniforms)


SAMPLER_MATCH = dict(n=64, chains=8, warmup=8, samples=4)


def _case_sampling(meshes):
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import sharded_sampling

    out = {}
    m = meshes[4]
    X, y, _ = synthetic.sinusoid_1d(n=64, noise_std=0.2, seed=0)
    X, y = (torch.as_tensor(a, dtype=torch.float32) for a in (X, y))
    r = sharded_sampling.sample_hyperparams_sharded(
        kops.init_params(d=1, lengthscale=0.8, noise_var=0.05), X, y, m,
        sampler="nuts", num_chains=8, num_samples=12, num_warmup=20,
        max_tree_depth=4, key=1)
    out["nuts"] = {k: (v.numpy() if torch.is_tensor(v) else v)
                   for k, v in r.items() if k != "samples"}
    out["nuts_ls"] = r["samples"]["log_lengthscale"].numpy()
    X, y, _ = synthetic.sinusoid_1d(n=48, noise_std=0.2, seed=1)
    X, y = (torch.as_tensor(a, dtype=torch.float32) for a in (X, y))
    r = sharded_sampling.sample_hyperparams_sharded(
        kops.init_params(d=1), X, y, m, sampler="hmc", num_chains=8,
        num_samples=6, num_warmup=12, key=2)
    out["hmc_noise_shape"] = tuple(r["samples"]["log_noise_var"].shape)
    out["hmc_eps"] = r["eps_per_chip"].numpy()
    try:
        sharded_sampling.sample_hyperparams_sharded(
            kops.init_params(d=1), torch.zeros((8, 1)), torch.zeros(8), m,
            num_chains=5)
        out["bad_chains"] = False
    except ValueError:
        out["bad_chains"] = True
    # the same draws as one process running every chain (the test's)
    s = SAMPLER_MATCH
    X, y, _ = synthetic.sinusoid_1d(n=s["n"], noise_std=0.2, seed=3)
    X, y = (torch.as_tensor(a, dtype=torch.float32) for a in (X, y))
    init, mom, uni = _draw_arrays(s["chains"], 3,
                                  s["warmup"] + s["samples"], 9)
    local = s["chains"] // 4
    idx = m.group("dp").index
    r = sharded_sampling.sample_hyperparams_sharded(
        kops.init_params(d=1), X, y, m, sampler="hmc",
        num_chains=s["chains"], num_samples=s["samples"],
        num_warmup=s["warmup"],
        rng=_rank_draws(init, mom, uni, idx * local, (idx + 1) * local))
    out["match"] = {k: r[k].numpy() for k in
                    ("samples_flat", "eps_per_chip", "inv_mass_per_chip",
                     "accept_rate")}
    # large n: every density evaluation sharded over the 2 x 2 grid
    m1 = meshes[1]
    X, y, _ = synthetic.sinusoid_1d(n=128, noise_std=0.2, seed=0)
    X, y = (torch.as_tensor(a, dtype=torch.float32) for a in (X, y))
    from cugp_tpu_torch.parallel.mesh import Sharding

    sp = Sharding(m1, (("dp", "r"), None))
    r = sharded_sampling.sample_hyperparams_large_n(
        kops.init_params(d=1, lengthscale=0.8, noise_var=0.05),
        sp.shard(X), sp.shard(y), m1, chunk=64, num_chains=2,
        num_samples=4, num_warmup=4, max_tree_depth=3, key=0)
    out["large_n_noise"] = r["samples"]["log_noise_var"].numpy()
    return out


CASES = {"mesh": _case_mesh, "block_cyclic": _case_block_cyclic,
         "distributed_cholesky": _case_distributed_cholesky,
         "ring": _case_ring, "relayout": _case_relayout, "lml": _case_lml,
         "closed_form": _case_closed_form, "sampling": _case_sampling}


def _worker(rank, world, tmp):
    info = torch_ranks.init_worker(rank, world, tmp)
    from cugp_tpu_torch.parallel import mesh as mesh_lib

    meshes = {dp: mesh_lib.make_mesh(world, dp=dp) for dp in (1, 2, 4)}
    out = torch_ranks.run_cases(CASES, meshes)
    out["runtime"] = vars(info)
    torch_ranks.finish_worker(rank, tmp, out)


# ---- the test side ----------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.Ranks("tests.test_torch_parallel",
                             tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jmesh():
    from cugp_tpu.parallel import mesh as mesh_lib

    return {dp: mesh_lib.make_mesh(4, dp=dp) for dp in (1, 2, 4)}


def _res(ranks, case, rank=0):
    return ranks.results()[rank][case]


@pytest.mark.parametrize("name", [c[0] for c in _bc_cases()])
def test_block_cyclic_matches_single_device(ranks, jmesh, name):
    """Either `pipelined` value, each relayout and mesh shape against the
    float64 factor at the JAX package's bars (reconstruction at rtol
    1e-3, atol 1e-4); the 256-row pipelined=False case also against the
    JAX package's block_cyclic_cholesky on the same mesh, its legacy body
    (its shard_map bodies take 23 s (legacy) to 51 s (look-ahead) to
    compile on the faked mesh at 4 panels, so one twin runs: first, while
    the ranks work)."""
    import jax.numpy as jnp
    from cugp_tpu.parallel import block_cyclic as jbc

    _, n, block, dp, pipelined, relayout = dict(
        (c[0], c) for c in _bc_cases())[name]
    a = _spd(n, n + block)
    lj = None
    if name == "legacy_256":
        lj = np.asarray(jbc.block_cyclic_cholesky(
            jnp.asarray(a), jmesh[dp], block=block, pipelined=pipelined))
    L = _res(ranks, "block_cyclic")[name]["L"]
    l_ref = np.linalg.cholesky(np.asarray(a, np.float64))
    np.testing.assert_allclose(L, l_ref, rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(L @ L.T, a, rtol=1e-3, atol=1e-4)
    if lj is not None:
        np.testing.assert_allclose(L, lj, rtol=1e-5, atol=1e-5)


def mesh_specs():
    from cugp_tpu.parallel import mesh as jmesh_lib

    return {k: tuple(v) for k, v in jmesh_lib.SPECS.items()}


def _bounds(slices, shape):
    return [(s.start or 0, n if s.stop is None else s.stop)
            for s, n in zip(slices, shape)]


def test_runtime_and_mesh(ranks, jmesh):
    """runtime.initialize's RuntimeInfo and make_mesh's layout: the JAX
    mesh's shape, row-major coordinates, the group sizes, the blocks
    JAX's NamedSharding gives each device, the rejections."""
    import jax

    for rank, res in enumerate(ranks.results()):
        assert res["runtime"] == {"process_index": rank, "process_count": 4,
                                  "local_devices": 1, "global_devices": 4,
                                  "backend": "gloo"}
        for dp, jm in jmesh.items():
            got = res["mesh"][dp]
            assert got["shape"] == dict(jm.shape)
            ids = np.vectorize(lambda dv: dv.id)(jm.devices)
            assert tuple(int(i) for i in np.argwhere(ids == rank)[0]) == (
                got["coords"]["dp"], got["coords"]["r"], got["coords"]["c"])
            sh = jm.shape
            assert got["sizes"] == {
                "dp": sh["dp"], "r": sh["r"], "c": sh["c"],
                "('r', 'c')": sh["r"] * sh["c"],
                "('dp', 'r')": sh["dp"] * sh["r"], "('dp', 'r', 'c')": 4}
            assert got["grid"] == (sh["r"], sh["c"])
            # the rank's block under JAX's PartitionSpecs
            for name, shape in (("K_2d", (8, 8)), ("chains", (8,))):
                js = jax.sharding.NamedSharding(
                    jm, jax.sharding.PartitionSpec(*mesh_specs()[name]))
                want = js.devices_indices_map(shape)[jm.devices.flat[rank]]
                assert _bounds(got[name], shape) == _bounds(want, shape)
        assert res["mesh"]["bad_4_3"] and res["mesh"]["bad_3_1"]


def test_runtime_cuda_without_card_raises():
    from cugp_tpu_torch import runtime

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.initialize(device="cuda")
    info = runtime.initialize(device="cpu")
    assert (info.process_index, info.process_count, info.backend) == (
        0, 1, "cpu")


def test_host_shard_matches_jax():
    from cugp_tpu.data import synthetic as jsyn
    from cugp_tpu_torch.data import synthetic as tsyn

    X, y, _ = jsyn.sinusoid_1d(n=103, seed=2)
    for i in range(4):
        for a, b in zip(tsyn.host_shard(X, y, i, 4),
                        jsyn.host_shard(X, y, i, 4)):
            np.testing.assert_array_equal(a, b)


def test_block_cyclic_pipelined_matches_legacy(ranks):
    """pipelined=False (JAX's legacy body there) runs the same look-ahead
    body here: the same bits under each relayout."""
    bc = _res(ranks, "block_cyclic")
    np.testing.assert_array_equal(bc["legacy_a2a"]["L"], bc["pipe_a2a"]["L"])
    np.testing.assert_array_equal(bc["legacy_gather"]["L"],
                                  bc["pipe_gather"]["L"])
    np.testing.assert_allclose(bc["pipe_a2a"]["L"], bc["pipe_gather"]["L"],
                               atol=1e-5)


def test_block_cyclic_pipelined_collectives(ranks):
    """The look-ahead body broadcasts (no all_reduce) at every depth and
    under either `pipelined` value. The all_to_all relayout moves the
    matrix with all_to_alls; "gather" all-gathers it."""
    for res in ranks.results():
        bc = res["block_cyclic"]
        for name in ("pipe_a2a", "legacy_a2a", "dp1_b128", "depth_nb32",
                     "depth_nb64"):
            calls = bc[name]["calls"]
            assert calls.get("all_reduce", 0) == 0, (name, calls)
            assert calls["broadcast"] > 0 and calls["all_to_all"] > 0
        assert bc["pipe_gather"]["calls"].get("all_to_all", 0) == 0


def test_block_cyclic_chunk_and_rejections(ranks):
    """`chunk` (JAX's trace-size knob) changes nothing: chunks of 8, 5 and
    1 give the same bits; bad sizes, a bad chunk and a `pipelined` that is
    no bool raise."""
    bc = _res(ranks, "block_cyclic")
    a, b, c = bc["chunks"]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_allclose(
        a, np.linalg.cholesky(_spd(768, 7).astype(np.float64)), rtol=2e-2,
        atol=2e-4)
    assert bc["bad_n"] and bc["bad_chunk"] and bc["bad_pipelined"]


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_distributed_cholesky(ranks, jmesh, dp):
    """The block-cyclic factor (blocks of 192, 64 and 128 from chunks of
    256, 96 and 200) against float64 and, on the 2 x 2 grid, against the
    JAX package's distributed_cholesky (its chunked sweep); the factor
    moves with broadcasts and all_to_alls, and no all_reduce."""
    import jax
    import jax.numpy as jnp
    from cugp_tpu.parallel import distributed_chol as jdc

    n, chunk = {1: (768, 256), 2: (512, 96), 4: (512, 200)}[dp]
    a = _spd(n, 11)
    L = _res(ranks, "distributed_cholesky")[dp]["L"]
    for res in ranks.results():
        calls = res["distributed_cholesky"][dp]["calls"]
        assert calls.get("all_reduce", 0) == 0, calls
        assert calls["broadcast"] > 0 and calls["all_to_all"] > 0, calls
    np.testing.assert_allclose(
        L, np.linalg.cholesky(a.astype(np.float64)), rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(L @ L.T, a, rtol=1e-3, atol=1e-4)
    if dp == 1:
        lj = jax.jit(lambda a: jdc.distributed_cholesky(
            a, jmesh[1], chunk=chunk))(jnp.asarray(a))
        np.testing.assert_allclose(L, np.asarray(lj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in _ring_params()])
def test_ring_covariance_matches_jax(ranks, jmesh, name):
    """ring_train_covariance per family, composite and ring axis against
    the JAX package's ring build and its XLA covariance (rtol 1e-5, atol
    1e-6; 1e-5 for composites, as JAX's tests). The ring moves X with
    ring shifts only."""
    import jax
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import ring as jring
    from cugp_tpu_torch.ops import kernels as tk
    from cugp_tpu_torch.utils.params import params_to_numpy

    _, kind, axis, d = dict((c[0], c) for c in _ring_params())[name]
    X = jnp.asarray(_uniform(256, d, d))
    pj = jax.tree.map(jnp.asarray, params_to_numpy(_ring_init(tk, kind, d)))
    res = _res(ranks, "ring")[name]
    atol = 1e-5 if "+" in kind or "*" in kind else 1e-6
    K_ref = jk.train_covariance_xla(pj, X, kind=kind, jitter=1e-6)
    np.testing.assert_allclose(res["K"], np.asarray(K_ref), rtol=1e-5,
                               atol=atol)
    if name in ("rbf", "rbf+linear_rc"):
        Kj = jring.ring_train_covariance(pj, X, jmesh[1], kind=kind,
                                         jitter=1e-6, axis=axis)
        np.testing.assert_allclose(res["K"], np.asarray(Kj), rtol=1e-5,
                                   atol=atol)
    assert set(res["calls"]) <= {"ppermute", "all_gather"}
    assert res["calls"]["ppermute"] > 0


def test_ring_gradient_is_local(ranks):
    """Rotating raw rows keeps the collectives off the gradient: the sum
    over ranks of each rank's local gradient of <K_loc, G_loc> is the
    single-process gradient of <K, G>."""
    from cugp_tpu_torch.ops import kernels as tk

    p = {k: v.requires_grad_(True) for k, v in
         _ring_init(tk, "rbf", 3).items()}
    X = torch.as_tensor(_uniform(256, 3, 3))
    G = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (256, 256)).astype(np.float32))
    ref = torch.autograd.grad(torch.sum(tk.train_covariance(p, X) * G),
                              list(p.values()))
    got = [sum(r["ring"]["grad_local"][i] for r in ranks.results())
           for i in range(len(ref))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-4, atol=1e-3)


def test_relayout_roundtrip_and_collectives(ranks):
    """row_to_2d gives each rank its (n/R, n/C) block bitwise, and back;
    one all_to_all, no all_gather or all_reduce; bad shapes raise."""
    for res in ranks.results():
        rl = res["relayout"]
        assert rl["to_2d_equal"] and rl["back_equal"]
        assert rl["local_shape"] == (128, 128)
        assert rl["calls"] == {"all_to_all": 1}
        assert rl["bad_shape"]


def test_to_block_cyclic_matches_permutation(ranks):
    """The scheduled exchange is the global permutation bitwise (divisible
    and padded block counts), its inverse restores the matrix, and it
    moves data with all_to_alls only."""
    for res in ranks.results():
        for fwd_ok, inv_ok, calls in res["relayout"]["cyclic"]:
            assert fwd_ok and inv_ok
            assert set(calls) == {"all_to_all"}


def test_config5_pipeline_ring_relayout_cholesky(ranks, jmesh):
    """Ring covariance over ('r', 'c') -> all_to_all relayout ->
    distributed Cholesky == the single-device factor and the JAX
    package's pipeline (rtol 1e-4, atol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import distributed_chol as jdc
    from cugp_tpu.parallel import relayout as jrl
    from cugp_tpu.parallel import ring as jring

    rl = _res(ranks, "relayout")
    X = jnp.asarray(_uniform(256, 2, 21))
    p = jk.init_params(d=2, lengthscale=1.2, noise_var=0.05)
    m = jmesh[1]
    K_rows = jring.ring_train_covariance(p, X, m, kind="rbf", jitter=1e-6,
                                         axis=("r", "c"))
    Lj = jax.jit(lambda K: jdc.distributed_cholesky(K, m, chunk=128))(
        jrl.row_to_2d(K_rows, m))
    L_ref = jnp.linalg.cholesky(jk.train_covariance_xla(p, X, kind="rbf",
                                                        jitter=1e-6))
    for want in (Lj, L_ref):
        np.testing.assert_allclose(rl["pipeline_L"], np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    # block_cyclic's two relayouts agree with each other and the factor
    np.testing.assert_allclose(rl["bc_sched"], rl["bc_gather"], atol=1e-5)
    np.testing.assert_allclose(
        rl["bc_sched"], np.linalg.cholesky(rl["K_bc"].astype(np.float64)),
        rtol=1e-4, atol=1e-5)


def _jax_lml_grad(fn, p):
    import jax
    from jax.flatten_util import ravel_pytree

    val, g = jax.jit(jax.value_and_grad(fn))(p)
    return float(val), np.asarray(ravel_pytree(g)[0])


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_distributed_lml_and_gradient(ranks, jmesh, dp):
    """distributed_lml's value and gradient: the same on every rank,
    against the port's single-process LML (rtol 1e-5 for the value,
    1e-4 of the largest gradient component) and against the JAX
    package's distributed_lml and its jax.grad on the same mesh shape."""
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import distributed_chol as jdc
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.models import exact_gp
    from cugp_tpu_torch.ops import kernels as tk

    X, y, _ = synthetic.sinusoid_1d(n=512, seed=5)
    vals = [r["lml"][f"chunked_dp{dp}"] for r in ranks.results()]
    for v, g in vals[1:]:
        assert v == vals[0][0]
        np.testing.assert_array_equal(g, vals[0][1])
    val, grad = vals[0]
    ref_v, ref_g = _lml_grads(lambda q: exact_gp.log_marginal_likelihood(
        q, torch.as_tensor(X, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32)),
        tk.init_params(d=1, lengthscale=0.8, noise_var=0.05))
    assert abs(val - ref_v) <= 1e-5 * abs(ref_v)
    assert np.abs(grad - ref_g).max() <= 1e-4 * np.abs(ref_g).max()
    jv, jg = _jax_lml_grad(lambda p: jdc.distributed_lml(
        p, jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jmesh[dp], chunk=256 if dp == 1 else 96),
        jk.init_params(d=1, lengthscale=0.8, noise_var=0.05))
    assert abs(val - jv) <= 1e-5 * abs(jv)
    assert np.abs(grad - jg).max() <= 1e-4 * np.abs(jg).max()


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_closed_form_lml_matches_float64_reference(ranks, dp):
    """The distributed LML's value and closed-form gradient on the
    Matern-3/2 kernel against the benchmark's float64 reference
    (portbench/reference/matern32.py; rtol 1e-5 for the value, 1e-4 of
    the largest gradient component), the same bits on every rank."""
    from cugp_tpu_torch.ops import kernels as tk
    from portbench.reference import matern32

    n = dict((d, n) for d, n, _ in CLOSED_FORM)[dp]
    X, y = (torch.as_tensor(a) for a in _closed_form_problem(n))
    vals = [r["closed_form"][f"lml_dp{dp}"] for r in ranks.results()]
    for v, g in vals[1:]:
        assert v == vals[0][0]
        np.testing.assert_array_equal(g, vals[0][1])
    val, grad = vals[0]
    ref_v, ref_g = matern32.lml_and_grad(X, y, _closed_form_params(tk), 1e-6)
    ref_g = np.concatenate([ref_g[k].reshape(-1).numpy() for k in
                            ("log_lengthscale", "log_noise_var",
                             "log_signal_var")])  # ravel_pytree's order
    assert abs(val - ref_v) <= 1e-5 * abs(ref_v)
    assert np.abs(grad - ref_g).max() <= 1e-4 * np.abs(ref_g).max()


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_block_cyclic_inverse_matches_inv(ranks, dp):
    """factor_, trtri_ and lauum_ on every rank's block-cyclic block, in
    float64: the lower blocks, put back in global order, are those of
    torch.linalg.inv (1e-10 of its largest entry)."""
    A = _spd(256, 23).astype(np.float64)
    want = torch.linalg.inv(torch.as_tensor(A)).numpy()
    got = np.full_like(want, np.nan)
    for res in ranks.results():
        loc, rows, cols = res["closed_form"][f"inv_dp{dp}"]
        lower = (rows[:, None] // 16) >= (cols[None, :] // 16)
        sub = got[np.ix_(rows, cols)]
        sub[lower] = loc[lower]
        got[np.ix_(rows, cols)] = sub
    lower = np.arange(256)[:, None] // 16 >= np.arange(256)[None, :] // 16
    assert not np.isnan(got[lower]).any()
    np.testing.assert_allclose(got[lower], want[lower], rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_four_device_reference_matches_dense():
    """portbench/reference/matern32_dist4 (lower tiles over four "devices",
    here the CPU four times, ragged tiles) equals the dense float64
    reference to rounding."""
    from portbench.reference import matern32, matern32_dist4

    X, y = (torch.as_tensor(a) for a in _closed_form_problem(300))
    p = {"log_lengthscale": torch.log(torch.tensor([0.7, 1.1, 0.9])),
         "log_signal_var": torch.tensor(0.2),
         "log_noise_var": torch.tensor(-3.0)}
    v0, g0 = matern32.lml_and_grad(X, y, p, 1e-6)
    for tile in (64, 77, 300):
        v1, g1 = matern32_dist4.lml_and_grad(X, y, p, 1e-6, ["cpu"] * 4,
                                             tile=tile)
        assert abs(v1 - v0) <= 1e-12 * abs(v0)
        for k in g0:
            np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(),
                                       rtol=1e-10, atol=1e-10)


def test_gspmd_lml_sharded(ranks, jmesh):
    """lml_sharded (sharded covariance, replicated factor) and its
    gradient against the JAX package's lml_sharded (the value at JAX's
    bar |diff| / n < 1e-3 and at rtol 1e-5)."""
    import jax.numpy as jnp
    from cugp_tpu.ops import kernels as jk
    from cugp_tpu.parallel import gspmd as jg
    from cugp_tpu_torch.data import synthetic

    X, y, _ = synthetic.sinusoid_1d(n=256, seed=6)
    val, grad = _res(ranks, "lml")["gspmd"]
    jv, jgr = _jax_lml_grad(lambda p: jg.lml_sharded(
        p, jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jmesh[1]), jk.init_params(d=1))
    assert abs(val - jv) / 256 < 1e-3
    assert abs(val - jv) <= 1e-5 * abs(jv)
    assert np.abs(grad - jgr).max() <= 1e-4 * np.abs(jgr).max()


@pytest.mark.parametrize("backend", ["chunked", "gspmd"])
def test_map_train_step_matches_fit(ranks, backend):
    """Two sharded Adam steps equal two steps of map_opt.fit on one
    process (params within 1e-4); every rank's params are the same
    bits; an unknown backend raises."""
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import map_opt
    from cugp_tpu_torch.ops import kernels as tk

    X, y, _ = synthetic.multidim_regression(n=256, d=4)
    p_ref, info = map_opt.fit(tk.init_params(d=4), torch.as_tensor(
        X, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32),
        steps=2, learning_rate=0.05)
    res = [r["lml"][f"map_{backend}"] for r in ranks.results()]
    for params, losses in res[1:]:
        for k in params:
            np.testing.assert_array_equal(params[k], res[0][0][k])
    params, losses = res[0]
    np.testing.assert_allclose(losses, info["loss"].numpy(), rtol=1e-5)
    for k, v in p_ref.items():
        np.testing.assert_allclose(params[k], v.numpy(), atol=1e-4)
    assert _res(ranks, "lml")["bad_backend"]


def test_sharded_nuts_adapts_identically(ranks):
    """Chains over dp=4: shapes, finite draws, and the all-reduced
    adaptation gives every rank the same step size and mass (rtol 1e-6,
    JAX's bar); HMC's step sizes are the same bits; bad chain counts
    raise."""
    for res in ranks.results():
        s = res["sampling"]
        assert s["nuts_ls"].shape == (12, 8, 1)
        assert np.isfinite(s["nuts_ls"]).all()
        eps = s["nuts"]["eps_per_chip"]
        assert eps.shape == (4,)
        np.testing.assert_allclose(eps, eps[0], rtol=1e-6)
        im = s["nuts"]["inv_mass_per_chip"]
        np.testing.assert_allclose(im, np.broadcast_to(im[0], im.shape),
                                   rtol=1e-6)
        assert 0.2 < float(s["nuts"]["accept_rate"]) <= 1.0
        assert s["hmc_noise_shape"] == (6, 8)
        np.testing.assert_array_equal(s["hmc_eps"], s["hmc_eps"][0])
        assert s["bad_chains"]


def test_sharded_hmc_matches_one_process(ranks):
    """With the draws passed in, the chain-sharded HMC (2 chains on each
    of 4 ranks, psum'd adaptation) equals one process running all 8
    chains in a batch: draws within 1e-4, the step size and mass within
    1e-6 relative (the ranks' reduction order against one batch)."""
    from cugp_tpu_torch.data import synthetic
    from cugp_tpu_torch.inference import sampling
    from cugp_tpu_torch.ops import kernels as tk

    s = SAMPLER_MATCH
    X, y, _ = synthetic.sinusoid_1d(n=s["n"], noise_std=0.2, seed=3)
    init, mom, uni = _draw_arrays(s["chains"], 3,
                                  s["warmup"] + s["samples"], 9)
    ref = sampling.sample_hyperparams(
        tk.init_params(d=1), torch.as_tensor(X, dtype=torch.float32),
        torch.as_tensor(y, dtype=torch.float32), sampler="hmc",
        num_chains=s["chains"], num_samples=s["samples"],
        num_warmup=s["warmup"],
        rng=_rank_draws(init, mom, uni, 0, s["chains"]))
    got = _res(ranks, "sampling")["match"]
    np.testing.assert_allclose(got["eps_per_chip"], float(ref["eps"]),
                               rtol=1e-6)
    np.testing.assert_allclose(
        got["inv_mass_per_chip"],
        np.broadcast_to(ref["inv_mass"].numpy(),
                        got["inv_mass_per_chip"].shape), rtol=1e-6)
    q = np.concatenate([ref["samples"][k].reshape(
        s["samples"], s["chains"], -1).numpy()
        for k in sorted(ref["samples"])], axis=-1)  # ravel_pytree's order
    np.testing.assert_allclose(got["samples_flat"], q, atol=1e-4)


def test_large_n_distributed_sampling(ranks):
    """NUTS where each LML is the distributed sweep (2 x 2 grid, tiny
    sizes): shapes, finite, the same draws on every rank."""
    ref = _res(ranks, "sampling")["large_n_noise"]
    assert ref.shape == (4, 2) and np.isfinite(ref).all()
    for res in ranks.results():
        np.testing.assert_array_equal(res["sampling"]["large_n_noise"], ref)
