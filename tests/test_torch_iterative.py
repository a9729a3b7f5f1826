"""Parity of the port's matrix-free tier with the JAX package (CPU).

On CPU tensors the fused matvec runs its plain version
(cov_matvec_cuda.cov_matvec_plain) and the preconditioner's Cholesky and
solves run theirs; the JAX side runs as its own tests run it (the fused
Pallas matvec in interpret mode, everything else through XLA). The same
float32 inputs, and the same Rademacher probes (drawn with jax.random and
handed to the port), go through both. Tolerances are stated per test.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.inference import iterative as ji
from cugp_tpu.inference import map_opt as jmap
from cugp_tpu.ops import cov_pallas
from cugp_tpu.ops import kernels as jk

import cugp_tpu_torch
from cugp_tpu_torch.inference import iterative as ti
from cugp_tpu_torch.inference import map_opt as tmap
from cugp_tpu_torch.models import exact_gp as tgp
from cugp_tpu_torch.ops import cov_matvec_cuda
from cugp_tpu_torch.utils.params import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

BASE_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "linear",
              "periodic")
COMPOSITE = "rbf*periodic+linear"


def np_params(kind, d, seed):
    """The JAX default_init tree, each leaf shifted by a seeded offset."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v, np.float32)
                   + rng.uniform(-0.3, 0.3, np.shape(v))).astype(np.float32),
        jk.default_init(kind, d=d))


def inputs(n, d, seed):
    """U(-1.5, 1.5) / sqrt(d): unit-order scaled distances at every d."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (n, d)) / np.sqrt(d)).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def tp(P):
    return params_from_numpy(P, "cpu")


def rademacher(key, n, p):
    return np.asarray(jax.random.rademacher(key, (n, p), dtype=jnp.float32))


def matvec_slack(kind, X, P, V):
    """Extra absolute tolerance per output entry for matern12.

    exp(-r) has slope -1 at r = 0, so the fp32 rounding of
    d2 = s1 + s2 - 2 cross near coincident points (summed in another order
    by each framework) becomes an entry error of up to
    sf2 sqrt(8 eps (s1 + s2)); each output sums those entries against |V|.
    """
    if kind != "matern12":
        return 0.0
    ell = np.exp(np.asarray(P["log_lengthscale"], np.float64))
    a = X / ell
    s = (a * a).sum(1)
    s12 = s[:, None] + s[None, :]
    d2 = np.maximum(s12 - 2 * a @ a.T, 0.0)
    sf2 = float(np.exp(P["log_signal_var"]))
    slack = 1.3 * sf2 * np.sqrt(8 * np.finfo(np.float32).eps * s12)
    slack = np.where(d2 < 1e-2, slack, 0.0)
    V2 = np.abs(V if V.ndim == 2 else V[:, None])
    out = slack @ V2
    return out if V.ndim == 2 else out[:, 0]


@pytest.fixture(scope="module")
def problem():
    """A 256-point, d=3 regression problem at fixed rbf hyperparameters."""
    rng = np.random.default_rng(0)
    X = inputs(256, 3, seed=1) * 2.0
    y = (np.sin(2.0 * X).sum(1) + 0.2 * rng.standard_normal(256)).astype(
        np.float32)
    P = jax.tree.map(np.asarray, jk.init_params(d=3, lengthscale=0.8,
                                                noise_var=0.05))
    return X, y, P


@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("kind", BASE_KINDS)
def test_train_cov_matvec_matches_pallas(kind, r):
    """The fused matvec's plain version against the Pallas kernel in
    interpret mode: d=3, n=300 (not a multiple of any block), a vector
    (r=1) and a block (r=5). rtol = atol = 1e-4 (test_iterative.py:90),
    plus the matern12 near-diagonal slack."""
    P = np_params(kind, 3, seed=3)
    X = inputs(300, 3, seed=4)
    rng = np.random.default_rng(5)
    V = rng.standard_normal(300 if r == 1 else (300, r)).astype(np.float32)
    want = np.asarray(cov_pallas.train_cov_matvec_pallas(
        P, jnp.asarray(X), jnp.asarray(V), kind=kind, jitter=1e-6))
    got = cov_matvec_cuda.train_cov_matvec(tp(P), t(X), t(V), kind=kind,
                                           jitter=1e-6).numpy()
    assert got.shape == want.shape == V.shape
    tol = 1e-4 + 1e-4 * np.abs(want) + matvec_slack(kind, X, P, V)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def matvec_route_model(xs, v, scal, n):
    """csrc/cov_matvec.cu's rbf arithmetic in fp32 torch ops.

    The pre-pass: rows times sqrt(log2 e) and their half squared norms h,
    summed in the cross term's order (so the diagonal exponent is exactly
    0). Each entry is K / sf2 = 2^((cross - h_i) - h_j); sf2 and diag_add
    are applied once per output. The sums run in the route's order:
    narrow (r <= 32), each of the 8 warps adds its 8 columns of every
    64-column tile, tile by tile, then the warps' partials are added in
    warp order; wide, the columns in order.
    """
    a = xs[:n] * 1.2011224087864498
    cross = torch.zeros(n, n)
    for k in range(a.shape[1]):
        cross = cross + a[:, k:k + 1] * a[None, :, k]
    h = 0.5 * torch.diagonal(cross)
    e = (cross - h[:, None]) - h[None, :]
    assert bool((torch.diagonal(e) == 0).all())
    k2 = torch.exp2(e)
    v = v[:n]
    if v.shape[1] <= 32:
        parts = torch.zeros(8, n, v.shape[1])
        for j in range(n):
            w = j % 64 // 8
            parts[w] = parts[w] + k2[:, j:j + 1] * v[j]
        s = parts[0]
        for w in range(1, 8):
            s = s + parts[w]
    else:
        s = torch.zeros(n, v.shape[1])
        for j in range(n):
            s = s + k2[:, j:j + 1] * v[j]
    return scal[0] * s + scal[1] * v


@pytest.mark.parametrize("r", [9, 33])
def test_cov_matvec_route_model(r):
    """The kernel's rbf arithmetic (log2-unit rows, exp2 of the half-norm
    exponent, hoisted norms, sf2 per output, the route's summation order)
    against the Pallas kernel in interpret mode and cov_matvec_plain:
    n=300 (ragged against every tile), d=3, r = 9 (narrow) and 33
    (wide), rtol = atol = 1e-4."""
    P = np_params("rbf", 3, seed=9)
    X = inputs(300, 3, seed=10)
    V = np.random.default_rng(11).standard_normal((300, r)).astype(
        np.float32)
    p = tp(P)
    xs = t(X) / torch.exp(p["log_lengthscale"])
    sf2 = torch.exp(p["log_signal_var"])
    scal = torch.stack([sf2, torch.exp(p["log_noise_var"]) + 1e-6 * sf2,
                        torch.ones(())])
    got = matvec_route_model(xs, t(V), scal, 300).numpy()
    want_pallas = np.asarray(cov_pallas.train_cov_matvec_pallas(
        P, jnp.asarray(X), jnp.asarray(V), kind="rbf", jitter=1e-6))
    want_plain = cov_matvec_cuda.cov_matvec_plain(xs, t(V), scal, "rbf",
                                                  300).numpy()
    for want in (want_pallas, want_plain):
        assert got.shape == want.shape == (300, r)
        err = np.abs(got - want)
        assert (err <= 1e-4 + 1e-4 * np.abs(want)).all(), err.max()


@pytest.mark.parametrize("kind", ["rbf", "matern32", "rq", "linear"])
def test_matvec_wide_d_matches_blocked_jax(kind):
    """d=40, past the Pallas kernel's d <= 32: the port's fused route
    against JAX make_matvec(method="xla"), rtol = atol = 1e-4."""
    P = np_params(kind, 40, seed=6)
    X = inputs(200, 40, seed=7)
    V = np.random.default_rng(8).standard_normal((200, 3)).astype(
        np.float32)
    want = np.asarray(ji.make_matvec(P, jnp.asarray(X), kind=kind,
                                     block=64, method="xla")(jnp.asarray(V)))
    got = ti.make_matvec(tp(P), t(X), kind=kind, method="fused")(
        t(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_periodic_wide_d_fused_route():
    """The JAX fault (ROADMAP §3): periodic at d=20 doubles to 40 features
    in the cos/sin view, so the fused Pallas matvec raises ValueError
    (make_matvec's 'auto' picks it on TPU). The port decides from the
    width the kernel sees and answers as JAX's blocked route does
    (rtol = atol = 1e-4)."""
    P = np_params("periodic", 20, seed=9)
    X = inputs(150, 20, seed=10)
    V = np.random.default_rng(11).standard_normal((150, 2)).astype(
        np.float32)
    with pytest.raises(ValueError, match="d<=32"):
        cov_pallas.train_cov_matvec_pallas(P, jnp.asarray(X),
                                           jnp.asarray(V), kind="periodic")
    want = np.asarray(ji.make_matvec(P, jnp.asarray(X), kind="periodic",
                                     block=64, method="xla")(jnp.asarray(V)))
    got = ti.make_matvec(tp(P), t(X), kind="periodic")(t(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", [COMPOSITE, "matern52"])
def test_blocked_route_matches_jax(kind):
    """The blocked route (per-factor covariance tiles, combined, then @),
    a ragged last block (n=300, block=128), vs JAX make_matvec(xla);
    rtol = atol = 1e-4."""
    P = np_params(kind, 3, seed=12)
    X = inputs(300, 3, seed=13)
    V = np.random.default_rng(14).standard_normal((300, 4)).astype(
        np.float32)
    want = np.asarray(ji.make_matvec(P, jnp.asarray(X), kind=kind,
                                     block=128, method="xla")(jnp.asarray(V)))
    got = ti.make_matvec(tp(P), t(X), kind=kind, block=128,
                         method="blocked")(t(V)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if kind == COMPOSITE:  # "auto" routes a composite to the blocked tiles
        auto = ti.make_matvec(tp(P), t(X), kind=kind, block=128)(t(V))
        assert torch.equal(auto, torch.tensor(got))


def test_fused_route_refuses_gradients(problem):
    """The fused kernel has no backward: asking it for one raises and
    names the blocked route, on the CPU as on the card; the blocked route
    differentiates."""
    X, _, P = problem
    p = {k: v.requires_grad_(True) for k, v in tp(P).items()}
    with pytest.raises(RuntimeError, match="blocked"):
        ti.make_matvec(p, t(X), method="fused")
    v = torch.ones(X.shape[0], requires_grad=True)
    with pytest.raises(RuntimeError, match="blocked"):
        ti.make_matvec(tp(P), t(X), method="fused")(v)
    out = ti.make_matvec(p, t(X), method="blocked", block=100)(v)
    out.sum().backward()
    assert torch.isfinite(p["log_lengthscale"].grad).all()
    with pytest.raises(ValueError, match="blocked"):
        ti.make_matvec(tp(P), t(X), method="xla")


def test_cg_solve_matches_jax(problem):
    """Fixed 30 iterations: x within 1e-4 relative (of max |x|); the
    tolerance loop, plain and Jacobi-preconditioned: iteration counts
    within 1; warm start x0: the same solution within 1e-4 relative."""
    X, y, P = problem
    mv_j = ji.make_matvec(P, jnp.asarray(X), block=128)
    mv_t = ti.make_matvec(tp(P), t(X))
    xj, _ = ji.cg_solve(mv_j, jnp.asarray(y), max_iters=30, fixed_iters=True)
    xt, it = ti.cg_solve(mv_t, t(y), max_iters=30, fixed_iters=True)
    assert it == 30
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-4 * np.abs(xj).max())
    xj, itj = ji.cg_solve(mv_j, jnp.asarray(y), tol=1e-5, max_iters=500)
    xt, itt = ti.cg_solve(mv_t, t(y), tol=1e-5, max_iters=500)
    assert isinstance(itt, int) and abs(itt - int(itj)) <= 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                               atol=1e-4 * np.abs(np.asarray(xj)).max())
    diag = np.linspace(0.5, 2.0, 256).astype(np.float32)
    xj, itj = ji.cg_solve(mv_j, jnp.asarray(y), tol=1e-5, max_iters=500,
                          precond_diag=jnp.asarray(diag))
    xd, itd = ti.cg_solve(mv_t, t(y), tol=1e-5, max_iters=500,
                          precond_diag=t(diag))
    assert abs(itd - int(itj)) <= 1
    np.testing.assert_allclose(xd.numpy(), np.asarray(xj),
                               atol=1e-4 * np.abs(np.asarray(xj)).max())
    x0 = xt + 0.01 * torch.sin(torch.arange(256.0))
    B = np.stack([y, np.cos(y)], 1)
    x0b = torch.stack([x0, torch.zeros_like(x0)], 1)
    sj, it0j = ji.cg_solve_program(P, jnp.asarray(X), jnp.asarray(B),
                                   block=128, tol=1e-5,
                                   x0=jnp.asarray(x0b.numpy()))
    st, it0t = ti.cg_solve_program(tp(P), t(X), t(B), tol=1e-5, x0=x0b)
    assert abs(it0t - int(it0j)) <= 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                               atol=1e-4 * np.abs(np.asarray(sj)).max())


@pytest.mark.parametrize("kind", ["rbf", COMPOSITE])
def test_preconditioner_matches_jax(problem, kind):
    """pivoted_cholesky: the same pivots (argmax |Lk[:, i]| is the pivot
    row), Lk within 1e-4 of max |Lk|; precond_factors: Lg and s2 within
    1e-4 relative. The preconditioned CG converges in fewer iterations
    than the plain one (test_iterative.py:147)."""
    X, y, P0 = problem
    P = P0 if kind == "rbf" else np_params(kind, 3, seed=15)
    Lk_j, res_j = ji.pivoted_cholesky(P, jnp.asarray(X), 16, kind=kind)
    Lk_t, res_t = ti.pivoted_cholesky(tp(P), t(X), 16, kind=kind)
    Lk_j = np.asarray(Lk_j)
    assert np.array_equal(np.abs(Lk_t.numpy()).argmax(0),
                          np.abs(Lk_j).argmax(0))
    np.testing.assert_allclose(Lk_t.numpy(), Lk_j,
                               atol=1e-4 * np.abs(Lk_j).max())
    np.testing.assert_allclose(float(res_t), float(res_j), rtol=1e-3,
                               atol=1e-4 * float(res_j) + 1e-5)
    _, Lg_j, s2_j = ji.precond_factors(P, jnp.asarray(X), 16, kind=kind)
    _, Lg_t, s2_t = ti.precond_factors(tp(P), t(X), 16, kind=kind)
    np.testing.assert_allclose(Lg_t.numpy(), np.asarray(Lg_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(Lg_j).max()))
    np.testing.assert_allclose(float(s2_t), float(s2_j), rtol=1e-6)
    if kind == "rbf":
        mv = ti.make_matvec(tp(P), t(X))
        pre = ti.make_pivoted_precond(tp(P), t(X), 16)
        _, it_plain = ti.cg_solve(mv, t(y), tol=1e-5, max_iters=500)
        _, it_pre = ti.cg_solve(mv, t(y), tol=1e-5, max_iters=500,
                                precond_apply=pre)
        assert it_pre < it_plain


def test_slq_and_lml_match_jax(problem):
    """The same probes Z (jax.random.rademacher): SLQ logdet within 1e-3
    relative (fp32 Lanczos in two summation orders), the LML within 1e-3
    per point; the port's iterative LML sits within 0.05 per point of
    its own dense LML (test_iterative.py:68)."""
    X, y, P = problem
    key = jax.random.key(3)
    Z = rademacher(key, 256, 16)
    ld_j = float(ji.slq_logdet(ji.make_matvec(P, jnp.asarray(X)), 256, key,
                               num_probes=16, num_steps=24))
    ld_t = float(ti.slq_logdet(ti.make_matvec(tp(P), t(X)), 256, Z=t(Z),
                               num_steps=24))
    assert abs(ld_t - ld_j) <= 1e-3 * abs(ld_j)
    lml_j = float(ji.lml_iterative(P, jnp.asarray(X), jnp.asarray(y),
                                   key=key, num_probes=16, num_steps=24))
    lml_t = float(ti.lml_iterative(tp(P), t(X), t(y), Z=t(Z),
                                   num_steps=24))
    assert abs(lml_t - lml_j) / 256 <= 1e-3
    dense = float(tgp.log_marginal_likelihood(tp(P), t(X), t(y)))
    assert abs(lml_t - dense) / 256 < 0.05
    z1 = ti.lanczos_tridiag(ti.make_matvec(tp(P), t(X)), t(Z[:, 0]), 8)
    zb = ti.lanczos_tridiag_batched(ti.make_matvec(tp(P), t(X)),
                                    t(Z[:, :1]), 8)
    assert torch.allclose(z1[0], zb[0][:, 0]) and z1[1].shape == (7,)


def test_posterior_iterative_matches_jax_and_dense(problem):
    """Mean and variance within 1e-4 of JAX's posterior_iterative and
    within 2e-3 of the port's dense exact_gp.posterior
    (test_iterative.py:77-78); column batches give the same answer."""
    X, y, P = problem
    Xs = inputs(40, 3, seed=16) * 2.0
    mu_j, var_j = ji.posterior_iterative(P, jnp.asarray(X), jnp.asarray(y),
                                         jnp.asarray(Xs), tol=1e-6,
                                         precond_rank=16)
    stats = {}
    mu_t, var_t = ti.posterior_iterative(tp(P), t(X), t(y), t(Xs),
                                         tol=1e-6, precond_rank=16,
                                         col_batch=16, stats=stats)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-4)
    assert stats["alpha"].shape == (256,) and len(stats["var_iters"]) == 3
    mu_d, var_d = tgp.posterior(tp(P), t(X), t(y), t(Xs))
    np.testing.assert_allclose(mu_t.numpy(), mu_d.numpy(), atol=2e-3)
    np.testing.assert_allclose(var_t.numpy(), var_d.numpy(), atol=2e-3)


@pytest.mark.parametrize("grad_method", ["ad", "analytic"])
@pytest.mark.parametrize("kind", ["rbf", "rq", "periodic"])
def test_lml_value_and_grad_iterative_matches_jax(problem, kind,
                                                  grad_method):
    """The Hutchinson gradient with the same probes z, both estimators:
    every gradient leaf within 1e-3 relative (of its max |g|), the
    quad-form value within 1e-4 relative."""
    X, y, P0 = problem
    P = P0 if kind == "rbf" else np_params(kind, 3, seed=17)
    key = jax.random.key(4)
    z = rademacher(key, 256, 8)
    v_j, g_j = ji.lml_value_and_grad_iterative(
        P, jnp.asarray(X), jnp.asarray(y), key=key, kind=kind, block=100,
        num_probes=8, grad_method=grad_method)
    v_t, g_t = ti.lml_value_and_grad_iterative(
        tp(P), t(X), t(y), z=t(z), kind=kind, block=100,
        grad_method=grad_method)
    assert abs(float(v_t) - float(v_j)) <= 1e-4 * abs(float(v_j))
    g_t = params_to_numpy(g_t)
    assert set(g_t) == set(g_j)
    for k, gj in g_j.items():
        gj = np.asarray(gj)
        np.testing.assert_allclose(g_t[k], gj,
                                   atol=1e-3 * max(np.abs(gj).max(), 1e-3))


def test_hutchinson_grads_composite_matches_jax(problem):
    """The AD sweep through the blocked composite matvec, same solves:
    every leaf of the nested gradient within 1e-3 relative."""
    X, y, _ = problem
    P = np_params(COMPOSITE, 3, seed=18)
    rng = np.random.default_rng(19)
    alpha, z = rng.standard_normal(256), rng.standard_normal((256, 4))
    w = rng.standard_normal((256, 4))
    g_j = ji.hutchinson_grads_program(
        P, jnp.asarray(X), *(jnp.asarray(a, jnp.float32)
                             for a in (alpha, w, z)),
        kind=COMPOSITE, block=100)
    g_t = ti.hutchinson_grads_program(tp(P), t(X), t(alpha), t(w), t(z),
                                      kind=COMPOSITE, block=100)
    leaves_j = jax.tree.leaves(g_j)
    leaves_t = jax.tree.leaves(params_to_numpy(g_t))
    assert len(leaves_j) == len(leaves_t)
    for gt, gj in zip(leaves_t, leaves_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt, gj,
                                   atol=1e-3 * max(np.abs(gj).max(), 1e-3))


def test_fit_iterative_matches_jax(problem):
    """Three Adam steps, frozen probes (the same z), split programs,
    rank-16 preconditioner, warm start: params within 1e-3, per-step CG
    counts within 1, the same number of preconditioner rebuilds, and the
    final LML (same probes) within 1e-3 per point."""
    X, y, _ = problem
    init = jax.tree.map(np.asarray, jk.init_params(d=3, lengthscale=0.5,
                                                   signal_var=0.5,
                                                   noise_var=0.2))
    key = jax.random.key(5)
    kw = dict(kind="rbf", steps=3, learning_rate=0.1, tol=1e-4,
              max_iters=200, num_probes=4, precond_rank=16,
              split_programs=True, probe_mode="frozen", warm_start=True,
              final_lml=True)
    p_j, info_j = jmap.fit_iterative(init, jnp.asarray(X), jnp.asarray(y),
                                     key=key, block=128, **kw)
    p_t, info_t = tmap.fit_iterative(tp(init), t(X), t(y),
                                     probes=t(rademacher(key, 256, 4)), **kw)
    p_t = params_to_numpy(p_t)
    for k, v in p_j.items():
        np.testing.assert_allclose(p_t[k], np.asarray(v), atol=1e-3)
    assert len(info_t["cg_iters"]) == 3
    assert np.abs(info_t["cg_iters"] - info_j["cg_iters"]).max() <= 1
    assert info_t["precond_rebuilds"] == info_j["precond_rebuilds"]
    np.testing.assert_allclose(info_t["loss"].numpy(),
                               np.asarray(info_j["loss"]), rtol=1e-4)
    assert abs(info_t["lml"] - info_j["lml"]) / 256 <= 1e-3


def test_fit_iterative_fused_fresh_path(problem):
    """The fused (non-split) path with fresh probes and the analytic
    estimator runs on the CPU, moves the lengthscale toward the data
    and keeps every iterate inside the box."""
    X, y, _ = problem
    init = tp(jax.tree.map(np.asarray, jk.init_params(d=3, lengthscale=0.3,
                                                      noise_var=0.2)))
    seen = []
    p, info = tmap.fit_iterative(
        init, t(X), t(y), steps=3, learning_rate=0.1, num_probes=4,
        precond_rank=8, precond_refresh=2, grad_method="analytic",
        generator=torch.Generator().manual_seed(1),
        callback=lambda step, params, value, grads: seen.append(step))
    assert seen == [0, 1, 2] and len(info["cg_iters"]) == 0
    assert np.isnan(info["lml"]) and info["precond_rebuilds"] == 2
    assert (p["log_lengthscale"] > init["log_lengthscale"]).all()
    assert torch.isfinite(info["loss"]).all()


def test_gp_iterative_entry_points_match_jax(problem):
    """GP.fit_iterative / predict_iterative /
    log_marginal_likelihood_iterative on device="cpu" against
    cugp_tpu.GP's at the same params and probes: posterior within 1e-4,
    LML within 1e-3 per point, fitted params within 1e-3."""
    X, y, P = problem
    Xs = inputs(32, 3, seed=20) * 2.0
    gp_j = cugp_tpu.GP(kind="rbf").condition(X, y, params=P)
    gp_t = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(
        X, y, params=P)
    mu_j, var_j = gp_j.predict_iterative(Xs, tol=1e-6)
    mu_t, var_t = gp_t.predict_iterative(Xs, tol=1e-6, col_batch=10)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-4)
    Z = rademacher(jax.random.key(0), 256, 16)
    lml_j = float(gp_j.log_marginal_likelihood_iterative())
    lml_t = float(gp_t.log_marginal_likelihood_iterative(probes=t(Z)))
    assert abs(lml_t - lml_j) / 256 <= 1e-3
    key = jax.random.key(6)
    kw = dict(steps=2, learning_rate=0.05, num_probes=4, precond_rank=8,
              split_programs=True, probe_mode="frozen")
    gp_j.fit_iterative(X, y, init=P, key=key, **kw)
    gp_t.fit_iterative(X, y, init=P, probes=t(rademacher(key, 256, 4)),
                       **kw)
    p_t = params_to_numpy(gp_t.params)
    for k, v in gp_j.params.items():
        np.testing.assert_allclose(p_t[k], np.asarray(v), atol=1e-3)
    pre = gp_t._iterative_precond(8, gp_t.params)
    assert gp_t._iterative_precond(8, gp_t.params) is pre  # cached


def test_precond_cache_keyed_on_the_callers_dict(problem, monkeypatch):
    """log_marginal_likelihood_iterative with the same params dict three
    times builds the rank-8 preconditioner once, as the JAX GP does
    (cugp_tpu/api.py:351-355); the LML equals that of a fresh factor on
    every call within 1e-6, and another dict rebuilds the factor."""
    X, y, P = problem
    gp = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(X, y)
    real, builds = ti.precond_factors, []

    def counted(*args, **kw):
        builds.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ti, "precond_factors", counted)
    Z = t(rademacher(jax.random.key(1), 256, 8))
    lmls = [float(gp.log_marginal_likelihood_iterative(P, probes=Z,
                                                       precond_rank=8))
            for _ in range(3)]
    assert len(builds) == 1
    p = gp._params(P)
    want = float(ti.lml_iterative(p, gp.X, gp.y, Z=t(np.asarray(Z)),
                                  jitter=gp.jitter,
                                  precond=real(p, gp.X, 8)))
    assert max(abs(v - want) for v in lmls) <= 1e-6
    gp.log_marginal_likelihood_iterative(dict(P), probes=Z, precond_rank=8)
    assert len(builds) == 2


def test_unported_arguments_raise(problem):
    """The tunnel workarounds and the modules not ported yet raise
    NotImplementedError naming their ROADMAP items."""
    X, y, P = problem
    gp = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(X, y,
                                                               params=P)
    with pytest.raises(NotImplementedError, match="item 12"):
        gp.predict_iterative(X[:4], segment_iters=16)
    with pytest.raises(NotImplementedError, match="item 12"):
        gp.log_marginal_likelihood_iterative(segment_iters=16)
    with pytest.raises(NotImplementedError, match="item 12"):
        gp.fit_iterative(X, y, steps=1, precond_where="host")
    with pytest.raises(NotImplementedError, match="item 16"):
        gp.fit_iterative(X, y, steps=1, checkpoint_dir="ckpt")


def test_gp_defaults_to_the_card():
    """GP runs on "cuda" unless the caller asks for the CPU."""
    assert cugp_tpu_torch.GP(kind="rbf").device.type == "cuda"
    assert cugp_tpu_torch.GP(kind="rbf", device="cpu").device.type == "cpu"


def test_gp_without_cuda_fails_when_data_is_placed(problem):
    """With no CUDA device, a GP left on its default device raises from
    torch when data is placed: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default GP would run")
    X, y, _ = problem
    with pytest.raises((RuntimeError, AssertionError)):
        cugp_tpu_torch.GP(kind="rbf").condition(X, y)


def test_iterative_never_imports_jax():
    """The matrix-free modules import with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['cugp_tpu'] = None; "
            "import cugp_tpu_torch.inference.iterative, "
            "cugp_tpu_torch.inference.map_opt, "
            "cugp_tpu_torch.ops.cov_matvec_cuda, cugp_tpu_torch.api")
    subprocess.run([sys.executable, "-c", code], check=True)
