"""The port's LMC multi-output family against the JAX package (CPU): the
ICM model (LML, gradient, posterior with and without the full output
covariance, the B = I reduction, short fits), the rank-Q model (dense
LML, gradient and posterior, the joint covariance, the matrix-free
operator on both matvec routes, the iterative LML with JAX's probes and
the iterative posterior), the float64 oracle's copy, and the facades
(MultiOutputGP, MultiOutputGPQ) with save/load across the packages.

The JAX side runs as its own tests run it here: XLA's Cholesky, solves
and blocked matvec on the CPU, where the port runs its own recursions
over the kernels' plain versions. Tolerances are stated at each check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.inference import iterative as jiterative
from cugp_tpu.models import exact_gp as jexact
from cugp_tpu.models import lmc as jlmc
from cugp_tpu.oracle import lmc_np as jlmc_np

import cugp_tpu_torch
from cugp_tpu_torch.models import exact_gp, lmc
from cugp_tpu_torch.oracle import lmc_np
from cugp_tpu_torch.utils.params import (params_from_numpy, params_to_numpy,
                                         sorted_leaves, unflatten_sorted)
from tests.test_lmc import _toy

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def rel_to_max(got, want):
    """max |got - want| over max |want| (the gradient bars' scale)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def port_grad(fn, params):
    """fn's value and its gradient tree at the port's params."""
    tr = jax.tree.map(lambda v: v.detach().clone().requires_grad_(True),
                      params)
    val = fn(tr)
    val.backward()
    return float(val.detach()), jax.tree.map(lambda v: v.grad, tr)


def cell(p_np, *arrays):
    """(the JAX params, the port's params, the arrays in float32)."""
    return (jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, "cpu"),
            [np.asarray(a, np.float32) for a in arrays])


@pytest.fixture(scope="module")
def icm():
    """tests/test_lmc.py's _toy cell: n=64, d=2, p=3 outputs drawn from
    the model's own prior, rank q=2, 16 test points."""
    params, X, Y, Xs = _toy()
    pj, pt, (X, Y, Xs) = cell(jax.tree.map(
        lambda v: np.asarray(v, np.float32), params), X, Y, Xs)
    return dict(pj=pj, pt=pt, X=X, Y=Y, Xs=Xs,
                p_np=params_to_numpy(pt))


@pytest.fixture(scope="module")
def lmcq():
    """tests/test_lmc.py's test_lmcq_matches_dense_kron_oracle cell:
    n=48, d=1, a periodic and an rbf latent mixing into p=2 outputs."""
    kinds = ("periodic", "rbf")
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, size=(48, 1))
    Y = rng.standard_normal((48, 2))
    Xs = rng.uniform(-2, 2, size=(12, 1))
    p_np = jax.tree.map(np.asarray, jlmc.init_lmcq_params(
        d=1, p=2, kinds=kinds, noise_var=0.05, seed=1))
    pj, pt, (X, Y, Xs) = cell(p_np, X, Y, Xs)
    return dict(kinds=kinds, pj=pj, pt=pt, p_np=p_np, X=X, Y=Y, Xs=Xs)


@pytest.fixture(scope="module")
def lmcq_iter():
    """tests/test_lmc.py's test_lmcq_iterative_matches_dense cell cut to
    n=120: d=2, p=3 outputs, an rbf and a matern32 latent."""
    kinds = ("rbf", "matern32")
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (120, 2))
    Xs = rng.uniform(-2, 2, (24, 2))
    Y = rng.standard_normal((120, 3))
    p_np = jax.tree.map(np.asarray, jlmc.init_lmcq_params(
        2, 3, kinds, noise_var=0.05, seed=1))
    pj, pt, (X, Y, Xs) = cell(p_np, X, Y, Xs)
    return dict(kinds=kinds, pj=pj, pt=pt, p_np=p_np, X=X, Y=Y, Xs=Xs)


# ---- ICM ----


def test_icm_lml_and_gradient_match_jax(icm):
    """LML within 1e-5 relative; the gradient in every leaf within 1e-4
    of that leaf's largest component."""
    X, Y = icm["X"], icm["Y"]
    want, gj = jax.value_and_grad(jlmc.log_marginal_likelihood_lmc)(
        icm["pj"], jnp.asarray(X), jnp.asarray(Y))
    got, gt = port_grad(
        lambda p: lmc.log_marginal_likelihood_lmc(p, t(X), t(Y)), icm["pt"])
    assert rel(got, want) <= 1e-5
    for k in gj:
        assert rel_to_max(gt[k], gj[k]) <= 1e-4, k


@pytest.mark.parametrize("full_output_cov", [False, True])
@pytest.mark.parametrize("include_noise", [False, True])
def test_icm_posterior_matches_jax_and_float64(icm, full_output_cov,
                                               include_noise):
    """Mean and (full or diagonal) output covariance within 1e-5 abs of
    JAX's, and within tests/test_lmc.py's 1e-3 of the float64 oracle."""
    X, Y, Xs = icm["X"], icm["Y"], icm["Xs"]
    kw = dict(full_output_cov=full_output_cov, include_noise=include_noise)
    mj, cj = jlmc.posterior_lmc(icm["pj"], jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(Xs), **kw)
    mt, ct = lmc.posterior_lmc(icm["pt"], t(X), t(Y), t(Xs), **kw)
    close(mt, mj, atol=1e-5)
    close(ct, cj, atol=1e-5)
    m64, c64 = lmc_np.posterior(icm["p_np"], X, Y, Xs,
                                include_noise=include_noise)
    if not full_output_cov:
        c64 = np.diagonal(c64, axis1=1, axis2=2)
    close(mt, m64, atol=1e-3)
    close(ct, c64, atol=1e-3)


def test_icm_independent_outputs_reduce_to_shared_kernel_multi(icm):
    """B = I (A = 0, softplus(raw_d) = 1): the ICM LML is the shared-
    kernel multi-output LML (1e-5 relative), a value only (eigh's
    backward is not finite at tied eigenvalues), and JAX's (1e-5)."""
    p_np = dict(icm["p_np"])
    p_np["lmc_A"] = np.zeros_like(p_np["lmc_A"])
    p_np["lmc_raw_d"] = np.full_like(p_np["lmc_raw_d"],
                                     np.log(np.expm1(1.0 - 1e-6)))
    pt = params_from_numpy(p_np, "cpu")
    X, Y = t(icm["X"]), t(icm["Y"])
    got = float(lmc.log_marginal_likelihood_lmc(pt, X, Y))
    assert rel(got, exact_gp.log_marginal_likelihood_multi(pt, X, Y)) <= 1e-5
    want = jlmc.log_marginal_likelihood_lmc(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(icm["X"]),
        jnp.asarray(icm["Y"]))
    assert rel(got, want) <= 1e-5
    assert rel(want, jexact.log_marginal_likelihood_multi(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(icm["X"]),
        jnp.asarray(icm["Y"]))) <= 1e-5


def test_icm_fit_matches_jax(icm):
    """5 Adam steps from the same init: losses within 1e-4 relative and
    every parameter within 1e-4."""
    X, Y = icm["X"], icm["Y"]
    pj, ij = jlmc.fit(icm["pj"], jnp.asarray(X), jnp.asarray(Y), steps=5,
                      learning_rate=0.05)
    pt, it = lmc.fit(icm["pt"], t(X), t(Y), steps=5, learning_rate=0.05)
    close(it["loss"], ij["loss"], rtol=1e-4)
    for k in pj:
        close(pt[k], pj[k], atol=1e-4)


def test_oracle_copy_equals_the_jax_packages(icm, lmcq):
    """The port's lmc_np gives the JAX package's numbers bit for bit."""
    X, Y, Xs = icm["X"], icm["Y"], icm["Xs"]
    assert (lmc_np.log_marginal_likelihood(icm["p_np"], X, Y)
            == jlmc_np.log_marginal_likelihood(icm["p_np"], X, Y))
    for a, b in zip(lmc_np.posterior(icm["p_np"], X, Y, Xs),
                    jlmc_np.posterior(icm["p_np"], X, Y, Xs)):
        np.testing.assert_array_equal(a, b)
    k, p_np = lmcq["kinds"], lmcq["p_np"]
    X, Y, Xs = lmcq["X"], lmcq["Y"], lmcq["Xs"]
    assert (lmc_np.log_marginal_likelihood_q(p_np, X, Y, k)
            == jlmc_np.log_marginal_likelihood_q(p_np, X, Y, k))
    for a, b in zip(lmc_np.posterior_q(p_np, X, Y, Xs, k),
                    jlmc_np.posterior_q(p_np, X, Y, Xs, k)):
        np.testing.assert_array_equal(a, b)


# ---- rank-Q, dense ----


def test_lmcq_dense_matches_jax_and_float64(lmcq):
    """LML within 1e-5 relative of JAX's, posterior mean and variance
    within 2e-4 abs of JAX's (the periodic latent's conditioning: the
    means are 7.6e-5 apart, the port's 4.2e-5 and JAX's 5.6e-5 off
    float64; ROADMAP.md section 3); against the float64 oracle at
    tests/test_lmc.py's bars (1e-3 relative, 1e-3 abs)."""
    k, X, Y, Xs = lmcq["kinds"], lmcq["X"], lmcq["Y"], lmcq["Xs"]
    got = float(lmc.log_marginal_likelihood_lmcq(lmcq["pt"], t(X), t(Y), k))
    assert rel(got, jlmc.log_marginal_likelihood_lmcq(
        lmcq["pj"], jnp.asarray(X), jnp.asarray(Y), k)) <= 1e-5
    assert rel(got, lmc_np.log_marginal_likelihood_q(
        lmcq["p_np"], X, Y, k)) <= 1e-3
    mt, vt = lmc.posterior_lmcq(lmcq["pt"], t(X), t(Y), t(Xs), k)
    mj, vj = jlmc.posterior_lmcq(lmcq["pj"], jnp.asarray(X), jnp.asarray(Y),
                                 jnp.asarray(Xs), k)
    close(mt, mj, atol=2e-4)
    close(vt, vj, atol=2e-4)
    m64, v64 = lmc_np.posterior_q(lmcq["p_np"], X, Y, Xs, k)
    close(mt, m64, atol=1e-3)
    close(vt, v64, atol=1e-3)


def _fd_grad64(f, p_np, h=1e-6):
    """Central differences of a float64 function of the params tree, one
    array a leaf in sorted_leaves' order."""
    leaves = [np.asarray(v, np.float64) for v in sorted_leaves(p_np)]
    out = []
    for i, leaf in enumerate(leaves):
        g = np.zeros(leaf.shape)
        for idx in np.ndindex(leaf.shape):
            vals = []
            for step in (h, -h):
                moved = [v.copy() for v in leaves]
                moved[i][idx] += step
                vals.append(f(unflatten_sorted(p_np, moved)))
            g[idx] = (vals[0] - vals[1]) / (2 * h)
        out.append(g)
    return out


def test_lmcq_gradient_matches_jax_and_float64(lmcq):
    """The dense rank-Q LML's gradient through the nested latents: every
    leaf within 1e-4 of the gradient's largest component of JAX's, and
    within 1e-3 of its own largest component of float64 central
    differences of the oracle. (Against JAX leaf by leaf the periodic
    latent's lengthscale, 2.2 beside a largest component of 887, reads
    5.4e-4 of itself: fp32 rounding, ROADMAP.md section 3.)"""
    k, X, Y = lmcq["kinds"], lmcq["X"], lmcq["Y"]
    _, gj = jax.value_and_grad(jlmc.log_marginal_likelihood_lmcq)(
        lmcq["pj"], jnp.asarray(X), jnp.asarray(Y), k)
    _, gt = port_grad(lambda p: lmc.log_marginal_likelihood_lmcq(
        p, t(X), t(Y), k), lmcq["pt"])
    gt, gj = sorted_leaves(gt), sorted_leaves(gj)
    largest = max(float(np.max(np.abs(b))) for b in gj)
    for a, b in zip(gt, gj):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1e-4 * largest
    g64 = _fd_grad64(lambda p: lmc_np.log_marginal_likelihood_q(
        p, X, Y, k), lmcq["p_np"])
    for a, b in zip(gt, g64):
        assert rel_to_max(a, b) <= 1e-3


@pytest.mark.parametrize("square", [True, False])
def test_lmcq_covariance_matches_jax(lmcq, square):
    """The joint (pn1, pn2) covariance built block by block equals JAX's
    einsum within 1e-6 abs."""
    X = lmcq["X"]
    X2 = X if square else lmcq["Xs"]
    got = lmc.lmcq_covariance(lmcq["pt"], t(X), t(X) if square else t(X2),
                              lmcq["kinds"])
    want = jlmc.lmcq_covariance(lmcq["pj"], jnp.asarray(X), jnp.asarray(X2),
                                lmcq["kinds"])
    close(got, want, atol=1e-6)


def test_lmcq_fit_matches_jax(lmcq):
    """3 Adam steps of fit_lmcq from the same init: losses within 1e-4
    relative, every leaf within 1e-4."""
    k, X, Y = lmcq["kinds"], lmcq["X"], lmcq["Y"]
    pj, ij = jlmc.fit_lmcq(lmcq["pj"], jnp.asarray(X), jnp.asarray(Y),
                           kinds=k, steps=3)
    pt, it = lmc.fit_lmcq(lmcq["pt"], t(X), t(Y), kinds=k, steps=3)
    close(it["loss"], ij["loss"], rtol=1e-4)
    for a, b in zip(sorted_leaves(pt), sorted_leaves(pj)):
        close(a, b, atol=1e-4)


# ---- rank-Q, matrix-free ----


@pytest.mark.parametrize("kinds", [
    pytest.param(("rbf", "rq"), id="fused"),
    pytest.param(("rbf", "rq+periodic"), id="blocked")])
def test_lmcq_matvec_matches_dense_operator(kinds):
    """make_lmcq_matvec == the dense joint operator in float64
    (tests/test_lmc.py's cell and bars: 2e-4 rel and abs): base latents
    only (every latent on the fused route), and with a composite latent
    (which takes the blocked route)."""
    rng = np.random.default_rng(4)
    n, d, p = 96, 2, 2
    X = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    p_np = jax.tree.map(np.asarray, jlmc.init_lmcq_params(
        d, p, kinds, noise_var=0.07, seed=2))
    S = np.asarray(jlmc.lmcq_covariance(jax.tree.map(jnp.asarray, p_np),
                                        jnp.asarray(X), jnp.asarray(X),
                                        kinds), np.float64)
    sn2 = float(np.exp(p_np["log_noise_var"]))
    S += (sn2 + 1e-6 * float(np.max(np.sum(p_np["lmc_a"] ** 2, axis=0)))
          ) * np.eye(p * n)
    v = rng.standard_normal((p * n, 3)).astype(np.float32)
    mv = lmc.make_lmcq_matvec(params_from_numpy(p_np, "cpu"), t(X), kinds,
                              block=64)
    close(mv(t(v)), S @ v, rtol=2e-4, atol=2e-4)
    close(mv(t(v[:, 0])), S @ v[:, 0], rtol=2e-4, atol=2e-4)


def test_lmcq_matvec_fused_route_has_no_gradient(lmcq):
    """Asked for a gradient, the fused route raises (the matvec kernel
    has no backward); the latents' -60 log-noise never enters the
    params the fit clamps."""
    pt = jax.tree.map(lambda v: v.clone().requires_grad_(True), lmcq["pt"])
    with pytest.raises(RuntimeError, match="no backward"):
        lmc.make_lmcq_matvec(pt, t(lmcq["X"]), lmcq["kinds"])
    lmc.make_lmcq_matvec(lmcq["pt"], t(lmcq["X"]), lmcq["kinds"])
    assert all("log_noise_var" not in fp for fp in lmcq["pt"]["latents"])


def _slq64(S, Z, num_steps):
    """Stochastic Lanczos quadrature of log det S in float64 (no
    reorthogonalization, as iterative.slq_logdet) from the probes Z."""
    est = []
    for z in np.asarray(Z, np.float64).T:
        q, q_prev, b_prev, alphas, betas = z / np.linalg.norm(z), 0.0, 0.0, \
            [], []
        for _ in range(num_steps):
            v = S @ q - b_prev * q_prev
            alphas.append(q @ v)
            v = v - alphas[-1] * q
            betas.append(np.linalg.norm(v))
            q_prev, q, b_prev = q, v / betas[-1], betas[-1]
        T = (np.diag(alphas) + np.diag(betas[:-1], 1)
             + np.diag(betas[:-1], -1))
        w, V = np.linalg.eigh(T)
        est.append(S.shape[0] * np.sum(V[0] ** 2 * np.log(w)))
    return float(np.mean(est))


def test_lmcq_iterative_lml_with_jax_probes(lmcq_iter):
    """CG + SLQ on the joint operator fed JAX's own key(0) probes: within
    5e-4 relative of JAX's estimate and 1e-3 of the same estimator in
    float64 (fp32 Lanczos without reorthogonalization: JAX's estimate is
    6.1e-4 off the float64 one here, the port's 7.1e-4, the two 1.0e-4
    apart; ROADMAP.md section 3)."""
    c = lmcq_iter
    X, Y, k = c["X"], c["Y"], c["kinds"]
    kw = dict(block=64, tol=1e-6, num_probes=16, num_steps=24)
    want = jlmc.log_marginal_likelihood_lmcq_iterative(
        c["pj"], jnp.asarray(X), jnp.asarray(Y), k, key=jax.random.key(0),
        **kw)
    Z = np.asarray(jax.random.rademacher(jax.random.key(0),
                                         (Y.size, 16), dtype=jnp.float32))
    got = lmc.log_marginal_likelihood_lmcq_iterative(
        c["pt"], t(X), t(Y), k, Z=t(Z), **kw)
    assert rel(got, want) <= 5e-4
    p64 = jax.tree.map(lambda v: np.asarray(v, np.float64), c["p_np"])
    S = lmc_np._joint_cov_q(p64, X, X, k) + (
        np.exp(p64["log_noise_var"])
        + 1e-6 * np.max(np.sum(p64["lmc_a"] ** 2, axis=0))) * np.eye(Y.size)
    yv = Y.T.reshape(-1).astype(np.float64)
    lml64 = (-0.5 * yv @ np.linalg.solve(S, yv) - 0.5 * _slq64(S, Z, 24)
             - 0.5 * Y.size * np.log(2 * np.pi))
    assert rel(got, lml64) <= 1e-3


def test_lmcq_posterior_iterative_matches_jax(lmcq_iter):
    """CG to tol 1e-7 over 3 column chunks: mean and variance within
    BASELINE's 1e-3 abs of JAX's, of the float64 oracle and of the port's
    dense posterior (each fp32 path is ~1.7e-4 off float64 in the mean
    here, conditioning); the stats hold the mean solve and every chunk's
    CG count."""
    c = lmcq_iter
    X, Y, Xs, k = c["X"], c["Y"], c["Xs"], c["kinds"]
    mj, vj = jlmc.posterior_lmcq_iterative(
        c["pj"], jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs), k,
        block=64, tol=1e-7, col_batch=10, include_noise=True)
    stats = {}
    mt, vt = lmc.posterior_lmcq_iterative(
        c["pt"], t(X), t(Y), t(Xs), k, block=64, tol=1e-7, col_batch=10,
        include_noise=True, stats=stats)
    m64, v64 = lmc_np.posterior_q(c["p_np"], X, Y, Xs, k,
                                  include_noise=True)
    md, vd = lmc.posterior_lmcq(c["pt"], t(X), t(Y), t(Xs), k,
                                include_noise=True)
    for want_m, want_v in ((mj, vj), (m64, v64), (md, vd)):
        close(mt, want_m, atol=1e-3)
        close(vt, want_v, atol=1e-3)
    assert stats["alpha"].shape == (Y.size,)
    assert len(stats["var_iters"]) == 3 and stats["mean_iters"] > 0


@pytest.fixture(scope="module")
def lmcq_bench():
    """benchmarks/bench_lmcq.py's configuration at 256 rows
    (make_data(d=2, p=2, seed=0), rbf + matern32 latents at
    lengthscale 1.2, noise 0.05; the port's seed-0 init), the JAX
    package's CG count on its mean solve at tol 1e-4, and the float64
    joint operator."""
    from benchmarks.bench_lmcq import make_data

    kinds = ("rbf", "matern32")
    X, Y = make_data(256, 2, 2, seed=0)
    pt = lmc.init_lmcq_params(d=2, p=2, kinds=kinds, lengthscale=1.2,
                              noise_var=0.05, seed=0)
    p_np = params_to_numpy(pt)
    yv = Y.T.reshape(-1)
    mv = jlmc.make_lmcq_matvec(jax.tree.map(jnp.asarray, p_np),
                               jnp.asarray(X), kinds)
    aj, itj = jax.jit(lambda b: jiterative.cg_solve(
        mv, b, tol=1e-4, max_iters=3000))(jnp.asarray(yv))
    S = lmc_np._joint_cov_q(p_np, np.float64(X), np.float64(X), kinds)
    S[np.diag_indices_from(S)] += (
        np.exp(np.float64(p_np["log_noise_var"]))
        + 1e-6 * np.max(np.sum(np.float64(p_np["lmc_a"]) ** 2, axis=0)))
    return dict(kinds=kinds, X=X, yv=yv, pt=pt, S=S, jax_iters=int(itj),
                jax_alpha=np.asarray(aj))


def _true_rel_residual(S, x, b):
    return float(np.linalg.norm(b - S @ np.float64(x)) / np.linalg.norm(b))


@pytest.mark.parametrize("route", ["fused", "blocked"])
def test_lmcq_cg_iterations_match_jax(lmcq_bench, route, monkeypatch):
    """CG's count on the rank-Q joint operator is the operator's, not the
    port's: at bench_lmcq's configuration (256 rows, tol 1e-4, no
    preconditioner) the port's mean solve takes JAX's count of iterations
    within 10% (fp32 CG's recursive residual crosses tol within a few
    iterations of the other's), on either matvec route (the blocked one
    forced here; on the CPU both run the same tiles), and both solutions'
    relative residuals, recomputed on the float64 operator, are within
    10 tol (phase 5's certificate). Prints both; tools/lmcq_cg.py --jax
    compares them at larger n."""
    c = lmcq_bench
    if route == "blocked":
        monkeypatch.setattr(lmc.iterative, "make_matvec", functools.partial(
            lmc.iterative.make_matvec, method="blocked"))
    mv = lmc.make_lmcq_matvec(c["pt"], t(c["X"]), c["kinds"])
    with torch.no_grad():
        x, it = lmc.iterative.cg_solve(mv, t(c["yv"]), tol=1e-4,
                                       max_iters=3000)
    res_t = _true_rel_residual(c["S"], x.numpy(), c["yv"])
    res_j = _true_rel_residual(c["S"], c["jax_alpha"], c["yv"])
    print(f"[lmcq_cg] n={len(c['X'])} tol=1e-4 {route}: port {it} iterations, "
          f"residual {res_t:.3e}; jax {c['jax_iters']} iterations, "
          f"residual {res_j:.3e}")
    assert abs(it - c["jax_iters"]) <= 0.1 * c["jax_iters"]
    assert res_t <= 1e-3 and res_j <= 1e-3


# ---- facades, params, init ----


def _same_state(a, b):
    """Two facades (either package) hold the same params, X and Y, bit
    for bit."""
    for x, y in zip(sorted_leaves([a.params, a.X, a.Y]),
                    sorted_leaves([b.params, b.X, b.Y])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_multioutput_gp_facade_matches_jax_and_saves_across(tmp_path):
    """MultiOutputGP on test_lmc.py's facade data from JAX's init: 5 fit
    steps (losses 1e-4 relative), predict, LML and output correlation
    within 1e-4; a port-saved model loads in the JAX package and a
    JAX-saved one in the port, params and data bit for bit, and the
    loaded port model predicts as the JAX one (1e-4)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (80, 1))
    base = np.sin(2 * X[:, 0])
    Y = np.stack([base, 0.7 * base], 1) + 0.05 * rng.standard_normal((80, 2))
    init = jax.tree.map(np.asarray, jlmc.init_lmc_params(d=1, p=2, q=1))
    m_j, m_t = cugp_tpu.MultiOutputGP(), cugp_tpu_torch.MultiOutputGP(
        device="cpu")
    ij = m_j.fit(X, Y, steps=5, init=jax.tree.map(jnp.asarray, init))
    it = m_t.fit(X, Y, steps=5, init=init)
    close(it["loss"], ij["loss"], rtol=1e-4)
    for full in (False, True):
        for a, b in zip(m_t.predict(X[:10], full_output_cov=full),
                        m_j.predict(X[:10], full_output_cov=full)):
            close(a, b, atol=1e-4)
    assert rel(m_t.log_marginal_likelihood(),
               m_j.log_marginal_likelihood()) <= 1e-5
    close(m_t.output_correlation(), m_j.output_correlation(), atol=1e-4)
    m_t.save(str(tmp_path / "port"))
    back = cugp_tpu.MultiOutputGP.load(str(tmp_path / "port"))
    assert back.rank == 1 and back.method == "auto"
    m_j.save(str(tmp_path / "jax"))
    m_x = cugp_tpu_torch.MultiOutputGP.load(str(tmp_path / "jax"),
                                            device="cpu")
    assert m_x.device == torch.device("cpu")
    _same_state(back, m_t)
    _same_state(m_x, m_j)
    for a, b in zip(m_x.predict(X[:10]), m_j.predict(X[:10])):
        close(a, b, atol=1e-4)


def test_multioutput_gpq_facade_matches_jax_and_saves_across(tmp_path):
    """MultiOutputGPQ (rbf + matern32) from JAX's init: 3 fit steps
    (losses 1e-4 relative), the dense predict and LML against JAX's,
    predict_iterative against predict (tests/test_lmc.py's 1e-3) and the
    iterative LML with JAX's probes against JAX's (1e-4); save/load both
    ways, params and data bit for bit, and the loaded port model
    predicts as the JAX one (1e-4)."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (60, 2))
    Y = rng.standard_normal((60, 2))
    kinds = ("rbf", "matern32")
    init = jax.tree.map(np.asarray, jlmc.init_lmcq_params(2, 2, kinds))
    m_j = cugp_tpu.MultiOutputGPQ(kinds=kinds)
    m_t = cugp_tpu_torch.MultiOutputGPQ(kinds=kinds, device="cpu")
    ij = m_j.fit(X, Y, steps=3, learning_rate=0.1,
                 init=jax.tree.map(jnp.asarray, init))
    it = m_t.fit(X, Y, steps=3, learning_rate=0.1, init=init)
    close(it["loss"], ij["loss"], rtol=1e-4)
    mu, var = m_t.predict(X[:8])
    for a, b in zip((mu, var), m_j.predict(X[:8])):
        close(a, b, atol=1e-4)
    assert rel(m_t.log_marginal_likelihood(),
               m_j.log_marginal_likelihood()) <= 1e-5
    for a, b in zip(m_t.predict_iterative(X[:8], tol=1e-7, block=64),
                    (mu, var)):
        close(a, b, atol=1e-3)
    Z = np.asarray(jax.random.rademacher(jax.random.key(0), (120, 16),
                                         dtype=jnp.float32))
    got = m_t.log_marginal_likelihood_iterative(block=64, probes=Z)
    assert rel(got, m_j.log_marginal_likelihood_iterative(block=64)) <= 1e-4
    m_t.save(str(tmp_path / "port"))
    back = cugp_tpu.MultiOutputGPQ.load(str(tmp_path / "port"))
    assert back.kinds == kinds
    m_j.save(str(tmp_path / "jax"))
    m_x = cugp_tpu_torch.MultiOutputGPQ.load(str(tmp_path / "jax"),
                                             device="cpu")
    _same_state(back, m_t)
    _same_state(m_x, m_j)
    for a, b in zip(m_x.predict(X[:8]), m_j.predict(X[:8])):
        close(a, b, atol=1e-4)


@pytest.mark.parametrize("facade", ["MultiOutputGP", "MultiOutputGPQ"])
def test_facades_refuse_1d_y_and_default_to_cuda(facade):
    """A 1-D Y raises JAX's ValueError and message; the device is "cuda"
    unless the caller asks for the CPU; predict before fit raises."""
    assert getattr(cugp_tpu_torch, facade)().device == torch.device("cuda")
    m = getattr(cugp_tpu_torch, facade)(device="cpu")
    X = np.zeros((5, 1))
    with pytest.raises(ValueError, match=r"Y must be \(n, p\); got \(5,\)"):
        m.fit(X, np.zeros(5))
    with pytest.raises(RuntimeError, match="first"):
        m.predict(X)


@pytest.mark.parametrize("model", ["lmc", "lmcq"])
def test_params_from_numpy_carries_lmc_trees(model):
    """JAX's lmc / lmcq params (the latents a list of dicts) cross to the
    port and back leaf for leaf, in jax's tree order."""
    if model == "lmc":
        tree = jlmc.init_lmc_params(d=3, p=4, q=2, seed=5)
    else:
        tree = jlmc.init_lmcq_params(3, 2, ("periodic", "rq", "rbf"),
                                     seed=5)
    p_np = jax.tree.map(np.asarray, tree)
    back = params_to_numpy(params_from_numpy(p_np, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(sorted_leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_init_matches_jax_structure_and_draws_on_the_cpu():
    """init_lmc_params / init_lmcq_params: JAX's tree, shapes, dtypes and
    deterministic leaves; the mixing draws come from a CPU generator
    seeded `seed` (other numbers than jax.random's: a logged divergence)."""
    pairs = [(lmc.init_lmc_params(d=2, p=3, q=2, seed=4),
              jlmc.init_lmc_params(d=2, p=3, q=2, seed=4), "lmc_A"),
             (lmc.init_lmcq_params(2, 3, ("periodic", "rbf"), seed=4),
              jlmc.init_lmcq_params(2, 3, ("periodic", "rbf"), seed=4),
              "lmc_a")]
    for got, want, mix in pairs:
        got = params_to_numpy(got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for k in want:
            if k != mix:
                for a, b in zip(sorted_leaves(got[k]),
                                jax.tree.leaves(want[k])):
                    np.testing.assert_array_equal(a, np.asarray(b))
        assert got[mix].shape == want[mix].shape
    g = torch.Generator().manual_seed(4)
    np.testing.assert_array_equal(
        params_to_numpy(lmc.init_lmc_params(d=2, p=3, q=2, seed=4))["lmc_A"],
        (0.5 * torch.randn((3, 2), generator=g)).numpy())
