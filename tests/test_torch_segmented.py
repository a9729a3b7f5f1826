"""The port's segmented schedule and host-built preconditioner against
the JAX package (CPU).

The segmented CG/SLQ/LML/posterior (``iterative.cg_solve_segmented``,
``slq_logdet_segmented``, ``lml_iterative_segmented``,
``posterior_iterative_segmented``), ``precond_factors_host``,
``fit_iterative(segment_iters=, precond_where="host")``, the GP and
MultiOutputGPQ entry points' ``segment_iters``, the CLI's
``--fit.segment_iters`` and the fetch-barrier timers of
``utils/profiling``, each fed the same float32 inputs as its JAX twin
(JAX's Rademacher probes passed as ``Z``) and held at the JAX test's bar
(tests/inference/test_iterative.py, test_fit_iterative.py,
tests/test_lmc.py); plus the schedule's bitwise claims: segments
compose, the segmented solve is the fixed-iteration solve, and the
segmented SLQ estimate (slq_logdet itself) is the one-call estimate on
the same probes. The
JAX side runs as its own tests run it here (XLA on the CPU); the port
runs the kernels' plain versions.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.api import GP as JGP
from cugp_tpu.cli.__main__ import main as jax_main
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.inference import iterative as ji
from cugp_tpu.inference import map_opt as jmap
from cugp_tpu.models import lmc as jlmc
from cugp_tpu.ops import kernels as jk

import cugp_tpu_torch
from cugp_tpu_torch.cli.__main__ import main as torch_main
from cugp_tpu_torch.inference import iterative as ti
from cugp_tpu_torch.inference import map_opt as tmap
from cugp_tpu_torch.models import lmc
from cugp_tpu_torch.utils import profiling
from cugp_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from tests.test_torch_cli import flat, keyset, run

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def tp(P):
    return params_from_numpy(jax.tree.map(np.asarray, P), "cpu")


def close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **kw)


def rademacher(key, n, p):
    return np.asarray(jax.random.rademacher(key, (n, p), dtype=jnp.float32))


@pytest.fixture(scope="module")
def setup():
    """test_iterative.py's problem at n=256: sinusoid_1d, rbf,
    lengthscale 0.8, noise 0.05; the port's device preconditioner."""
    X, y, _ = jsyn.sinusoid_1d(n=256, noise_std=0.2, seed=0)
    X, y = X.astype(np.float32), y.astype(np.float32)
    P = jk.init_params(d=1, lengthscale=0.8, noise_var=0.05)
    p = tp(P)
    return {"X": X, "y": y, "P": P, "p": p, "Xt": t(X), "yt": t(y),
            "pre": ti.precond_factors(p, t(X), 32),
            "Xs": np.linspace(-3, 3, 50)[:, None].astype(np.float32)}


# ---- the host-built preconditioner ----

HOST_KINDS = ("rbf", "rbf*periodic+linear")


@pytest.fixture(scope="module")
def host_pc():
    """JAX's host pivoted Cholesky and factors on test_iterative.py's
    problem (multidim_regression n=256, d=3, rank 24), each kind."""
    X, _y, _ = jsyn.multidim_regression(n=256, d=3, seed=5)
    X = X.astype(np.float32)
    out = {}
    for kind in HOST_KINDS:
        P = (jk.init_params(d=3, lengthscale=1.2, noise_var=0.05)
             if kind == "rbf" else jk.default_init(kind, d=3))
        out[kind] = (P, ji.pivoted_cholesky_host(P, jnp.asarray(X), 24, kind),
                     ji.precond_factors_host(P, jnp.asarray(X), 24, kind))
    return X, out


@pytest.mark.parametrize("kind", HOST_KINDS)
def test_pivoted_cholesky_host_matches_jax(host_pc, kind):
    """The same float64 NumPy recurrence on the same inputs as JAX's
    (the oracle is a copy): Lk and every factor bit for bit, the
    residual trace to 1e-12 relative; the factors on the tensor's
    device."""
    X, out = host_pc
    P, (Lk_j, res_j), fac_j = out[kind]
    Lk, res = ti.pivoted_cholesky_host(tp(P), t(X), 24, kind=kind)
    np.testing.assert_array_equal(Lk, Lk_j)
    assert abs(res - res_j) <= 1e-12 * max(1.0, abs(res_j))
    fac = ti.precond_factors_host(tp(P), t(X), 24, kind=kind)
    for got, want in zip(fac, fac_j):
        assert got.dtype == torch.float32 and got.device == t(X).device
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pivoted_cholesky_host_matches_device(host_pc):
    """test_pivoted_cholesky_host_matches_device's bars, on the port
    alone: Lk Lk^T within 1e-3, the residual traces within 1e-2, and
    the Woodbury applies of the host and device factors within rtol
    2e-3 / atol 2e-4."""
    X, out = host_pc
    P = out["rbf"][0]
    p, Xt = tp(P), t(X)
    Lk_d, res_d = ti.pivoted_cholesky(p, Xt, 24)
    Lk_h, res_h = ti.pivoted_cholesky_host(p, Xt, 24)
    A_d = Lk_d.numpy() @ Lk_d.numpy().T
    assert np.max(np.abs(A_d - Lk_h @ Lk_h.T)) < 1e-3
    assert abs(float(res_d) - res_h) < 1e-2 * max(1.0, res_h)
    ones = torch.ones(X.shape[0], 1)
    out_d = ti.make_pivoted_precond(p, Xt, 24)(ones)
    out_h = ti.precond_apply_from_factors(
        *ti.precond_factors_host(p, Xt, 24))(ones)
    close(out_h, out_d, rtol=2e-3, atol=2e-4)


# ---- segmented CG, SLQ, LML and posterior against JAX ----


@pytest.mark.parametrize("case", ["vector", "batched_precond", "warm_start"])
def test_cg_solve_segmented_matches_jax(setup, case):
    """test_segmented_cg_matches_single_program / warm start's checks:
    the same iteration count as JAX's segmented solve (a multiple of the
    segment), and x against the port's one-call solve at rtol 1e-4 /
    atol 1e-5 (1-D), the float64 dense solve at 5e-3 (batched,
    preconditioned), the cold solve at 1e-3 (warm start): JAX's bars.
    Against JAX's x: 2e-3 (measured 4.1e-4, 3.7e-4 and 7.5e-4 for x of
    up to ~10: the two fp32 matvecs sum in other orders, and the solve
    near the fp32 residual floor amplifies it, as JAX's test notes)."""
    s = setup
    Xj, yj = jnp.asarray(s["X"]), jnp.asarray(s["y"])
    if case == "vector":
        kw = dict(block=128, tol=1e-7, iters_per_program=16, max_iters=2000)
        x_j, it_j, _ = ji.cg_solve_segmented(s["P"], Xj, yj, **kw)
        x, it, rel = ti.cg_solve_segmented(s["p"], s["Xt"], s["yt"], **kw)
        mv = ti.make_matvec(s["p"], s["Xt"], block=128)
        x_ref, _ = ti.cg_solve(mv, s["yt"], tol=1e-7, max_iters=2000)
        close(x, x_ref.numpy(), rtol=1e-4, atol=1e-5)
        assert rel <= 1e-7
    elif case == "batched_precond":
        B = np.stack([s["y"], 0.5 * s["y"]], axis=1)
        kw = dict(block=128, tol=1e-6, iters_per_program=8, max_iters=2000)
        pre_j = tuple(jnp.asarray(f.numpy()) for f in s["pre"])
        x_j, it_j, _ = ji.cg_solve_segmented(s["P"], Xj, jnp.asarray(B),
                                             precond=pre_j, **kw)
        x, it, rel = ti.cg_solve_segmented(s["p"], s["Xt"], t(B),
                                           precond=s["pre"], **kw)
        K = np.asarray(jk.train_covariance_xla(s["P"], Xj, jitter=1e-6),
                       np.float64)
        close(x, np.linalg.solve(K, B), rtol=5e-3, atol=5e-3)
        assert rel <= 1e-6 and it < 2000
    else:
        B = np.stack([s["y"], 0.5 * s["y"]], axis=1)
        x_prev = np.asarray(ji.cg_solve_program(
            s["P"], Xj, jnp.asarray(B), block=128, tol=1e-6,
            max_iters=1000)[0])
        P2 = dict(s["P"], log_lengthscale=s["P"]["log_lengthscale"] + 0.02)
        kw = dict(block=128, tol=1e-6, iters_per_program=8, max_iters=1000)
        x_j, it_j, _ = ji.cg_solve_segmented(P2, Xj, jnp.asarray(B),
                                             x0=jnp.asarray(x_prev), **kw)
        x, it, rel = ti.cg_solve_segmented(tp(P2), s["Xt"], t(B),
                                           x0=t(x_prev), **kw)
        x_cold, _ = ti.cg_solve_program(tp(P2), s["Xt"], t(B), block=128,
                                        tol=1e-6, max_iters=1000)
        close(x, x_cold.numpy(), rtol=1e-3, atol=1e-3)
        assert rel <= 1e-6
    assert it == it_j and it % kw["iters_per_program"] == 0
    close(x, x_j, rtol=0, atol=2e-3)


def test_lml_and_slq_segmented_match_jax(setup):
    """test_lml_segmented_matches_one_program's problem (8 probes, 24
    steps, segments of 5; JAX's key(3) probes passed as Z): the port's
    segmented LML within 1e-4 relative of JAX's segmented one (JAX's own
    bar between its two schedules: 0.5 absolute) and of the port's
    one-call LML; the segmented logdet bitwise the one-call logdet
    whatever its iters_per_program (it is slq_logdet)."""
    s = setup
    key = jax.random.key(3)
    n = len(s["y"])
    Z = t(rademacher(key, n, 8))
    seg_j = ji.lml_iterative_segmented(
        s["P"], jnp.asarray(s["X"]), jnp.asarray(s["y"]), key=key,
        block=128, tol=1e-7, iters_per_program=5, num_probes=8,
        num_steps=24)
    kw = dict(block=128, tol=1e-7, num_probes=8, num_steps=24)
    seg = ti.lml_iterative_segmented(s["p"], s["Xt"], s["yt"], Z,
                                     iters_per_program=5, **kw)
    one = float(ti.lml_iterative(s["p"], s["Xt"], s["yt"], Z=Z, **kw))
    assert isinstance(seg, float)
    assert abs(seg - seg_j) <= 1e-4 * abs(seg_j), (seg, seg_j)
    assert abs(seg - one) <= 1e-4 * abs(one), (seg, one)
    mv = ti.make_matvec(s["p"], s["Xt"], block=128)
    ld = ti.slq_logdet(mv, n, Z=Z, num_steps=24)
    for ipp in (1, 2, 5, 24, 30):
        assert torch.equal(ti.slq_logdet_segmented(
            s["p"], s["Xt"], n, Z, block=128, num_steps=24,
            iters_per_program=ipp), ld)


def test_posterior_segmented_matches_jax(setup):
    """test_posterior_segmented_matches_one_program: mean and variance
    within 1e-4 of the one-call posterior (JAX's bar), without the
    preconditioner (segments of 7, chunks of 16) and with it (segments
    of 4, chunks of 23) within 1e-3, and there within 1e-4 of JAX's
    segmented posterior on the same inputs and factors. Each chunk's segment is
    max(1, 16 k // max(16, width)): the counts are multiples of it."""
    s = setup
    Xj, yj, Xsj = (jnp.asarray(s[k]) for k in ("X", "y", "Xs"))
    Xs = t(s["Xs"])
    mu0, var0 = ti.posterior_iterative(s["p"], s["Xt"], s["yt"], Xs,
                                       block=128, tol=1e-7)
    pre_j = tuple(jnp.asarray(f.numpy()) for f in s["pre"])
    for ipp, cb, pre, pj, bar in ((7, 16, None, None, 1e-4),
                                  (4, 23, s["pre"], pre_j, 1e-3)):
        stats = {}
        mu, var = ti.posterior_iterative_segmented(
            s["p"], s["Xt"], s["yt"], Xs, block=128, tol=1e-7,
            iters_per_program=ipp, col_batch=cb, precond=pre, stats=stats)
        close(mu, mu0.numpy(), rtol=0, atol=bar)
        close(var, var0.numpy(), rtol=0, atol=bar)
        if pj is not None:
            mu_j, var_j = ji.posterior_iterative_segmented(
                s["P"], Xj, yj, Xsj, block=128, tol=1e-7,
                iters_per_program=ipp, col_batch=cb, precond=pj)
            close(mu, mu_j, rtol=0, atol=1e-4)
            close(var, var_j, rtol=0, atol=1e-4)
        assert stats["mean_iters"] % ipp == 0
        widths = [min(cb, 50 - lo) for lo in range(0, 50, cb)]
        for it, w in zip(stats["var_iters"], widths):
            assert it % max(1, ipp * 16 // max(16, w)) == 0


# ---- the bitwise claims ----


def test_cg_segments_compose_bitwise(setup):
    """cg_segment(a) then cg_segment(b) is cg_segment(a + b), state for
    state, preconditioned and not (CG carries only (x, r, p, rs))."""
    s = setup
    mv = ti.make_matvec(s["p"], s["Xt"], block=128)
    b = torch.stack([s["yt"], 0.5 * s["yt"]], dim=1)
    for pre in (None, ti.precond_apply_from_factors(*s["pre"])):
        s0 = ti.cg_init(b, pre)
        two = ti.cg_segment(mv, ti.cg_segment(mv, s0, 5, pre), 9, pre)
        one = ti.cg_segment(mv, s0, 14, pre)
        assert two.it == one.it == 14
        for u, v in zip(two[:4], one[:4]):
            assert torch.equal(u, v)


@pytest.mark.parametrize("case", ["plain", "precond_x0"])
def test_cg_solve_segmented_is_the_fixed_iteration_solve(setup, case):
    """cg_solve_segmented's x is bitwise cg_solve(fixed_iters=True,
    max_iters=its count) from the same start (the fixed loop is
    cg_segment), with the preconditioner and a warm start too."""
    s = setup
    b = torch.stack([s["yt"], 0.5 * s["yt"]], dim=1)
    pre, x0 = None, None
    if case == "precond_x0":
        pre, x0 = s["pre"], 0.9 * ti.cg_solve_program(
            s["p"], s["Xt"], b, block=128, tol=1e-3)[0]
    x, it, _rel = ti.cg_solve_segmented(s["p"], s["Xt"], b, block=128,
                                        tol=1e-6, iters_per_program=6,
                                        max_iters=600, precond=pre, x0=x0)
    mv = ti.make_matvec(s["p"], s["Xt"], block=128)
    x_fix, it_fix = ti.cg_solve(
        mv, b, fixed_iters=True, max_iters=it, x0=x0,
        precond_apply=None if pre is None
        else ti.precond_apply_from_factors(*pre))
    assert it_fix == it and it % 6 == 0
    assert torch.equal(x, x_fix)


# ---- fit_iterative, GP and the LMC model ----


@pytest.fixture(scope="module")
def fit_data():
    X, y, _ = jsyn.sinusoid_1d(n=256, noise_std=0.15, seed=0)
    return X.astype(np.float32), y.astype(np.float32)


FIT_KW = dict(steps=6, learning_rate=0.1, block=128, tol=1e-7,
              max_iters=1000, num_probes=8, precond_rank=16,
              precond_refresh=5, warm_start=False, probe_mode="frozen")


@pytest.fixture(scope="module")
def jax_fits(fit_data):
    """JAX's test_fit_iterative_segmented_matches_unsegmented fit
    (segment_iters=9; frozen probes from key(1), which the port gets as
    `probes`) and its host-preconditioned split fit."""
    X, y = (jnp.asarray(a) for a in fit_data)
    init = jk.init_params(d=1, lengthscale=1.5, noise_var=0.3)
    key = jax.random.key(1)
    seg = jmap.fit_iterative(init, X, y, segment_iters=9, key=key, **FIT_KW)
    host = jmap.fit_iterative(init, X, y, split_programs=True,
                              precond_where="host", key=key,
                              **dict(FIT_KW, steps=4))
    return init, rademacher(key, X.shape[0], 8), seg, host


def test_fit_iterative_segmented_matches_jax_and_unsegmented(fit_data,
                                                             jax_fits):
    """segment_iters=9: six steps, every CG count a multiple of 9, the
    params within 5e-3 of the unsegmented split fit (JAX's bar), and
    within 1e-4 of JAX's segmented fit on its probes, with the same CG
    counts."""
    X, y = (t(a) for a in fit_data)
    init, Z, (p_j, i_j), _ = jax_fits
    kw = dict(FIT_KW, probes=t(Z))
    p_seg, i_seg = tmap.fit_iterative(tp(init), X, y, segment_iters=9, **kw)
    p_one, _ = tmap.fit_iterative(tp(init), X, y, split_programs=True,
                                  segment_iters=0, **kw)
    assert len(i_seg["cg_iters"]) == 6 and (i_seg["cg_iters"] % 9 == 0).all()
    np.testing.assert_array_equal(i_seg["cg_iters"], i_j["cg_iters"])
    for k in p_one:
        close(p_seg[k], p_one[k].numpy(), rtol=0, atol=5e-3, err_msg=k)
        close(p_seg[k], p_j[k], rtol=0, atol=1e-4, err_msg=k)


def test_fit_iterative_host_precond_matches_jax(fit_data, jax_fits,
                                               monkeypatch):
    """precond_where="host": four split steps on JAX's probes, the params
    within 1e-4 of JAX's host-preconditioned fit, the CG counts within
    one of its, and the factors built where the call says (the device
    build never runs)."""
    X, y = (t(a) for a in fit_data)
    init, Z, _, (p_j, i_j) = jax_fits
    monkeypatch.setattr(ti, "precond_factors", None)  # a device build
    p, info = tmap.fit_iterative(tp(init), X, y, split_programs=True,
                                 precond_where="host", probes=t(Z),
                                 **dict(FIT_KW, steps=4))
    monkeypatch.undo()
    assert info["precond_rebuilds"] == i_j["precond_rebuilds"]
    assert np.max(np.abs(info["cg_iters"] - i_j["cg_iters"])) <= 1
    for k in p:
        close(p[k], p_j[k], rtol=0, atol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="precond_where"):
        tmap.fit_iterative(tp(init), X, y, steps=1, precond_where="tpu")
    with pytest.raises(ValueError, match="segment_iters"):
        tmap.fit_iterative(tp(init), X, y, steps=1, segment_iters=-3)


def test_fit_iterative_segmented_resumes_bitwise(fit_data, tmp_path):
    """checkpoint_dir under segment_iters: three steps resumed to six
    equal six uninterrupted bit for bit (no preconditioner, no warm
    start: nothing rebuilt on resume), final_lml included."""
    X, y = (t(a) for a in fit_data)
    init = tp(jk.init_params(d=1, lengthscale=1.5, noise_var=0.3))
    kw = dict(learning_rate=0.1, block=128, tol=1e-6, max_iters=500,
              num_probes=4, precond_rank=0, warm_start=False,
              segment_iters=5, final_lml=True)
    full_p, full = tmap.fit_iterative(init, X, y, steps=6, **kw)
    ck = os.path.join(tmp_path, "seg")
    tmap.fit_iterative(init, X, y, steps=3, checkpoint_dir=ck, **kw)
    res_p, res = tmap.fit_iterative(init, X, y, steps=6, checkpoint_dir=ck,
                                    **kw)
    assert torch.equal(res["loss"], full["loss"])
    for k in full_p:
        assert torch.equal(res_p[k], full_p[k])
    assert res["lml"] == full["lml"] and np.isfinite(full["lml"])


def test_gp_segment_knob_matches_jax(fit_data):
    """test_gp_predict_iterative_segment_knob: GP.predict_iterative with
    segment_iters=6 (chunks of 17) within 1e-3 of segment_iters=0 and
    of JAX's segmented predict; log_marginal_likelihood_iterative with
    segment_iters=8 within 1.0 of segment_iters=0 (JAX's bars) and
    within 1e-4 relative of JAX's on JAX's key(0) probes."""
    X, y = fit_data
    gp_j = JGP(kind="rbf")
    gp_j.condition(X, y)
    gp = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(X, y)
    Xs = np.linspace(-3, 3, 64)[:, None]
    mu0, var0 = gp.predict_iterative(Xs, segment_iters=0, tol=1e-7)
    mu1, var1 = gp.predict_iterative(Xs, segment_iters=6, tol=1e-7,
                                     col_batch=17)
    mu_j, var_j = gp_j.predict_iterative(Xs, segment_iters=6, tol=1e-7,
                                         col_batch=17)
    for got, want in ((mu1, mu0.numpy()), (var1, var0.numpy()),
                      (mu1, mu_j), (var1, var_j)):
        close(got, want, rtol=0, atol=1e-3)
    Z = t(rademacher(jax.random.key(0), X.shape[0], 16))
    l0 = float(gp.log_marginal_likelihood_iterative(segment_iters=0,
                                                    probes=Z))
    l1 = gp.log_marginal_likelihood_iterative(segment_iters=8, probes=Z)
    l_j = gp_j.log_marginal_likelihood_iterative(segment_iters=8)
    assert abs(l0 - l1) < 1.0
    assert abs(l1 - l_j) <= 1e-4 * abs(l_j), (l1, l_j)


def test_lmcq_segmented_matches_jax():
    """tests/test_lmc.py's matrix-free rank-Q check at n=64 (p=3, rbf +
    matern32, 20 test points in chunks of 10, tol 1e-7): segment_iters=9
    within 1e-3 of segment_iters=0 (its bar) and of JAX's segmented
    posterior, through
    lmc.posterior_lmcq_iterative and MultiOutputGPQ.predict_iterative;
    every CG count a multiple of its segment."""
    rng = np.random.default_rng(3)
    n, d, p, m = 64, 2, 3, 20
    X = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    Xs = rng.uniform(-2, 2, (m, d)).astype(np.float32)
    kinds = ("rbf", "matern32")
    P = jlmc.init_lmcq_params(d, p, kinds, noise_var=0.05, seed=1)
    Y = rng.standard_normal((n, p)).astype(np.float32)
    kw = dict(block=128, tol=1e-7, col_batch=10)
    mu_j, var_j = jlmc.posterior_lmcq_iterative(
        P, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs), kinds,
        segment_iters=9, **kw)
    pt = tp(P)
    mu0, var0 = lmc.posterior_lmcq_iterative(pt, t(X), t(Y), t(Xs), kinds,
                                             **kw)
    stats = {}
    mu, var = lmc.posterior_lmcq_iterative(pt, t(X), t(Y), t(Xs), kinds,
                                           segment_iters=9, stats=stats,
                                           **kw)
    for got, want in ((mu, mu0.numpy()), (var, var0.numpy()), (mu, mu_j),
                      (var, var_j)):
        close(got, want, rtol=0, atol=1e-3)
    assert stats["mean_iters"] % 9 == 0
    widths = [p * min(10, m - lo) for lo in range(0, m, 10)]
    assert all(it % max(1, 9 * 16 // max(16, w)) == 0
               for it, w in zip(stats["var_iters"], widths))
    model = cugp_tpu_torch.MultiOutputGPQ(kinds=kinds, device="cpu")
    model.condition(X, Y, params=params_to_numpy(pt))
    mu_f, var_f = model.predict_iterative(Xs, segment_iters=9, **kw)
    assert torch.equal(mu_f, mu) and torch.equal(var_f, var)


# ---- the CLI and the timers ----


def test_cli_fit_segment_iters_matches_jax():
    """`fit --fit.engine=iterative --fit.segment_iters=4` through both
    CLIs: rc 0, the same JSON keys, every number finite; the port's
    cg_iters_last a multiple of 4, and its params within 1e-3 of the
    port's --fit.segment_iters=0 run (the same probes; CG to 1e-6)."""
    argv = ["fit", "--data.n=128", "--fit.engine=iterative",
            "--fit.steps=3", "--fit.num_probes=4", "--fit.block=64",
            "--fit.precond_rank=8", "--fit.cg_tol=1e-6"]
    rc_j, (o_j,), _ = run(jax_main, argv + ["--fit.segment_iters=4"])
    rc, (o,), _ = run(torch_main, argv + ["--fit.segment_iters=4",
                                          "--device=cpu"])
    rc0, (o0,), _ = run(torch_main, argv + ["--fit.segment_iters=0",
                                            "--device=cpu"])
    assert rc_j == rc == rc0 == 0
    assert keyset(o) == keyset(o_j)
    assert all(np.isfinite(v) for v in flat(o).values())
    assert o["cg_iters_last"] % 4 == 0
    f, f0 = flat(o["params"]), flat(o0["params"])
    assert all(abs(f[k] - f0[k]) <= 1e-3 for k in f0), (f, f0)


def test_timers_return_positive_times():
    """timed_loop chains step_fn `iters` times after one warm-up call and
    returns seconds an iteration; rtt_overhead a positive round trip;
    _fetch_barrier reads a nested output (an empty tensor skipped)."""
    calls = []

    def step(c):
        calls.append(1)
        x, k = c
        return x, x @ x.T + k[:1, :1]

    init = (torch.randn(64, 8), torch.zeros(64, 64))
    s = profiling.timed_loop(step, init, iters=7)
    assert len(calls) == 8 and 0.0 < s < 1.0
    calls.clear()
    assert profiling.timed_loop(step, init, iters=5, warmup=False) > 0.0
    assert len(calls) == 5
    r = profiling.rtt_overhead(iters=3)
    assert 0.0 < r < 1.0
    t0 = time.perf_counter()
    profiling._fetch_barrier({"a": (torch.ones(3), [torch.empty(0)]),
                              "b": torch.zeros(2, 2)})
    assert time.perf_counter() - t0 < 1.0
