"""The port's sparse family (SGPR, SVGP) against the JAX package (CPU):
the bounds, their gradients, the posteriors and short fits from the same
float32 inputs; the facades (GP.fit_sparse / predict_sparse, SVGP) with
save/load across the packages; the synthetic generators; and the fit
loop's optax rules (apply_if_finite's count, the global-norm clip).

The JAX side runs as its own tests run it here: XLA's Cholesky and
solves on the CPU, where the port runs its own recursions over the
kernels' plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cugp_tpu
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.models import exact_gp as jexact
from cugp_tpu.models import sgpr as jsgpr
from cugp_tpu.models import svgp as jsvgp
from cugp_tpu.ops import kernels as jk

import cugp_tpu_torch
from cugp_tpu_torch.data import synthetic as tsyn
from cugp_tpu_torch.inference import map_opt
from cugp_tpu_torch.models import exact_gp, sgpr, svgp
from cugp_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def rel_to_max(got, want):
    """max |got - want| over max |want| (the gradient bars' scale)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def grads_of(fn, tree):
    """fn's value and gradient in every leaf of a dict of tensors."""
    tr = {k: v.detach().clone().requires_grad_(True) for k, v in
          tree.items()}
    val = fn(tr)
    val.backward()
    # a leaf the value does not reach has zero gradient, as under jax.grad
    return float(val.detach()), {
        k: torch.zeros_like(v) if v.grad is None else v.grad
        for k, v in tr.items()}


@pytest.fixture(scope="module")
def reg():
    """multidim_regression at n=300, d=3 and m=32 inducing rows: a cell
    whose K_mm keeps fp32 well away from its conditioning limit."""
    X, y, _ = jsyn.multidim_regression(n=300, d=3, seed=1)
    X, y = X.astype(np.float32), y.astype(np.float32)
    p_np = jax.tree.map(np.asarray, jk.init_params(
        d=3, lengthscale=1.0, signal_var=1.2, noise_var=0.05))
    Z = np.asarray(jsgpr.init_inducing(jnp.asarray(X), 32, seed=0))
    Xs = np.random.default_rng(4).uniform(-2.0, 2.0, (40, 3)).astype(
        np.float32)
    return dict(X=X, y=y, p_np=p_np, Z=Z, Xs=Xs,
                pj=jax.tree.map(jnp.asarray, p_np),
                pt=params_from_numpy(p_np, "cpu"))


# ---- synthetic generators and the inducing initialization ----


@pytest.mark.parametrize("name,kw", [
    ("poisson_counts", dict(n=120, seed=3)),
    ("sinusoid_outliers", dict(n=120, outlier_frac=0.2, seed=4)),
    ("two_moons", dict(n=121, noise_std=0.2, seed=5)),
    ("gaussian_blobs", dict(n=122, num_classes=4, d=3, seed=6)),
])
def test_generators_bitwise(name, kw):
    """The port's copies give the JAX package's arrays bit for bit."""
    for a, b in zip(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_inducing_bitwise(reg):
    """sgpr.init_inducing: the same NumPy draw, so the same rows."""
    Z = sgpr.init_inducing(t(reg["X"]), 32, seed=0)
    np.testing.assert_array_equal(Z.numpy(), reg["Z"])
    assert sgpr.init_inducing(t(reg["X"][:20]), 32).shape == (20, 3)


# ---- SGPR ----


def test_sgpr_elbo_gradient_posterior_match_jax(reg):
    """The collapsed ELBO at 1e-5 relative, its gradient in every
    hyperparameter and in Z at 1e-4 of the largest component, the
    posterior mean/variance (with and without noise) at 1e-4 abs."""
    X, y, Z = reg["X"], reg["y"], reg["Z"]
    tree_j = {"params": reg["pj"], "Z": jnp.asarray(Z)}
    ej, gj = jax.value_and_grad(lambda tr: jsgpr.elbo(
        tr["params"], tr["Z"], jnp.asarray(X), jnp.asarray(y)))(tree_j)
    tr = {"Z": t(Z), **reg["pt"]}
    et, gt = grads_of(lambda tr: sgpr.elbo(
        {k: v for k, v in tr.items() if k != "Z"}, tr["Z"], t(X), t(y)), tr)
    assert abs(et - float(ej)) <= 1e-5 * abs(float(ej))
    for k in reg["p_np"]:
        assert rel_to_max(gt[k], gj["params"][k]) <= 1e-4, k
    assert rel_to_max(gt["Z"], gj["Z"]) <= 1e-4
    for noise in (False, True):
        mj, vj = jsgpr.posterior(reg["pj"], jnp.asarray(Z), jnp.asarray(X),
                                 jnp.asarray(y), jnp.asarray(reg["Xs"]),
                                 include_noise=noise)
        mt, vt = sgpr.posterior(reg["pt"], t(Z), t(X), t(y), t(reg["Xs"]),
                                include_noise=noise)
        close(mt, mj, atol=1e-4)
        close(vt, vj, atol=1e-4)


def _sgpr_elbo64(p, Z, X, y, jitter=1e-6):
    """The collapsed bound of the rbf model in float64 (torch.linalg as
    the reference), differentiable in p."""
    def k(A, B):
        ell = torch.exp(p["log_lengthscale"])
        d2 = (((A[:, None, :] - B[None, :, :]) / ell) ** 2).sum(-1)
        return torch.exp(p["log_signal_var"]) * torch.exp(-0.5 * d2)

    m, n = Z.shape[0], X.shape[0]
    sn2, sf2 = torch.exp(p["log_noise_var"]), torch.exp(p["log_signal_var"])
    eye = torch.eye(m, dtype=torch.float64)
    L = torch.linalg.cholesky(k(Z, Z) + (jitter * sf2 + 1e-6) * eye)
    A = torch.linalg.solve_triangular(L, k(Z, X), upper=False) / sn2.sqrt()
    LB = torch.linalg.cholesky(eye + A @ A.T)
    c = torch.linalg.solve_triangular(LB, (A @ y)[:, None],
                                      upper=False)[:, 0] / sn2.sqrt()
    out = (-0.5 * n * (math.log(2 * math.pi) + torch.log(sn2))
           - torch.log(torch.diagonal(LB)).sum() - 0.5 * (y * y).sum() / sn2
           + 0.5 * (c * c).sum())
    return out - 0.5 * n * sf2 / sn2 + 0.5 * (A * A).sum()


def test_sgpr_at_the_jax_tests_cell_matches_float64():
    """At tests/test_sgpr.py's ill-conditioned cell (sinusoid_1d n=256,
    48 inducing rows at lengthscale 0.8) the JAX package's fp32 gradient
    strays from float64 by up to 3.0 in log_signal_var (ROADMAP §3); the
    port is held to float64 there: ELBO 2e-5 relative, gradient 1e-3 of
    its largest component."""
    X, y, _ = jsyn.sinusoid_1d(n=256, noise_std=0.1, seed=3)
    X, y = X.astype(np.float32), y.astype(np.float32)
    p_np = jax.tree.map(np.asarray, jk.init_params(
        d=1, lengthscale=0.8, signal_var=1.2, noise_var=0.05))
    Z = sgpr.init_inducing(t(X), 48, seed=0)
    et, gt = grads_of(lambda p: sgpr.elbo(p, Z, t(X), t(y)),
                      params_from_numpy(p_np, "cpu"))
    p64 = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
           for k, v in p_np.items()}
    e64 = _sgpr_elbo64(p64, Z.double(), torch.tensor(X, dtype=torch.float64),
                       torch.tensor(y, dtype=torch.float64))
    e64.backward()
    e64 = float(e64.detach())
    assert abs(et - e64) <= 2e-5 * abs(e64)
    g64 = np.concatenate([p64[k].grad.numpy().ravel() for k in p_np])
    g32 = np.concatenate([gt[k].numpy().ravel() for k in p_np])
    assert rel_to_max(g32, g64) <= 1e-3


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_sgpr_full_inducing_equals_the_dense_lml(reference):
    """Z = X: the collapsed bound is the exact LML within 2e-3 a point
    (tests/test_sgpr.py's bar), of the port's dense path and of the JAX
    package's (its XLA route)."""
    X, y, _ = jsyn.sinusoid_1d(n=200, noise_std=0.2, seed=0)
    pn = jax.tree.map(np.asarray, jk.init_params(d=1, lengthscale=0.8,
                                                 noise_var=0.05))
    p = params_from_numpy(pn, "cpu")
    if reference == "port":
        lml = float(exact_gp.log_marginal_likelihood(p, t(X), t(y)))
    else:
        lml = float(jexact.log_marginal_likelihood(
            jax.tree.map(jnp.asarray, pn), jnp.asarray(X, jnp.float32),
            jnp.asarray(y, jnp.float32), method="xla"))
    bound = float(sgpr.elbo(p, t(X), t(X), t(y)))
    assert abs(bound - lml) / len(y) < 2e-3


def test_sgpr_fit_and_facade_match_jax(reg):
    """Five Adam steps (inducing rows trained too): losses at 1e-4
    relative (1e-5 at fixed params; the steps compound the rounding),
    params and Z within 1e-4; then GP.fit_sparse /
    predict_sparse against the JAX facade (normalize_y on) at 1e-4."""
    X, y = reg["X"], reg["y"]
    pj, Zj, ij = jsgpr.fit(reg["pj"], X, y, num_inducing=32, steps=5,
                           learning_rate=0.05, seed=0)
    pt, Zt, it = sgpr.fit(reg["pt"], t(X), t(y), num_inducing=32, steps=5,
                          learning_rate=0.05, seed=0)
    close(it["loss"], ij["loss"], rtol=1e-4)
    for k in reg["p_np"]:
        close(pt[k], pj[k], atol=1e-4)
    close(Zt, Zj, atol=1e-4)
    gp_j = cugp_tpu.GP(kind="rbf", normalize_y=True)
    gp_t = cugp_tpu_torch.GP(kind="rbf", normalize_y=True, device="cpu")
    info_j = gp_j.fit_sparse(X, 3.0 * y + 1.0, num_inducing=24, steps=5)
    info_t = gp_t.fit_sparse(X, 3.0 * y + 1.0, num_inducing=24, steps=5)
    close(info_t["elbo"], info_j["elbo"], rtol=1e-4)
    close(gp_t.Z, gp_j.Z, atol=1e-4)
    for noise in (False, True):
        for a, b in zip(gp_t.predict_sparse(reg["Xs"], include_noise=noise),
                        gp_j.predict_sparse(reg["Xs"], include_noise=noise)):
            close(a, b, atol=1e-4 * 3.0 ** 2)


# ---- SVGP ----


def _vp(m, seed):
    """A non-trivial whitened q(v): m ~ N(0, 0.5^2), C's flat entries
    ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return {"m": (0.5 * rng.standard_normal(m)).astype(np.float32),
            "c": (0.1 * rng.standard_normal(m * (m + 1) // 2)).astype(
                np.float32)}


def _targets(y, likelihood):
    if likelihood == "bernoulli":
        return np.where(y > 0, 1.0, -1.0).astype(np.float32)
    if likelihood == "poisson":
        return np.round(np.abs(3.0 * y)).astype(np.float32)
    return y


@pytest.mark.parametrize("likelihood", svgp.LIKELIHOODS)
def test_svgp_elbo_and_gradient_match_jax(reg, likelihood):
    """The minibatch-scaled bound of every likelihood at 1e-5 relative;
    its gradient in the hyperparameters (log_nu too for student_t),
    q(v) and Z at 1e-4 of the largest component."""
    X, Z = reg["X"][:120], reg["Z"]
    y = _targets(reg["y"][:120], likelihood)
    p_np = dict(reg["p_np"])
    if likelihood == "student_t":
        p_np["log_nu"] = np.float32(math.log(5.0))
    vp = _vp(32, 1)
    tree = {"params": p_np, "Z": Z, **vp}

    def jfn(tr):
        return jsvgp.elbo(tr["params"], tr["Z"], {"m": tr["m"], "c": tr["c"]},
                          jnp.asarray(X), jnp.asarray(y),
                          likelihood=likelihood, scale=2.5)

    ej, gj = jax.value_and_grad(jfn)(jax.tree.map(jnp.asarray, tree))
    flat = {**params_from_numpy(p_np, "cpu"), "Z": t(Z), "m": t(vp["m"]),
            "c": t(vp["c"])}
    et, gt = grads_of(lambda tr: svgp.elbo(
        {k: tr[k] for k in p_np}, tr["Z"], {"m": tr["m"], "c": tr["c"]},
        t(X), t(y), likelihood=likelihood, scale=2.5), flat)
    assert abs(et - float(ej)) <= 1e-5 * abs(float(ej))
    for k in p_np:
        assert rel_to_max(gt[k], gj["params"][k]) <= 1e-4, k
    for k in ("Z", "m", "c"):
        assert rel_to_max(gt[k], gj[k]) <= 1e-4, k


def test_svgp_optimal_variational_matches_jax_and_collapses(reg):
    """optimal_variational (S from B's Cholesky factor and two TRSMs,
    where JAX calls inv) against JAX's at 1e-4 of each leaf's largest
    entry, in one block and in 8192-column chunks (n = 9000, JAX's
    padded scan); at the optimum the uncollapsed bound equals the port's
    SGPR bound at the same K_mm jitter within 1e-5 relative."""
    X, y, Z = reg["X"], reg["y"], reg["Z"]
    vj = jsvgp.optimal_variational(reg["pj"], jnp.asarray(Z), jnp.asarray(X),
                                   jnp.asarray(y))
    vt = svgp.optimal_variational(reg["pt"], t(Z), t(X), t(y))
    for k in ("m", "c"):
        assert rel_to_max(vt[k], vj[k]) <= 1e-4, k
    full = float(svgp.elbo(reg["pt"], t(Z), vt, t(X), t(y)))
    collapsed = float(sgpr.elbo(reg["pt"], t(Z), t(X), t(y),
                                jitter=svgp.KMM_JITTER_FLOOR))
    assert abs(full - collapsed) <= 1e-5 * abs(collapsed)
    Xl, yl, _ = jsyn.multidim_regression(n=9000, d=3, seed=2)
    Xl, yl = Xl.astype(np.float32), yl.astype(np.float32)
    vj = jsvgp.optimal_variational(reg["pj"], jnp.asarray(Z), jnp.asarray(Xl),
                                   jnp.asarray(yl))
    vt = svgp.optimal_variational(reg["pt"], t(Z), t(Xl), t(yl))
    for k in ("m", "c"):
        assert rel_to_max(vt[k], vj[k]) <= 1e-4, k


def test_svgp_predictives_match_jax(reg):
    """posterior (gaussian and student_t, with and without noise),
    predict_rate and predict_proba at 1e-4 abs (rate: relative);
    include_noise raises for the count and label likelihoods."""
    Z, Xs = reg["Z"], reg["Xs"]
    vp = _vp(32, 2)
    p_np = dict(reg["p_np"], log_nu=np.float32(math.log(5.0)))
    pj, pt = jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, "cpu")
    vpj, vpt = jax.tree.map(jnp.asarray, vp), params_from_numpy(vp, "cpu")
    for lik in ("gaussian", "student_t"):
        for noise in (False, True):
            a = svgp.posterior(pt, t(Z), vpt, t(Xs), include_noise=noise,
                               likelihood=lik)
            b = jsvgp.posterior(pj, jnp.asarray(Z), vpj, jnp.asarray(Xs),
                                include_noise=noise, likelihood=lik)
            for u, v in zip(a, b):
                close(u, v, atol=1e-4)
    for u, v in zip(svgp.predict_rate(pt, t(Z), vpt, t(Xs)),
                    jsvgp.predict_rate(pj, jnp.asarray(Z), vpj,
                                       jnp.asarray(Xs))):
        close(u, v, rtol=1e-4)
    for u, v in zip(svgp.predict_proba(pt, t(Z), vpt, t(Xs)),
                    jsvgp.predict_proba(pj, jnp.asarray(Z), vpj, Xs)):
        close(u, v, atol=1e-4)
    with pytest.raises(ValueError, match="include_noise"):
        svgp.posterior(pt, t(Z), vpt, t(Xs), include_noise=True,
                       likelihood="poisson")


@pytest.mark.parametrize("schedule", ["shuffle", "explicit"])
def test_svgp_fit_replays_jax_indices(reg, schedule):
    """Five SGD steps on JAX's own minibatch indices: the gaussian fit
    with its warm start through batch_sampling="shuffle" (NumPy, the
    same bits), the bernoulli fit through an explicit schedule handed to
    both; losses at 1e-4 relative, every trained leaf within 1e-4."""
    X, Z = reg["X"], reg["Z"]
    if schedule == "shuffle":
        lik, kw = "gaussian", dict(batch_sampling="shuffle")
        y = reg["y"]
        ptr, Ztr, vtr, it = svgp.fit(
            reg["pt"], t(X), t(y), Z=t(Z), steps=5, batch=64,
            learning_rate=0.01, likelihood=lik, **kw)
        pjr, Zjr, vjr, ij = jsvgp.fit(
            reg["pj"], X, y, Z=jnp.asarray(Z), steps=5, batch=64,
            learning_rate=0.01, likelihood=lik, **kw)
    else:
        lik = "bernoulli"
        y = _targets(reg["y"], lik)
        sched = np.random.default_rng(7).integers(0, len(y), (5, 64))
        ptr, Ztr, vtr, it = svgp.fit(
            reg["pt"], t(X), t(y), Z=t(Z), steps=5, batch=64,
            learning_rate=0.01, likelihood=lik, idx_schedule=sched)
        vp0 = jsvgp.init_variational(32)
        tr, losses = jsvgp._fit_scan(
            {"params": reg["pj"], "m": vp0["m"], "c": vp0["c"],
             "Z": jnp.asarray(Z)}, jnp.asarray(Z), jnp.asarray(X),
            jnp.asarray(y), jax.random.key(0), "rbf", 1e-6, lik, 5, 64,
            0.01, True, idx_schedule=jnp.asarray(sched, jnp.int32))
        pjr, Zjr, vjr = tr["params"], tr["Z"], {"m": tr["m"], "c": tr["c"]}
        ij = {"loss": losses}
    close(it["loss"], ij["loss"], rtol=1e-4)
    for k in reg["p_np"]:
        close(ptr[k], pjr[k], atol=1e-4)
    close(Ztr, Zjr, atol=1e-4)
    for k in ("m", "c"):
        close(vtr[k], vjr[k], atol=1e-4)


def test_svgp_replacement_indices_come_from_a_cpu_generator(reg):
    """batch_sampling="replacement" draws the (steps, batch) indices from
    a CPU generator seeded `seed`: the fit equals one handed those
    indices; an unknown sampling raises."""
    X, y, Z = t(reg["X"]), t(reg["y"]), t(reg["Z"])
    a = svgp.fit(reg["pt"], X, y, Z=Z, steps=3, batch=32, seed=5)
    idx = torch.randint(0, 300, (3, 32),
                        generator=torch.Generator().manual_seed(5))
    b = svgp.fit(reg["pt"], X, y, Z=Z, steps=3, batch=32, seed=5,
                 idx_schedule=idx)
    assert torch.equal(a[3]["loss"], b[3]["loss"])
    assert torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="batch_sampling"):
        svgp.fit(reg["pt"], X, y, Z=Z, steps=1, batch_sampling="sobol")


def test_svgp_facade_matches_jax_and_saves_across(reg, tmp_path):
    """SVGP (bernoulli) fitted in the port, saved, loaded by the JAX
    package and back: predict (labels), predict_proba and elbo agree at
    1e-4 between the packages on the same state; the gaussian facade's
    predict the same; bad likelihoods and labels raise."""
    X = reg["X"]
    labels = np.where(reg["y"] > 0, "pos", "neg")
    m_t = cugp_tpu_torch.SVGP(likelihood="bernoulli", device="cpu")
    info = m_t.fit(X, labels, num_inducing=16, steps=4, batch=32)
    assert np.isfinite(info["loss"].numpy()).all()
    path = str(tmp_path / "svgp")
    m_t.save(path)
    m_j = cugp_tpu.SVGP.load(path)
    assert list(m_j._classes) == ["neg", "pos"]
    close(m_t.predict_proba(reg["Xs"]), m_j.predict_proba(reg["Xs"]),
          atol=1e-4)
    assert (m_t.predict(reg["Xs"]) == m_j.predict(reg["Xs"])).all()
    close(m_t.elbo(X, labels), m_j.elbo(X, labels), rtol=1e-5)
    path2 = str(tmp_path / "svgp_back")
    m_j.save(path2)
    m_b = cugp_tpu_torch.SVGP.load(path2, device="cpu")
    for k in ("m", "c"):
        assert torch.equal(m_b.vp[k], m_t.vp[k])
    close(m_b.predict_proba(reg["Xs"]), m_t.predict_proba(reg["Xs"]),
          atol=0)
    with pytest.raises(ValueError, match="within fitted classes"):
        m_t.elbo(X[:3], np.asarray(["a", "b", "c"]))
    g_t = cugp_tpu_torch.SVGP(device="cpu")
    g_t.fit(X, reg["y"], num_inducing=16, steps=2, batch=32)
    g_t.save(str(tmp_path / "g"))
    g_j = cugp_tpu.SVGP.load(str(tmp_path / "g"))
    for a, b in zip(g_t.predict(reg["Xs"], include_noise=True),
                    g_j.predict(reg["Xs"], include_noise=True)):
        close(a, b, atol=1e-4)
    with pytest.raises(ValueError, match="likelihood"):
        cugp_tpu_torch.SVGP(likelihood="laplace", device="cpu")
    with pytest.raises(ValueError, match="bernoulli"):
        g_t.predict_proba(reg["Xs"])


# ---- the fit loop's optax rules ----


@pytest.mark.parametrize("count", [100, 1000])
def test_finite_guard_counts_as_optax(count):
    """optax.apply_if_finite(adam, count) against map_opt.adam_fit on a
    gradient stream of one finite step, count + 1 non-finite ones and
    two finite ones: both skip the first `count` non-finite steps
    (params and Adam state untouched) and apply the next, and the
    parameter trajectories agree (NaN where optax's is NaN)."""
    n_bad = count + 1
    gs = ([1.0] + [math.nan] * n_bad + [0.5, -0.25])
    tx = optax.apply_if_finite(optax.adam(0.1), count)
    update = jax.jit(tx.update)
    p = jnp.asarray([1.0, 2.0])
    s = tx.init(p)
    traj_j = []
    for g in gs:
        u, s = update(jnp.full((2,), g, jnp.float32), s, p)
        p = optax.apply_updates(p, u)
        traj_j.append(np.asarray(p))
    traj_t = []

    def loss_fn(tr, step):
        traj_t.append(tr["w"].detach().clone().numpy())
        return gs[step] * torch.sum(tr["w"])

    w, _ = map_opt.adam_fit({"w": t([1.0, 2.0])}, loss_fn, steps=len(gs),
                            learning_rate=0.1, max_consecutive_errors=count,
                            clamp=False)
    traj_t = traj_t[1:] + [w["w"].numpy()]
    assert np.isfinite(traj_t[count]).all()      # the count-th skipped
    assert np.isnan(traj_t[count + 1]).all()     # the next applied
    np.testing.assert_allclose(np.asarray(traj_t), np.asarray(traj_j),
                               rtol=1e-6)
    guard = map_opt.FiniteGuard(count)
    bad = [torch.tensor([math.inf])]
    assert [guard.apply(bad) for _ in range(count + 1)] == (
        [False] * count + [True])
    assert guard.apply([torch.ones(1)]) and guard.notfinite_count == 0


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_clip_by_global_norm_matches_optax(scale):
    """clip_by_global_norm_ in place against optax.clip_by_global_norm
    at max_norm 1, below and above the norm (no epsilon)."""
    rng = np.random.default_rng(0)
    g = {"a": (scale * rng.standard_normal(5)).astype(np.float32),
         "b": (scale * rng.standard_normal((2, 3))).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, g), None)
    got = [t(g["a"]), t(g["b"])]
    map_opt.clip_by_global_norm_(got, 1.0)
    close(got[0], want["a"], rtol=1e-6)
    close(got[1], want["b"], rtol=1e-6)
