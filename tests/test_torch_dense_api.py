"""The port's dense exact-GP functions beyond the main path, against the
JAX package (CPU): multi-output, explicit bases, LOO, analytic
gradients, L-BFGS, restarts, priors, and log_prior in fit_iterative.

The same seeded numpy inputs, in float32, go through cugp_tpu and
cugp_tpu_torch (CPU tensors, i.e. the kernels' plain versions); the
float64 oracle is the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.inference import map_opt as jmap
from cugp_tpu.models import exact_gp as jgp
from cugp_tpu.ops import kernels as jk
from cugp_tpu.oracle import exact_gp_np as oracle

from cugp_tpu_torch.inference import map_opt as tmap
from cugp_tpu_torch.models import exact_gp as tgp
from cugp_tpu_torch.utils.params import (params_from_numpy, params_to_numpy,
                                         tree_leaves)

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                       "exact_gp_sinusoid256.npz")
BASE_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "periodic",
              "linear")


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def tp(P):
    return params_from_numpy(P, "cpu")


def init(kind, d, **kw):
    return jax.tree.map(np.asarray, jk.default_init(kind, d=d, **kw))


def f64(P):
    return jax.tree.map(lambda v: np.asarray(v, np.float64), P)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


@pytest.fixture(scope="module")
def data():
    """Config-2 data (multidim_regression) at n=128, d=2, two outputs and
    40 test points, in float32."""
    X, y, _ = jsyn.multidim_regression(n=128, d=2, seed=0)
    Y = np.stack([y, np.cos(2.0 * X[:, 1]) + 0.1 * y], axis=1)
    Xs = np.random.default_rng(1).uniform(-2.0, 2.0, (40, 2))
    return tuple(a.astype(np.float32) for a in (X, y, Y, Xs))


def test_multi_output_matches_jax(data):
    """LML rtol 1e-5, means and variance atol 1e-5; one output at a time
    gives the same numbers."""
    X, y, Y, Xs = data
    P = init("matern52", 2)
    lml_t = tgp.log_marginal_likelihood_multi(tp(P), t(X), t(Y),
                                              kind="matern52")
    close(float(lml_t), float(jgp.log_marginal_likelihood_multi(
        P, X, Y, kind="matern52")), rtol=1e-5)
    mu_t, var_t = tgp.posterior_multi(tp(P), t(X), t(Y), t(Xs),
                                      kind="matern52", include_noise=True)
    mu_j, var_j = jgp.posterior_multi(P, X, Y, Xs, kind="matern52",
                                      include_noise=True)
    assert mu_t.shape == (40, 2) and var_t.shape == (40,)
    close(mu_t, mu_j, atol=1e-5)
    close(var_t, var_j, atol=1e-5)
    singles = [float(tgp.log_marginal_likelihood(tp(P), t(X), t(Y[:, j]),
                                                 kind="matern52"))
               for j in range(2)]
    close(float(lml_t), sum(singles), rtol=1e-5)
    for j in range(2):
        mu, _ = tgp.posterior(tp(P), t(X), t(Y[:, j]), t(Xs),
                              kind="matern52")
        close(mu_t[:, j], mu, atol=1e-5)


@pytest.mark.parametrize("basis", ["constant", "linear"])
def test_basis_matches_jax_and_oracle(data, basis):
    """LML rtol 1e-5 and posterior (mean, variance, full covariance, beta)
    atol 1e-5 against JAX; both within 1e-3 of the float64 oracle (the
    LML per point)."""
    X, y, _, Xs = data
    P = init("rbf", 2, lengthscale=0.8)
    lml_t = float(tgp.log_marginal_likelihood_basis(tp(P), t(X), t(y),
                                                    basis=basis))
    lml_j = float(jgp.log_marginal_likelihood_basis(P, X, y, basis=basis))
    close(lml_t, lml_j, rtol=1e-5)
    lml_o = oracle.log_marginal_likelihood_basis(f64(P), X, y, basis=basis)
    assert abs(lml_t - lml_o) / len(y) < 1e-3
    got = tgp.posterior_basis(tp(P), t(X), t(y), t(Xs), basis=basis)
    want = jgp.posterior_basis(P, X, y, Xs, basis=basis)
    for g, w in zip(got, want):
        close(g, w, atol=1e-5)
    for g, w in zip(got, oracle.posterior_basis(f64(P), X, y, Xs,
                                                basis=basis)):
        close(g, w, atol=1e-3)
    got = tgp.posterior_basis_full_cov(tp(P), t(X), t(y), t(Xs[:16]),
                                       basis=basis)
    want = jgp.posterior_basis_full_cov(P, X, y, Xs[:16], basis=basis)
    for g, w in zip(got, want):
        close(g, w, atol=1e-5)
    for g, w in zip(got, oracle.posterior_basis_full_cov(
            f64(P), X, y, Xs[:16], basis=basis)):
        close(g, w, atol=1e-3)


def test_basis_lml_gradient_matches_jax(data):
    """Autograd through the m_b x m_b Cholesky and solves of the basis
    correction: rtol 1e-4 against jax.grad."""
    X, y, _, _ = data
    P = init("rbf", 2, lengthscale=0.8)

    def lml(p):
        return tgp.log_marginal_likelihood_basis(p, t(X), t(y),
                                                 basis="linear")

    p = jax.tree.map(lambda v: v.requires_grad_(True), tp(P))
    grads = torch.autograd.grad(lml(p), tree_leaves(p))
    g_j = jax.grad(lambda q: jgp.log_marginal_likelihood_basis(
        q, X, y, basis="linear"))(P)
    for g, key in zip(grads, p):
        close(g, g_j[key], rtol=1e-4)


@pytest.mark.parametrize("kind", ["rbf", "matern32", "rq"])
def test_loo_matches_jax_and_oracle(data, kind):
    """mean atol 1e-5, var rtol 1e-4, logp atol 1e-4 against JAX; the
    oracle at tests/test_loo.py's bars (mean 2e-3, var 2e-3 relative,
    logp 5e-3)."""
    X, y, _, _ = data
    P = init(kind, 2)
    mu, var, logp = tgp.loo_cv(tp(P), t(X), t(y), kind=kind)
    mu_j, var_j, logp_j = jgp.loo_cv(P, X, y, kind=kind)
    close(mu, mu_j, atol=1e-5)
    close(var, var_j, rtol=1e-4)
    close(logp, logp_j, atol=1e-4)
    mu_o, var_o, logp_o = oracle.loo_cv(f64(P), X, y, kind=kind)
    close(mu, mu_o, atol=2e-3)
    close(var, var_o, rtol=2e-3)
    close(logp, logp_o, atol=5e-3)
    close(float(tgp.loo_pseudo_likelihood(tp(P), t(X), t(y), kind=kind)),
          float(np.sum(logp_j)), rtol=1e-5)


def test_loo_gradient_matches_jax(data):
    """The objective="loo" gradient runs through the identity solve's
    backward (two more n x n solves): rtol 1e-4 against jax.grad."""
    X, y, _, _ = data
    P = init("rbf", 2)
    p = jax.tree.map(lambda v: v.requires_grad_(True), tp(P))
    grads = torch.autograd.grad(
        tgp.loo_pseudo_likelihood(p, t(X), t(y)), tree_leaves(p))
    g_j = jax.grad(lambda q: jgp.loo_pseudo_likelihood(q, X, y))(P)
    for g, key in zip(grads, p):
        close(g, g_j[key], rtol=1e-4)


@pytest.mark.parametrize("kind", BASE_KINDS)
def test_analytic_gradients_match_jax_and_autograd(data, kind):
    """rtol 1e-4 against JAX's analytic gradients and against the port's
    autograd (lml_value_and_grad).

    noise_var = 1 keeps the fp32 floor below the bar: there JAX's own
    analytic and autograd gradients agree to ~1e-5 for every family (at
    the default 0.1 the linear family's differ by 7e-4).
    """
    X, y, _, _ = data
    P = init(kind, 2, noise_var=1.0)
    g_t = tgp.lml_gradients_analytic(tp(P), t(X), t(y), kind=kind)
    g_j = jgp.lml_gradients_analytic(P, X, y, kind=kind)
    assert set(g_t) == set(g_j)
    _, g_ad = tgp.lml_value_and_grad(tp(P), t(X), t(y), kind=kind)
    for key in g_j:
        close(g_t[key], g_j[key], rtol=1e-4)
        close(g_t[key], g_ad[key], rtol=1e-4)


@pytest.mark.parametrize("noise_var", [0.1, 1.0])
def test_matern12_autograd_gradient_matches_jax(data, noise_var):
    """The port's autograd LML gradient for matern12 (through CovTile's
    backward, the VJP of cov_tile_plain) against jax.grad of the JAX LML,
    rtol 1e-4. The plain tile sets d2 to exactly 0 on a square build's
    diagonal, as the JAX builder's clamp does in effect; without it the
    GEMM's rounding of d2 there put the gradient 1e-4 to 3e-4 off (F2 in
    ROADMAP.md section 3)."""
    X, y, _, _ = data
    P = init("matern12", 2, noise_var=noise_var)
    _, g_t = tgp.lml_value_and_grad(tp(P), t(X), t(y), kind="matern12")
    g_j = jax.grad(lambda p: jgp.log_marginal_likelihood(
        p, X, y, kind="matern12"))(P)
    for key in g_j:
        close(g_t[key], g_j[key], rtol=1e-4)


def test_analytic_gradients_rq_golden():
    """The rq analytic gradients (with d/dlog_alpha) against the float64
    goldens, at tests/test_goldens.py's bars."""
    golden = np.load(_GOLDEN)
    P = {k: golden[k] for k in ("log_lengthscale", "log_signal_var",
                                "log_noise_var", "log_alpha")}
    g = tgp.lml_gradients_analytic(tp(P), t(golden["X"]), t(golden["y"]),
                                   kind="rq")
    for key, name in (("log_lengthscale", "grad_ell_rq"),
                      ("log_signal_var", "grad_sf_rq"),
                      ("log_noise_var", "grad_sn_rq"),
                      ("log_alpha", "grad_alpha_rq")):
        close(g[key], golden[name], rtol=5e-2, atol=5e-2)


def test_lbfgs_matches_jax(data):
    """optax.lbfgs's iterates: the loss trace of the first 3 steps at rtol
    1e-4, and the final LML after 30 steps within 1e-3 per point."""
    X, y, _, _ = data
    P = init("rbf", 2)
    p_j, info_j = jmap.fit(P, X, y, steps=30, optimizer="lbfgs")
    p_t, info_t = tmap.fit(tp(P), t(X), t(y), steps=30, optimizer="lbfgs",
                           learning_rate=123.0)  # ignored, as in JAX
    loss_j = np.asarray(info_j["loss"])
    close(info_t["loss"][:3], loss_j[:3], rtol=1e-4)
    assert len(info_t["linesearch_steps"]) == 30
    assert (info_t["linesearch_steps"] >= 1).all()
    lml_t = float(tgp.log_marginal_likelihood(p_t, t(X), t(y)))
    lml_j = float(jgp.log_marginal_likelihood(p_j, X, y))
    assert abs(lml_t - lml_j) / len(y) < 1e-3
    assert lml_t > -loss_j[0]


def jax_restart_starts(P, restarts, key, scale):
    """map_opt.fit_restarts's starts, drawn as the JAX package draws them."""
    keys = jax.random.split(key, restarts)

    def perturb(k, p):
        leaves, treedef = jax.tree_util.tree_flatten(p)
        ks = jax.random.split(k, len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf + scale * jax.random.normal(kk, jnp.shape(leaf)))
            for kk, leaf in zip(ks, leaves)])

    return [P] + [perturb(keys[i], P) for i in range(1, restarts)]


def test_fit_restarts_matches_jax(data, monkeypatch):
    """With JAX's perturbed starts fed in, restart_lmls at rtol 1e-4, the
    same best restart, and restart 0 equal to a plain fit from the init."""
    X, y, _, _ = data
    P = init("periodic", 2)
    kw = dict(kind="periodic", steps=8, learning_rate=0.1)
    p_j, info_j = jmap.fit_restarts(P, X, y, restarts=3, scale=0.5, **kw)
    starts = [tp(s) for s in jax_restart_starts(P, 3, jax.random.key(0),
                                                0.5)]
    monkeypatch.setattr(tmap, "_restart_starts",
                        lambda *a: starts)
    p_t, info_t = tmap.fit_restarts(tp(P), t(X), t(y), restarts=3,
                                    scale=0.5, **kw)
    close(info_t["restart_lmls"], info_j["restart_lmls"], rtol=1e-4)
    assert info_t["best_restart"] == int(info_j["best_restart"])
    close(float(info_t["lml"]), float(info_j["lml"]), rtol=1e-4)
    _, info0 = tmap.fit(tp(P), t(X), t(y), **kw)
    assert float(info0["lml"]) == float(info_t["restart_lmls"][0])


def test_fit_restarts_starts_and_non_finite(data, monkeypatch):
    """Start 0 is the init exactly and the others differ from it, drawn
    reproducibly from the generator; a non-finite final never wins."""
    X, y, _, _ = data
    P = tp(init("rbf", 2))
    starts = tmap._restart_starts(P, 3, torch.Generator().manual_seed(0),
                                  0.5)
    again = tmap._restart_starts(P, 3, torch.Generator().manual_seed(0),
                                 0.5)
    for a, b in zip(tree_leaves(starts[0]), tree_leaves(P)):
        assert torch.equal(a, b)
    for s, s2 in zip(starts[1:], again[1:]):
        for a, b, c in zip(tree_leaves(s), tree_leaves(s2), tree_leaves(P)):
            assert torch.equal(a, b) and not torch.equal(a, c)
    real_fit = tmap.fit
    calls = []

    def fit_nan_first(p, *a, **kw):
        params, info = real_fit(p, *a, **kw)
        if not calls:
            info = dict(info, loss=torch.full_like(info["loss"], np.nan))
        calls.append(1)
        return params, info

    monkeypatch.setattr(tmap, "fit", fit_nan_first)
    _, info = tmap.fit_restarts(P, t(X), t(y), restarts=2, steps=2)
    assert info["best_restart"] == 1
    assert float(info["restart_lmls"][0]) == -np.inf


def test_weak_log_prior_and_map_fit_match_jax(data):
    """weak_log_prior's value and gradient, and a 5-step Adam MAP fit
    with it: loss trace and params at rtol 1e-4."""
    X, y, _, _ = data
    P = init("rq", 2)
    close(float(tmap.weak_log_prior(tp(P))), float(jmap.weak_log_prior(P)),
          rtol=1e-6)
    kw = dict(kind="rq", steps=5, learning_rate=0.05)
    p_j, info_j = jmap.fit(P, X, y, log_prior=jmap.weak_log_prior, **kw)
    p_t, info_t = tmap.fit(tp(P), t(X), t(y), log_prior=tmap.weak_log_prior,
                           **kw)
    close(info_t["loss"], info_j["loss"], rtol=1e-4)
    p_t = params_to_numpy(p_t)
    for k, v in p_j.items():
        close(p_t[k], v, rtol=1e-4)


@pytest.mark.parametrize("objective,basis", [("loo", None),
                                             ("lml", "linear")])
def test_fit_objectives_match_jax(data, objective, basis):
    """5 Adam steps on the LOO pseudo-likelihood and on the marginalized
    linear-basis LML: loss trace at rtol 1e-4 of its largest entry (the
    LOO objective crosses zero on the way) and params at rtol 1e-4."""
    X, y, _, _ = data
    P = init("rbf", 2)
    kw = dict(steps=5, learning_rate=0.05, objective=objective, basis=basis)
    p_j, info_j = jmap.fit(P, X, y, **kw)
    p_t, info_t = tmap.fit(tp(P), t(X), t(y), **kw)
    loss_j = np.asarray(info_j["loss"])
    close(info_t["loss"], loss_j, rtol=0, atol=1e-4 * np.abs(loss_j).max())
    p_t = params_to_numpy(p_t)
    for k, v in p_j.items():
        close(p_t[k], v, rtol=1e-4)


def test_objective_errors(data):
    X, y, _, _ = data
    P = tp(init("rbf", 2))
    with pytest.raises(NotImplementedError, match="zero-mean"):
        tmap.fit(P, t(X), t(y), steps=1, objective="loo", basis="linear")
    with pytest.raises(ValueError, match="objective"):
        tmap.fit(P, t(X), t(y), steps=1, objective="mse")
    with pytest.raises(ValueError, match="optimizer"):
        tmap.fit(P, t(X), t(y), steps=1, optimizer="sgd")


def test_fit_iterative_log_prior_matches_jax():
    """fit_iterative(log_prior=weak_log_prior) with frozen probes (the
    same z), split programs and a rank-16 preconditioner: the prior's
    value and gradient join the Hutchinson step as in JAX; loss trace at
    rtol 1e-4 and params within 1e-3."""
    rng = np.random.default_rng(0)
    X = (rng.uniform(-1.5, 1.5, (256, 3)) / np.sqrt(3) * 2.0).astype(
        np.float32)
    y = (np.sin(2.0 * X).sum(1) + 0.2 * rng.standard_normal(256)).astype(
        np.float32)
    P = jax.tree.map(np.asarray, jk.init_params(d=3, lengthscale=0.5,
                                                signal_var=0.5,
                                                noise_var=0.2))
    key = jax.random.key(5)
    z = np.asarray(jax.random.rademacher(key, (256, 4), dtype=jnp.float32))
    kw = dict(kind="rbf", steps=3, learning_rate=0.1, tol=1e-4,
              max_iters=200, num_probes=4, precond_rank=16,
              split_programs=True, probe_mode="frozen", warm_start=True)
    p_j, info_j = jmap.fit_iterative(P, jnp.asarray(X), jnp.asarray(y),
                                     key=key, block=128,
                                     log_prior=jmap.weak_log_prior, **kw)
    p_t, info_t = tmap.fit_iterative(tp(P), t(X), t(y), probes=t(z),
                                     log_prior=tmap.weak_log_prior, **kw)
    close(info_t["loss"], info_j["loss"], rtol=1e-4)
    p_t = params_to_numpy(p_t)
    for k, v in p_j.items():
        close(p_t[k], v, atol=1e-3)
    _, info_0 = tmap.fit_iterative(tp(P), t(X), t(y), probes=t(z), **kw)
    prior0 = float(tmap.weak_log_prior(tp(P)))
    close(float(info_t["loss"][0]), float(info_0["loss"][0]) - prior0,
          rtol=1e-6)


def _rosenbrock(x):
    return sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


LINESEARCH_CASES = {
    # a full step overshoots: the zoom phase interpolates
    "zoom": (_rosenbrock, [-1.2, 1.0, 0.5], -1.0),
    # a tiny step: the first phase doubles it until an interval is found
    "grow": (lambda x: sum((x - 3.0) ** 2), [0.0, 1.0], -0.01),
    # an ascent direction: every trial fails, and the search ends on the
    # last trial step (optax's "unsafe step")
    "ascent": (lambda x: sum(x ** 2), [1.0, -2.0], 1.0),
}


@pytest.mark.parametrize("case", sorted(LINESEARCH_CASES))
def test_zoom_linesearch_matches_optax(case):
    """The line search alone against optax.scale_by_zoom_linesearch
    (max_linesearch_steps=20, initial_guess_strategy="one") along d =
    scale * gradient: the same step size (rtol 1e-5) after the same number
    of trial points."""
    import optax

    from cugp_tpu_torch.inference import _lbfgs

    fn, x0, scale = LINESEARCH_CASES[case]
    x = jnp.asarray(x0, jnp.float32)
    value, grad = jax.value_and_grad(fn)(x)
    d = scale * grad
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
                                        initial_guess_strategy="one")
    upd, state = ls.update(d, ls.init(x), x, value=value, grad=grad,
                           value_fn=fn)
    eta_j = float(np.asarray(upd)[0] / np.asarray(d)[0])
    xt, dt = t(x), t(d)

    def phi(eta):
        p = (xt + eta * dt).requires_grad_(True)
        v = fn(p)
        (g,) = torch.autograd.grad(v, p)
        return torch.stack([v.detach(), torch.dot(g, dt)])

    eta_t, trials = _lbfgs.zoom_linesearch(phi, float(value),
                                           float(jnp.dot(grad, d)))
    assert trials == int(state.info.num_linesearch_steps)
    close(float(eta_t), eta_j, rtol=1e-5, atol=1e-7)
