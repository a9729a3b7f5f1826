"""Parity of the port's exact-GP model with the JAX package and goldens.

The same float32 inputs (sinusoid_1d, seeded numpy) go through
cugp_tpu.models.exact_gp and cugp_tpu_torch.models.exact_gp; the port
runs on CPU tensors, i.e. through its kernels' plain versions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.data import synthetic
from cugp_tpu.models import exact_gp as jgp
from cugp_tpu.ops import kernels as jk
from cugp_tpu_torch.models import exact_gp as tgp
from cugp_tpu_torch.ops import cholesky as tchol
from cugp_tpu_torch.ops import kernels as tk
from cugp_tpu_torch.ops import trsm as ttrsm
from cugp_tpu_torch.utils.params import params_from_numpy, sorted_leaves

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                       "exact_gp_sinusoid256.npz")
KINDS = ["rbf", "matern32", "rq", "periodic"]


def np_params(kind):
    """Hyperparameters at which the fp32 floor sits below the bars:
    cond(K) stays near 1e3, and the periodic phase 2 pi x / p stays under
    2.5 rad, where the two frameworks' cos/sin agree to an ulp (at p = 2.1
    the phase reaches 9 rad and both packages drift from the float64
    oracle by ~5e-4 in the posterior mean, each in its own direction)."""
    p = {"log_lengthscale": np.array([np.log(0.5)], np.float32),
         "log_signal_var": np.array(np.log(1.2), np.float32),
         "log_noise_var": np.array(np.log(0.2), np.float32)}
    if kind == "rq":
        p["log_alpha"] = np.array(np.log(1.5), np.float32)
    if kind == "periodic":
        p["log_period"] = np.array([np.log(8.0)], np.float32)
    return p


@pytest.fixture(scope="module")
def data():
    X, y, _ = synthetic.sinusoid_1d(n=256, noise_std=0.1, seed=1)
    Xs = np.linspace(-3.2, 3.2, 50)[:, None]
    return (X.astype(np.float32), y.astype(np.float32),
            Xs.astype(np.float32))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_lml_and_gradient_match_jax(data, kind):
    """LML at rtol 1e-5, its gradient at rtol 1e-4."""
    X, y, _ = data
    P = np_params(kind)
    val_j, g_j = jgp.lml_value_and_grad(P, jnp.asarray(X), jnp.asarray(y),
                                        kind=kind)
    val_t, g_t = tgp.lml_value_and_grad(params_from_numpy(P, "cpu"), _t(X),
                                        _t(y), kind=kind)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-5)
    assert float(tgp.log_marginal_likelihood(
        params_from_numpy(P, "cpu"), _t(X), _t(y), kind=kind)) == float(val_t)
    for k in P:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_posterior_matches_jax(data, kind):
    """Diagonal and full posteriors at atol 1e-5."""
    X, y, Xs = data
    P = np_params(kind)
    Pt = params_from_numpy(P, "cpu")
    mu_j, var_j = jgp.posterior(P, jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(Xs), kind=kind)
    mu_t, var_t = tgp.posterior(Pt, _t(X), _t(y), _t(Xs), kind=kind)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-5)
    mu_j, cov_j = jgp.posterior_full_cov(P, jnp.asarray(X), jnp.asarray(y),
                                         jnp.asarray(Xs[:20]), kind=kind)
    mu_t, cov_t = tgp.posterior_full_cov(Pt, _t(X), _t(y), _t(Xs[:20]),
                                         kind=kind)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), atol=1e-5)


@pytest.fixture(scope="module")
def golden():
    return np.load(_GOLDEN)


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52",
                                  "rq"])
def test_goldens(golden, kind):
    """The float64-oracle goldens at the bars of tests/test_goldens.py."""
    P = {k: golden[k] for k in ("log_lengthscale", "log_signal_var",
                                "log_noise_var")}
    if kind == "rq":
        P["log_alpha"] = golden["log_alpha"]
    Pt = params_from_numpy(P, "cpu")
    X, y, Xs = _t(golden["X"]), _t(golden["y"]), _t(golden["Xs"])
    val, g = tgp.lml_value_and_grad(Pt, X, y, kind=kind)
    assert abs(float(val) - float(golden[f"lml_{kind}"])) / len(y) < 1e-3
    mu, var = tgp.posterior(Pt, X, y, Xs, kind=kind)
    np.testing.assert_allclose(mu.numpy(), golden[f"mu_{kind}"], atol=1e-3)
    np.testing.assert_allclose(var.numpy(), golden[f"var_{kind}"], atol=1e-3)
    for key, name in (("log_lengthscale", "ell"), ("log_signal_var", "sf"),
                      ("log_noise_var", "sn")):
        np.testing.assert_allclose(g[key].numpy(),
                                   golden[f"grad_{name}_{kind}"],
                                   rtol=5e-2, atol=5e-2)
    if kind == "rq":
        np.testing.assert_allclose(float(g["log_alpha"]),
                                   float(golden["grad_alpha_rq"]),
                                   rtol=5e-2, atol=5e-2)


def test_padding_invariance():
    """n_true: zero-padded rows become an identity block, so the padded
    LML and posterior equal the unpadded ones (the bars of
    tests/integration/test_exact_gp.py::test_padding_invariance)."""
    X, y, _ = synthetic.sinusoid_1d(n=100, seed=3)
    Xp, yp = synthetic.pad_dataset(X, y, 128)
    Pt = params_from_numpy(np_params("rbf"), "cpu")
    lml = float(tgp.log_marginal_likelihood(Pt, _t(X), _t(y)))
    lml_pad = float(tgp.log_marginal_likelihood(Pt, _t(Xp), _t(yp),
                                                n_true=100))
    assert abs(lml_pad - lml) < 1e-3, (lml_pad, lml)
    Xs = _t(np.linspace(-3, 3, 33)[:, None])
    mu, var = tgp.posterior(Pt, _t(X), _t(y), Xs)
    mu_p, var_p = tgp.posterior(Pt, _t(Xp), _t(yp), Xs, n_true=100)
    np.testing.assert_allclose(mu_p.numpy(), mu.numpy(), atol=1e-4)
    np.testing.assert_allclose(var_p.numpy(), var.numpy(), atol=1e-4)


def test_safe_cholesky_recovers_from_nonpd():
    """The jitter ladder rescues a barely-PD fp32 covariance (the port's
    twin of tests/integration/test_exact_gp.py's test of that name)."""
    rng = np.random.default_rng(0)
    X = _t(rng.uniform(-1, 1, (300, 2)))
    p = {"log_lengthscale": torch.tensor([5.0, 5.0]),
         "log_signal_var": torch.tensor(0.0),
         "log_noise_var": torch.tensor(-25.0)}
    K = tk.train_covariance(p, X, jitter=0.0)
    L_plain = tchol.cholesky(K)
    assert not bool(torch.isfinite(L_plain).all()), "expected chol to fail"
    L_safe = tgp.safe_cholesky(K, torch.exp(p["log_signal_var"]))
    assert bool(torch.isfinite(torch.diagonal(L_safe)).all())
    y = _t(rng.standard_normal(300))
    val = tgp.log_marginal_likelihood(p, X, y, jitter=0.0)
    assert np.isfinite(float(val))


def _murray_lml(params, X, y, kind, n_true=None):
    """The LML through Murray's route: autograd through the Cholesky's
    and the solves' own rules, the ladder included (the composition
    log_marginal_likelihood had before its closed-form backward)."""
    K = tk.train_covariance(params, X, kind=kind, n_true=n_true)
    L = tgp.safe_cholesky(K, tk.signal_scale(params))
    if L.ndim == 3:
        y = y.expand(L.shape[0], -1)
    alpha = ttrsm.cho_solve(L, y)
    n = n_true if n_true is not None else y.shape[-1]
    return (-0.5 * torch.sum(y * alpha, dim=-1)
            - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                        dim=-1) - 0.5 * n * tgp.LOG2PI)


def _grads(fn, P):
    """The gradient of fn's sum over P's leaves, in jax's leaf order."""
    leaves = sorted_leaves(P)
    for t in leaves:
        t.requires_grad_(True)
    return [g.numpy() for g in torch.autograd.grad(fn(P).sum(), leaves)]


def _assert_grads(got, want):
    """rtol 1e-4 per entry, atol 1e-4 of the whole gradient's largest
    entry (a leaf near its optimum reads a small difference of large
    terms)."""
    scale = max(float(np.abs(w).max()) for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * scale)


# (kind, n, batch, n_true): n = 1500 recurses past the base size
BACKWARD_CASES = {
    "rbf": ("rbf", 256, None, None),
    "matern32": ("matern32", 256, None, None),
    "periodic": ("periodic", 256, None, None),
    "composite": ("rbf*periodic+matern32", 256, None, None),
    "matern32_1500": ("matern32", 1500, None, None),
    "rbf_batched": ("rbf", 256, 3, None),
    "matern32_padded": ("matern32", 256, None, 200),
}


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_lml_closed_form_backward_matches_three_references(case):
    """log_marginal_likelihood's backward, 1/2 (alpha alpha^T - A^{-1})
    from the saved factor, against autograd through Murray's route, the
    analytic gradient (base kinds) and jax.grad of the JAX package's LML.
    A batch is held element by element to the two 2-D references; the
    padded data (n_true) to the analytic gradient of the unpadded rows."""
    kind, n, batch, n_true = BACKWARD_CASES[case]
    X, y, _ = synthetic.sinusoid_1d(n=n_true or n, noise_std=0.1, seed=1)
    if n_true is not None:
        X, y = synthetic.pad_dataset(X, y, n)
    X, y = X.astype(np.float32), y.astype(np.float32)
    P = (jax.tree.map(lambda v: np.asarray(v, np.float32),
                      jk.default_init(kind, d=1))
         if tk.is_composite(kind) else np_params(kind))
    if batch is not None:
        rng = np.random.default_rng(2)
        P = jax.tree.map(lambda v: (v[None] + rng.uniform(
            -0.3, 0.3, (batch,) + np.shape(v))).astype(np.float32), P)
    elements = [jax.tree.map(lambda v, b=b: v[b], P)
                for b in range(batch or 1)] if batch else [P]

    got = _grads(lambda p: tgp.log_marginal_likelihood(
        p, _t(X), _t(y), kind=kind, n_true=n_true),
        params_from_numpy(P, "cpu"))
    _assert_grads(got, _grads(lambda p: _murray_lml(
        p, _t(X), _t(y), kind, n_true=n_true), params_from_numpy(P, "cpu")))
    for b, Pb in enumerate(elements):
        got_b = [g[b] for g in got] if batch else got
        want = jax.tree.leaves(jax.grad(lambda p: jgp.log_marginal_likelihood(
            p, jnp.asarray(X), jnp.asarray(y), kind=kind, n_true=n_true))(
                Pb))
        _assert_grads(got_b, want)
        if not tk.is_composite(kind):
            m = n_true or n
            an = tgp.lml_gradients_analytic(params_from_numpy(Pb, "cpu"),
                                            _t(X[:m]), _t(y[:m]), kind=kind)
            _assert_grads(got_b, [t.numpy() for t in sorted_leaves(an)])


def test_lml_closed_form_backward_through_a_ladder_retry(monkeypatch):
    """A first factor forced non-finite: the ladder factors K + jitter I
    again, and the closed form's A (that matrix) carries the jitter's
    gradient to log_signal_var as Murray's route does (JAX's ladder
    gives NaN there, and the analytic gradient leaves the jitter out)."""
    X, y, _ = synthetic.sinusoid_1d(n=256, noise_std=0.1, seed=1)
    X, y = _t(X.astype(np.float32)), _t(y.astype(np.float32))
    P = np_params("matern32")
    real = tchol.cholesky
    calls = []

    def first_fails(a, method="auto", precision=None):
        calls.append(a.shape)
        l = real(a, method=method, precision=precision)
        return l * float("nan") if len(calls) == 1 else l

    monkeypatch.setattr(tchol, "cholesky", first_fails)
    got = _grads(lambda p: tgp.log_marginal_likelihood(
        p, X, y, kind="matern32"), params_from_numpy(P, "cpu"))
    assert len(calls) == 2
    calls.clear()
    want = _grads(lambda p: _murray_lml(p, X, y, "matern32"),
                  params_from_numpy(P, "cpu"))
    assert len(calls) == 2
    _assert_grads(got, want)
    monkeypatch.setattr(tchol, "cholesky", real)
    plain = _grads(lambda p: tgp.log_marginal_likelihood(
        p, X, y, kind="matern32"), params_from_numpy(P, "cpu"))
    # the retry's jitter (1e-4 sf2) moves the gradient
    assert not all(np.array_equal(a, b) for a, b in zip(got, plain))
