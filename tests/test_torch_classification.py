"""The port's classification family against the JAX package (CPU): the
Laplace (logistic), EP (probit) and multiclass softmax-Laplace models'
marginal likelihoods, gradients (autograd through the Newton/EP loops,
as JAX differentiates its scans), predictives and short fits from the
same float32 inputs; the float64 oracles' copies; and the GPClassifier
facade with save/load across the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.models import gpc as jgpc
from cugp_tpu.models import gpc_ep as jep
from cugp_tpu.models import gpc_multiclass as jmc
from cugp_tpu.oracle import gpc_ep_np as jep_np
from cugp_tpu.oracle import gpc_multiclass_np as jmc_np
from cugp_tpu.oracle import gpc_np as jgpc_np

import cugp_tpu_torch
from cugp_tpu_torch.models import gpc, gpc_ep, gpc_multiclass
from cugp_tpu_torch.oracle import gpc_ep_np, gpc_multiclass_np, gpc_np
from cugp_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _params(d, lengthscale, signal_var):
    return {"log_lengthscale": np.full((d,), np.log(lengthscale), np.float32),
            "log_signal_var": np.float32(np.log(signal_var)),
            "log_noise_var": np.float32(np.log(1e-2))}


@pytest.fixture(scope="module")
def binary():
    """two_moons at n=80 (tests/test_gpc_ep.py's hyperparameters) and 30
    test points."""
    X, y = jsyn.two_moons(n=80, noise_std=0.2, seed=0)
    Xs = np.random.default_rng(1).uniform(-1.0, 2.0, (30, 2)).astype(
        np.float32)
    return dict(X=X, y=y, Xs=Xs, p_np=_params(2, 0.7, 2.0))


@pytest.fixture(scope="module")
def multi():
    """gaussian_blobs at n=48, three classes (tests/test_gpc_multiclass.py's
    problem), and 8 test points."""
    X, y = jsyn.gaussian_blobs(n=48, num_classes=3, seed=0)
    Y = np.eye(3, dtype=np.float32)[y]
    return dict(X=X, y=y, Y=Y, Xs=X[:8] + 0.2, p_np=_params(2, 0.9, 1.5))


MODELS = {
    "laplace": (jgpc, gpc, "laplace_lml"),
    "ep": (jep, gpc_ep, "ep_lml"),
}


def _value_and_grads(tmod, fn, p_np, *args):
    p = {k: v.requires_grad_(True) for k, v in
         params_from_numpy(p_np, "cpu").items()}
    val = getattr(tmod, fn)(p, *args)
    val.backward()
    return float(val.detach()), {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("model", ["laplace", "ep"])
def test_binary_lml_gradient_predict_match_jax(binary, model):
    """The marginal likelihood at 1e-4 relative, its gradient at 1e-3 of
    the largest component, the predictive probability, mean and variance
    at 1e-4 abs."""
    jmod, tmod, fn = MODELS[model]
    X, y, Xs, p_np = binary["X"], binary["y"], binary["Xs"], binary["p_np"]
    pj = jax.tree.map(jnp.asarray, p_np)
    vj, gj = jax.value_and_grad(lambda p: getattr(jmod, fn)(
        p, jnp.asarray(X), jnp.asarray(y)))(pj)
    vt, gt = _value_and_grads(tmod, fn, p_np, t(X), t(y))
    assert abs(vt - float(vj)) <= 1e-4 * abs(float(vj))
    g_j = np.concatenate([np.ravel(gj[k]) for k in p_np])
    g_t = np.concatenate([gt[k].numpy().ravel() for k in p_np])
    assert rel_to_max(g_t, g_j) <= 1e-3
    for a, b in zip(tmod.predict_proba(params_from_numpy(p_np, "cpu"), t(X),
                                       t(y), t(Xs)),
                    jmod.predict_proba(pj, jnp.asarray(X), jnp.asarray(y),
                                       jnp.asarray(Xs))):
        close(a, b, atol=1e-4)


def test_laplace_matches_float64_oracle(binary):
    """tests/test_gpc.py's bars against the float64 oracle (the port's
    copy): LML/n < 1e-3, probabilities atol 2e-3, mean/var 5e-3."""
    X, y, Xs, p_np = binary["X"], binary["y"], binary["Xs"], binary["p_np"]
    p = params_from_numpy(p_np, "cpu")
    ref = gpc_np.laplace_lml(p_np, X, y)
    assert abs(float(gpc.laplace_lml(p, t(X), t(y))) - ref) / len(y) < 1e-3
    for a, b, tol in zip(gpc.predict_proba(p, t(X), t(y), t(Xs)),
                         gpc_np.predict_proba(p_np, X, y, Xs),
                         (2e-3, 5e-3, 5e-3)):
        close(a, b, atol=tol)


def test_ep_matches_float64_oracle(binary):
    """tests/test_gpc_ep.py's bars: LML within 1e-3 max(1, |ref|) + 5e-3,
    probabilities, mean and variance within 2e-3."""
    X, y, Xs, p_np = binary["X"], binary["y"], binary["Xs"], binary["p_np"]
    p = params_from_numpy(p_np, "cpu")
    ref = gpc_ep_np.ep_lml(p_np, X, y)
    val = float(gpc_ep.ep_lml(p, t(X), t(y)))
    assert abs(val - ref) < 1e-3 * max(1.0, abs(ref)) + 5e-3
    for a, b in zip(gpc_ep.predict_proba(p, t(X), t(y), t(Xs)),
                    gpc_ep_np.predict_proba(p_np, X, y, Xs)):
        close(a, b, atol=2e-3)


def _jax_normals(num_samples, C):
    """The normals JAX's predict_proba draws from its default key(0)."""
    return np.asarray(jax.random.normal(jax.random.key(0), (num_samples, C),
                                        dtype=jnp.float32))


def test_multiclass_matches_jax(multi):
    """The softmax-Laplace LML at 1e-4 relative and its gradient at 1e-3
    of the largest component; predict_proba with JAX's own Monte Carlo
    normals handed in: probabilities, mean and covariance at 1e-4 abs."""
    X, Y, Xs, p_np = multi["X"], multi["Y"], multi["Xs"], multi["p_np"]
    pj = jax.tree.map(jnp.asarray, p_np)
    vj, gj = jax.value_and_grad(lambda p: jmc.laplace_lml(
        p, jnp.asarray(X), jnp.asarray(Y)))(pj)
    vt, gt = _value_and_grads(gpc_multiclass, "laplace_lml", p_np, t(X),
                              t(Y))
    assert abs(vt - float(vj)) <= 1e-4 * abs(float(vj))
    g_j = np.concatenate([np.ravel(gj[k]) for k in p_np])
    g_t = np.concatenate([gt[k].numpy().ravel() for k in p_np])
    assert rel_to_max(g_t, g_j) <= 1e-3
    out_j = jmc.predict_proba(pj, jnp.asarray(X), jnp.asarray(Y),
                              jnp.asarray(Xs))
    out_t = gpc_multiclass.predict_proba(
        params_from_numpy(p_np, "cpu"), t(X), t(Y), t(Xs),
        normals=_jax_normals(512, 3))
    for a, b in zip(out_t, out_j):
        close(a, b, atol=1e-4)
    close(out_t[0].sum(1), np.ones(8), atol=1e-5)
    with pytest.raises(ValueError, match="normals"):
        gpc_multiclass.predict_proba(params_from_numpy(p_np, "cpu"), t(X),
                                     t(Y), t(Xs), normals=np.zeros((4, 3)))


def test_multiclass_matches_float64_oracle(multi):
    """tests/test_gpc_multiclass.py's bars (30 Newton steps): LML within
    1e-3 max(1, |ref|), latent mean and covariance within 1e-3; the
    default normals (a CPU generator's) keep the probabilities within
    the JAX test's Monte Carlo bar (0.03) of the oracle's."""
    X, Y, Xs, p_np = multi["X"], multi["Y"], multi["Xs"], multi["p_np"]
    p = params_from_numpy(p_np, "cpu")
    ref = gpc_multiclass_np.laplace_lml(p_np, X, Y)
    val = float(gpc_multiclass.laplace_lml(p, t(X), t(Y), num_newton=30))
    assert abs(val - ref) < 1e-3 * max(1.0, abs(ref))
    mu64, sig64 = gpc_multiclass_np.latent_predictive(p_np, X, Y, Xs)
    probs, mu, sig = gpc_multiclass.predict_proba(p, t(X), t(Y), t(Xs),
                                                  num_newton=30,
                                                  num_samples=8192)
    close(mu, mu64, atol=1e-3)
    close(sig, sig64, atol=1e-3)
    p64, _, _ = gpc_multiclass_np.predict_proba(p_np, X, Y, Xs[:6],
                                                num_samples=40000)
    close(probs[:6], p64, atol=0.03)


@pytest.mark.parametrize("oracle", ["laplace", "ep", "multiclass"])
def test_oracle_copies_equal_the_jax_packages(binary, multi, oracle):
    """The port's float64 oracles are the JAX package's, bit for bit."""
    if oracle == "multiclass":
        args = (multi["p_np"], multi["X"], multi["Y"])
        pairs = [(gpc_multiclass_np.laplace_lml(*args),
                  jmc_np.laplace_lml(*args)),
                 (gpc_multiclass_np.latent_predictive(*args, multi["Xs"]),
                  jmc_np.latent_predictive(*args, multi["Xs"]))]
    else:
        tmod, jmod, fn = ((gpc_np, jgpc_np, "laplace_lml")
                          if oracle == "laplace"
                          else (gpc_ep_np, jep_np, "ep_lml"))
        args = (binary["p_np"], binary["X"], binary["y"])
        pairs = [(getattr(tmod, fn)(*args), getattr(jmod, fn)(*args)),
                 (tmod.predict_proba(*args, binary["Xs"]),
                  jmod.predict_proba(*args, binary["Xs"]))]
    for a, b in pairs:
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("model", ["laplace", "ep", "multiclass"])
def test_fits_match_jax(binary, multi, model):
    """Five Adam steps (lr 0.1) under apply_if_finite(100): losses at
    1e-4 relative, params within 1e-4."""
    if model == "multiclass":
        jmod, tmod = jmc, gpc_multiclass
        X, y, p_np = multi["X"], multi["Y"], multi["p_np"]
    else:
        jmod, tmod = MODELS[model][:2]
        X, y, p_np = binary["X"], binary["y"], binary["p_np"]
    pj, ij = jmod.fit(jax.tree.map(jnp.asarray, p_np), jnp.asarray(X),
                      jnp.asarray(y), steps=5, learning_rate=0.1)
    pt, it = tmod.fit(params_from_numpy(p_np, "cpu"), t(X), t(y), steps=5,
                      learning_rate=0.1)
    close(it["loss"], ij["loss"], rtol=1e-4)
    for k in p_np:
        close(pt[k], pj[k], atol=1e-4)


def test_classifier_facade_matches_jax_and_saves_across(binary, multi,
                                                        tmp_path):
    """GPClassifier on string labels (Laplace and EP) and on three integer
    classes: fit (3 steps), predict_proba (the multiclass one with JAX's
    normals) at 1e-4 and predict against the JAX facade; a port-saved
    classifier loads in the JAX package and a JAX-saved one in the port,
    with the same predictions."""
    Xs = binary["Xs"]
    labels = np.where(binary["y"] > 0, "b", "a")
    for inference in ("laplace", "ep"):
        c_j = cugp_tpu.GPClassifier(inference=inference)
        c_t = cugp_tpu_torch.GPClassifier(inference=inference, device="cpu")
        c_j.fit(binary["X"], labels, steps=3)
        c_t.fit(binary["X"], labels, steps=3)
        assert list(c_t.classes_) == ["a", "b"]
        close(c_t.predict_proba(Xs), c_j.predict_proba(Xs), atol=1e-4)
        assert (c_t.predict(Xs) == np.asarray(c_j.predict(Xs))).all()
        c_t.save(str(tmp_path / inference))
        back = cugp_tpu.GPClassifier.load(str(tmp_path / inference))
        assert back.inference == inference
        close(c_t.predict_proba(Xs), back.predict_proba(Xs), atol=1e-4)
    m_j = cugp_tpu.GPClassifier()
    m_j.fit(multi["X"], multi["y"] + 3, steps=3)
    m_j.save(str(tmp_path / "multi"))
    m_t = cugp_tpu_torch.GPClassifier.load(str(tmp_path / "multi"),
                                           device="cpu")
    assert list(m_t.classes_) == [3, 4, 5]
    normals = _jax_normals(512, 3)
    close(m_t.predict_proba(multi["Xs"], normals=normals),
          m_j.predict_proba(multi["Xs"]), atol=1e-4)
    assert (m_t.predict(multi["Xs"]) == np.asarray(
        m_j.predict(multi["Xs"]))).all()
    m_f = cugp_tpu_torch.GPClassifier(device="cpu")
    m_f.fit(multi["X"], multi["y"] + 3, steps=3)
    close(m_f.predict_proba(multi["Xs"], normals=normals),
          m_j.predict_proba(multi["Xs"]), atol=1e-4)


def test_classifier_routing_and_errors(multi):
    """EP is binary-only, one class is refused, an unknown inference is
    refused; GP.fit_classifier hands over kind, jitter and device."""
    with pytest.raises(ValueError, match="binary-only"):
        cugp_tpu_torch.GPClassifier(inference="ep", device="cpu").fit(
            multi["X"], multi["y"], steps=1)
    with pytest.raises(ValueError, match="at least 2 classes"):
        cugp_tpu_torch.GPClassifier(device="cpu").fit(
            multi["X"][:4], np.zeros(4), steps=1)
    with pytest.raises(ValueError, match="unknown inference"):
        cugp_tpu_torch.GPClassifier(inference="vb", device="cpu").fit(
            multi["X"][:6], np.arange(6) % 2, steps=1)
    gp = cugp_tpu_torch.GP(kind="matern52", jitter=1e-5, device="cpu")
    clf = gp.fit_classifier(multi["X"], multi["y"] == 1, steps=2)
    assert (clf.kind, clf.jitter, clf.device.type) == ("matern52", 1e-5,
                                                       "cpu")
    assert clf.predict(multi["X"][:5]).dtype == bool
