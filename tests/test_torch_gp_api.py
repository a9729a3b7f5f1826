"""The port's GP facade beyond fit/predict, against the JAX package (CPU):
explicit bases, LOO, L-BFGS and restarts through GP.fit, posterior
draws, save/load in both directions between the packages, the
checkpoint module, the synthetic generators and the oracle copy.
"""

import jax
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.ops import kernels as jk
from cugp_tpu.oracle import exact_gp_np as joracle

import cugp_tpu_torch
from cugp_tpu_torch.data import synthetic as tsyn
from cugp_tpu_torch.oracle import exact_gp_np as toracle
from cugp_tpu_torch.utils import checkpoint
from cugp_tpu_torch.utils.params import params_to_numpy

torch.set_num_threads(1)


def close(got, want, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def init(kind, d, **kw):
    return jax.tree.map(np.asarray, jk.default_init(kind, d=d, **kw))


@pytest.fixture(scope="module")
def data():
    """Config-2 data (multidim_regression) at n=160, d=3, and 30 test
    points, in float64 as a user passes them."""
    X, y, _ = jsyn.multidim_regression(n=160, d=3, seed=2)
    Xs = np.random.default_rng(3).uniform(-2.0, 2.0, (30, 3))
    return X, y, Xs


def test_gp_basis_fit_predict_match_jax(data):
    """GP(basis="linear").fit (5 Adam steps), the LML, predict (diagonal,
    with noise, and full covariance) and beta at rtol 1e-4 / atol 1e-5."""
    X, y, Xs = data
    gp_j = cugp_tpu.GP(kind="rbf", basis="linear")
    gp_t = cugp_tpu_torch.GP(kind="rbf", basis="linear", device="cpu")
    info_j = gp_j.fit(X, y, steps=5, init=init("rbf", 3))
    info_t = gp_t.fit(X, y, steps=5, init=init("rbf", 3))
    close(info_t["loss"], info_j["loss"], rtol=1e-4)
    close(float(gp_t.log_marginal_likelihood()),
          float(gp_j.log_marginal_likelihood()), rtol=1e-5)
    for kw in ({}, {"include_noise": True}, {"full_cov": True}):
        for a, b in zip(gp_t.predict(Xs[:20], **kw),
                        gp_j.predict(Xs[:20], **kw)):
            close(a, b, atol=1e-5)
        close(gp_t.beta, gp_j.beta, atol=1e-5)
    with pytest.raises(NotImplementedError, match="zero-mean"):
        gp_t.loo()
    with pytest.raises(ValueError, match="basis"):
        cugp_tpu_torch.GP(basis="cubic", device="cpu")


def test_gp_loo_matches_jax(data):
    """GP.loo with normalize_y (the logp correction by log sigma_y):
    mean atol 1e-5 on the standardized scale (times y_std in y units),
    var rtol 1e-4, logp atol 1e-4."""
    X, y, _ = data
    P = init("matern32", 3)
    gp_j = cugp_tpu.GP(kind="matern32", normalize_y=True).condition(
        X, 5.0 * y + 1.0, params=P)
    gp_t = cugp_tpu_torch.GP(kind="matern32", normalize_y=True,
                             device="cpu").condition(X, 5.0 * y + 1.0,
                                                     params=P)
    r_j, r_t = gp_j.loo(), gp_t.loo()
    close(r_t["mean"], r_j["mean"], atol=1e-5 * gp_j.y_std)
    close(r_t["var"], r_j["var"], rtol=1e-4)
    close(r_t["logp"], r_j["logp"], atol=1e-4)
    close(float(r_t["pseudo_likelihood"]), float(r_j["pseudo_likelihood"]),
          rtol=1e-5)


def test_gp_fit_lbfgs_restarts_and_prior(data):
    """GP.fit routes optimizer="lbfgs", log_prior and objective to
    map_opt.fit, and restarts > 1 to map_opt.fit_restarts with the
    caller's generator."""
    from cugp_tpu_torch.inference import map_opt

    X, y, _ = data
    P = init("rbf", 3)
    gp = cugp_tpu_torch.GP(kind="rbf", device="cpu")
    info = gp.fit(X, y, steps=3, optimizer="lbfgs", init=P,
                  log_prior=map_opt.weak_log_prior)
    Xt, yt = gp.X, gp.y
    _, want = map_opt.fit(gp._params(P), Xt, yt, steps=3,
                          optimizer="lbfgs",
                          log_prior=map_opt.weak_log_prior)
    assert torch.equal(info["loss"], want["loss"])
    info = gp.fit(X, y, steps=3, restarts=3, init=P,
                  generator=torch.Generator().manual_seed(7))
    _, want = map_opt.fit_restarts(gp._params(P), Xt, yt, steps=3,
                                   restarts=3,
                                   generator=torch.Generator().manual_seed(7))
    assert torch.equal(info["restart_lmls"], want["restart_lmls"])
    assert info["best_restart"] == want["best_restart"]
    finals = info["restart_lmls"]
    assert float(info["lml"]) == float(finals.max())


def test_sample_posterior_matches_jax_draws(data):
    """With JAX's standard normals passed in, the draws agree at atol
    1e-4; drawn from a generator, they pass tests/test_api.py's
    statistical bounds against predict."""
    X, y, Xs = data
    P = init("rbf", 3)
    gp_j = cugp_tpu.GP(kind="rbf").condition(X, y, params=P)
    gp_t = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(X, y,
                                                                 params=P)
    f_j = gp_j.sample_posterior(Xs, num_samples=16, key=jax.random.key(3))
    eps = jax.random.normal(jax.random.key(3), (len(Xs), 16), np.float32)
    f_t = gp_t.sample_posterior(Xs, num_samples=16, draws=np.asarray(eps))
    assert f_t.shape == (16, len(Xs))
    close(f_t, f_j, atol=1e-4)
    with pytest.raises(ValueError, match="draws"):
        gp_t.sample_posterior(Xs, num_samples=8, draws=np.asarray(eps))
    draws = gp_t.sample_posterior(
        Xs, num_samples=64, generator=torch.Generator().manual_seed(3))
    mu, var = (a.numpy() for a in gp_t.predict(Xs))
    sd = np.sqrt(var + 1e-6)
    err = np.abs(draws.numpy().mean(axis=0) - mu)
    assert np.all(err <= 5.0 * sd / np.sqrt(64) + 1e-3), err.max()
    ratio = draws.numpy().var(axis=0) / (var + 1e-6)
    assert np.all((ratio > 0.3) & (ratio < 3.0)), (ratio.min(), ratio.max())
    again = gp_t.sample_posterior(
        Xs, num_samples=64, generator=torch.Generator().manual_seed(3))
    assert torch.equal(draws, again)


def _leaves_equal(tree_t, tree_j):
    for a, b in zip(jax.tree.leaves(params_to_numpy(tree_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, tree_j))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["rbf", "rq", "rbf*periodic+linear"])
def test_checkpoint_crosses_packages(kind, tmp_path):
    """cugp_tpu.GP.save -> cugp_tpu_torch.GP.load and the reverse: params,
    X and y bitwise, the normalize_y stats kept; the loaded port model
    predicts bitwise as one conditioned on the same arrays, and the two
    packages' predictions agree at atol 1e-5 on the standardized scale
    (times y_std, y_std^2 in y units). noise_var = 0.3 keeps cond(K) low
    enough for that bar on the composite."""
    X, y, _ = jsyn.multidim_regression(n=96, d=2, seed=2)
    Xs = np.random.default_rng(3).uniform(-2.0, 2.0, (30, 2))
    P = jax.tree.map(lambda v: v + np.float32(0.1),
                     init(kind, 2, noise_var=0.3))
    gp_j = cugp_tpu.GP(kind=kind, normalize_y=True).condition(X, 2.0 * y,
                                                              params=P)
    gp_j.save(str(tmp_path / "jax"))
    gp_t = cugp_tpu_torch.GP.load(str(tmp_path / "jax"), device="cpu")
    assert gp_t.device.type == "cpu" and gp_t.kind == kind
    assert (gp_t.normalize_y, gp_t.y_mean, gp_t.y_std) == (
        True, gp_j.y_mean, gp_j.y_std)
    _leaves_equal(gp_t.params, gp_j.params)
    assert np.array_equal(gp_t.X.numpy(), np.asarray(gp_j.X))
    assert np.array_equal(gp_t.y.numpy(), np.asarray(gp_j.y))
    direct = cugp_tpu_torch.GP(kind=kind, device="cpu").condition(
        np.asarray(gp_j.X), np.asarray(gp_j.y), params=gp_j.params)
    mu_t, var_t = gp_t.predict(Xs)
    mu_d, var_d = direct.predict(Xs)
    assert torch.equal(mu_t, gp_t._out_mean(mu_d))
    assert torch.equal(var_t, gp_t._out_var(var_d))
    s = gp_j.y_std
    for a, b, unit in zip((mu_t, var_t), gp_j.predict(Xs), (s, s * s)):
        close(a, b, atol=1e-5 * unit)

    gp_t.save(str(tmp_path / "torch"))
    gp_j2 = cugp_tpu.GP.load(str(tmp_path / "torch"))
    _leaves_equal(gp_t.params, gp_j2.params)
    assert np.array_equal(gp_t.X.numpy(), np.asarray(gp_j2.X))
    assert np.array_equal(gp_t.y.numpy(), np.asarray(gp_j2.y))
    assert (gp_j2.y_mean, gp_j2.y_std) == (gp_t.y_mean, gp_t.y_std)
    for a, b, unit in zip(gp_t.predict(Xs), gp_j2.predict(Xs), (s, s * s)):
        close(a, b, atol=1e-5 * unit)


def test_save_load_round_trip_in_the_port(data, tmp_path):
    """A port save/load keeps the basis and predicts bitwise the same;
    saving over a checkpoint replaces it."""
    X, y, Xs = data
    gp = cugp_tpu_torch.GP(kind="matern52", basis="constant",
                           device="cpu").condition(X, y,
                                                   params=init("matern52", 3))
    path = str(tmp_path / "gp")
    gp.save(path)
    gp.save(path)
    back = cugp_tpu_torch.GP.load(path, device="cpu")
    assert back.basis == "constant"
    for a, b in zip(back.predict(Xs), gp.predict(Xs)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        cugp_tpu_torch.GP.load(str(tmp_path / "missing"), device="cpu")


def test_checkpoint_order_old_fallback_and_leaf_count(tmp_path):
    """Leaves are numbered in jax's tree order; restore falls back on the
    `.old` copy a crash mid-swap leaves; a leaf-count mismatch raises."""
    tree = {"b": [np.arange(3.0), {"z": np.ones(2), "a": np.zeros(1)}],
            "a": torch.tensor([7.0])}
    path = str(tmp_path / "ck")
    checkpoint.save(path, tree, step=4, extra_json={"k": 1})
    blob = np.load(path + "/arrays.npz")
    leaves = jax.tree.leaves(jax.tree.map(np.asarray, {
        "b": tree["b"], "a": tree["a"].numpy()}))
    for i, leaf in enumerate(leaves):
        assert np.array_equal(blob[f"leaf_{i}"], leaf)
    got, meta = checkpoint.restore(path, tree)
    assert meta["step"] == 4 and meta["extra"] == {"k": 1}
    assert list(got) == ["b", "a"] and list(got["b"][1]) == ["z", "a"]
    assert np.array_equal(got["b"][1]["z"], np.ones(2))
    import os

    os.rename(path, path + ".old")
    assert checkpoint.peek_meta(path)["num_leaves"] == 4
    got, _ = checkpoint.restore(path, tree)
    assert np.array_equal(got["a"], np.array([7.0], np.float32))
    assert checkpoint.restore(str(tmp_path / "none"), tree) == (None, None)
    assert checkpoint.peek_meta(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, {"a": 0})


def test_gp_draw_and_pad_dataset_are_bit_identical():
    for kw in (dict(n=64, d=2, seed=1), dict(n=48, d=3, seed=2,
                                             kind="matern32")):
        X_t, y_t, p_t = tsyn.gp_draw(**kw)
        X_j, y_j, p_j = jsyn.gp_draw(**kw)
        assert np.array_equal(X_t, X_j) and np.array_equal(y_t, y_j)
        for k in p_j:
            assert np.array_equal(p_t[k], p_j[k])
    X, y, _ = jsyn.multidim_regression(n=50, d=2, seed=0)
    for a, b in zip(tsyn.pad_dataset(X, y, 64), jsyn.pad_dataset(X, y, 64)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tsyn.pad_dataset(X, y, 10)


def _oracle_cases():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (40, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(40)
    Xs = rng.uniform(-2, 2, (9, 2))
    comp = "rbf*periodic+linear"
    P = {k: jax.tree.map(lambda v: np.asarray(v, np.float64) + 0.1,
                         jk.default_init(k, d=2))
         for k in ("rbf", "matern12", "rq", "periodic", "linear", comp)}
    return [
        ("kernel_matrix", (P[comp], X, Xs, comp)),
        ("kernel_matrix", (P["matern12"], X, Xs, "matern12")),
        ("kernel_diag", (P[comp], X, comp)),
        ("train_covariance", (P["rq"], X, "rq")),
        ("log_marginal_likelihood", (P["periodic"], X, y, "periodic")),
        ("loo_cv", (P["rbf"], X, y, "rbf")),
        ("posterior", (P["linear"], X, y, Xs, "linear", 1e-6, True)),
        ("log_marginal_likelihood_basis", (P["rbf"], X, y, "rbf")),
        ("posterior_basis", (P["rq"], X, y, Xs, "rq", 1e-6, "constant")),
        ("posterior_basis_full_cov", (P["rbf"], X, y, Xs)),
        ("lml_gradients", (P["rq"], X, y, "rq")),
        ("lml_gradients", (P["periodic"], X, y, "periodic")),
        ("lml_gradients", (P["linear"], X, y, "linear")),
    ]


@pytest.mark.parametrize("case", range(13))
def test_oracle_copy_matches_original(case):
    """The port's copy of the float64 oracle, function by function, at
    rtol 1e-12 against the JAX package's."""
    name, args = _oracle_cases()[case]
    got = getattr(toracle, name)(*args)
    want = getattr(joracle, name)(*args)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
