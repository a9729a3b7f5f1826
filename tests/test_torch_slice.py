"""The port's main path as a whole, against the JAX package (CPU).

GP.fit (Adam) -> GP.predict on the config-2 dataset at a small size,
the weights round trip, the data generators, and the import boundary
(the port never imports jax).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.ops import kernels as jk
from cugp_tpu.oracle import exact_gp_np as oracle

import cugp_tpu_torch
from cugp_tpu_torch.data import synthetic as tsyn
from cugp_tpu_torch.utils.params import params_from_numpy, params_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def config2():
    X, y, _ = jsyn.multidim_regression(n=512, d=4, seed=0)
    Xs = np.random.default_rng(1).uniform(-2.0, 2.0, (128, 4))
    return X, y, Xs


@pytest.fixture(scope="module")
def fitted(config2):
    """Both packages fit 5 Adam steps from the same default_init."""
    X, y, Xs = config2
    init = jax.tree.map(np.asarray, jk.default_init("rbf", d=4))
    gp_j = cugp_tpu.GP(kind="rbf")
    info_j = gp_j.fit(X, y, steps=5, learning_rate=0.05, init=init)
    gp_t = cugp_tpu_torch.GP(kind="rbf", device="cpu")
    info_t = gp_t.fit(X, y, steps=5, learning_rate=0.05, init=init)
    return gp_j, info_j, gp_t, info_t


def test_fit_matches_jax(fitted):
    """Loss trace and final params at rtol 1e-4."""
    gp_j, info_j, gp_t, info_t = fitted
    np.testing.assert_allclose(info_t["loss"].numpy(),
                               np.asarray(info_j["loss"]), rtol=1e-4)
    assert float(info_t["lml"]) == -float(info_t["loss"][-1])
    p_t = params_to_numpy(gp_t.params)
    for k, v in gp_j.params.items():
        np.testing.assert_allclose(p_t[k], np.asarray(v), rtol=1e-4)


def test_predict_matches_jax_and_oracle(fitted, config2):
    """The two packages agree at atol 1e-5; both sit within 1e-3 of the
    float64 oracle at the fitted params (BASELINE.json:5)."""
    X, y, Xs = config2
    gp_j, _, gp_t, _ = fitted
    mu_j, var_j = gp_j.predict(Xs)
    mu_t, var_t = gp_t.predict(Xs)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-5)
    p64 = jax.tree.map(lambda v: np.asarray(v, np.float64), gp_j.params)
    mu_o, var_o = oracle.posterior(p64, X, y, Xs, "rbf")
    for mu, var in ((mu_t.numpy(), var_t.numpy()),
                    (np.asarray(mu_j), np.asarray(var_j))):
        np.testing.assert_allclose(mu, mu_o, atol=1e-3)
        np.testing.assert_allclose(var, var_o, atol=1e-3)
    lml_t = float(gp_t.log_marginal_likelihood())
    lml_j = float(gp_j.log_marginal_likelihood())
    np.testing.assert_allclose(lml_t, lml_j, rtol=1e-5)


def test_predict_batches_and_full_cov(fitted, config2):
    """Batched predict equals one batch (atol 1e-5: other matmul shapes
    sum in another order); the full covariance's diagonal is the diagonal
    variance."""
    _, _, gp_t, _ = fitted
    _, _, Xs = config2
    mu, var = gp_t.predict(Xs)
    mu_b, var_b = gp_t.predict(Xs, batch=50)
    np.testing.assert_allclose(mu_b.numpy(), mu.numpy(), atol=1e-5)
    np.testing.assert_allclose(var_b.numpy(), var.numpy(), atol=1e-5)
    mu_f, cov = gp_t.predict(Xs[:40], full_cov=True)
    np.testing.assert_allclose(mu_f.numpy(), mu.numpy()[:40], atol=1e-5)
    np.testing.assert_allclose(np.diagonal(cov.numpy()), var.numpy()[:40],
                               atol=1e-5)


def test_normalize_y_and_condition_match_jax(config2):
    X, y, Xs = config2
    init = jax.tree.map(np.asarray, jk.default_init("matern52", d=4))
    gp_j = cugp_tpu.GP(kind="matern52", normalize_y=True).condition(
        X, 3.0 * y + 2.0, params=init)
    gp_t = cugp_tpu_torch.GP(kind="matern52", normalize_y=True,
                             device="cpu").condition(X, 3.0 * y + 2.0,
                                                     params=init)
    np.testing.assert_allclose(float(gp_t.log_marginal_likelihood()),
                               float(gp_j.log_marginal_likelihood()),
                               rtol=1e-5)
    mu_j, var_j = gp_j.predict(Xs, include_noise=True)
    mu_t, var_t = gp_t.predict(Xs, include_noise=True)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-4)


def test_unported_options_raise():
    """What stays unported raises: the JAX package's XLA routes, an
    unknown kernel kind."""
    with pytest.raises(ValueError):
        cugp_tpu_torch.GP(kind="rbf", method="xla")
    with pytest.raises(ValueError):
        cugp_tpu_torch.GP(kind="banana")


@pytest.mark.parametrize("kind", ["rbf", "rq", "periodic", "linear",
                                  "rbf*periodic+linear"])
def test_params_round_trip(kind):
    """JAX params tree -> port tensors -> numpy keeps nesting and bits."""
    tree = jax.tree.map(np.asarray, jk.default_init(kind, d=3))
    pt = params_from_numpy(tree, "cpu")
    assert jax.tree.structure(pt) == jax.tree.structure(tree)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(pt))
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    ported = cugp_tpu_torch.ops.kernels.default_init(kind, d=3)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ported)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", [
    ("sinusoid_1d", dict(n=300, seed=4)),
    ("multidim_regression", dict(n=500, d=3, seed=2))])
def test_synthetic_is_bit_identical(name, kw):
    for a, b in zip(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import cugp_tpu_torch, cugp_tpu_torch.api\n"
            "import cugp_tpu_torch.models.exact_gp, "
            "cugp_tpu_torch.inference.map_opt\n"
            "import cugp_tpu_torch.ops.cholesky, cugp_tpu_torch.ops.trsm\n"
            "import cugp_tpu_torch.ops.kernels, cugp_tpu_torch.ops._build\n"
            "import cugp_tpu_torch.data.synthetic\n"
            "import cugp_tpu_torch.oracle.exact_gp_np, "
            "cugp_tpu_torch.utils.checkpoint\n"
            "import cugp_tpu_torch.inference._lbfgs\n"
            "import cugp_tpu_torch.inference.hmc, "
            "cugp_tpu_torch.inference.nuts\n"
            "import cugp_tpu_torch.inference.sampling, "
            "cugp_tpu_torch.inference.vi\n"
            "import cugp_tpu_torch.models.sgpr, cugp_tpu_torch.models.svgp\n"
            "import cugp_tpu_torch.models.gpc, cugp_tpu_torch.models.gpc_ep\n"
            "import cugp_tpu_torch.models.gpc_multiclass\n"
            "import cugp_tpu_torch.oracle.gpc_np, "
            "cugp_tpu_torch.oracle.gpc_ep_np\n"
            "import cugp_tpu_torch.oracle.gpc_multiclass_np\n"
            "import cugp_tpu_torch.models.lmc, cugp_tpu_torch.oracle.lmc_np\n"
            "from cugp_tpu_torch import MultiOutputGP, MultiOutputGPQ\n"
            "import cugp_tpu_torch.runtime\n"
            "import cugp_tpu_torch.parallel.collectives, "
            "cugp_tpu_torch.parallel.mesh\n"
            "import cugp_tpu_torch.parallel.ring, "
            "cugp_tpu_torch.parallel.relayout\n"
            "import cugp_tpu_torch.parallel.distributed_chol, "
            "cugp_tpu_torch.parallel.block_cyclic\n"
            "import cugp_tpu_torch.parallel.gspmd, "
            "cugp_tpu_torch.parallel.sharded_sampling\n"
            "import cugp_tpu_torch.parallel.sp_iterative\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'cugp_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
