"""The plain reference agrees with the program's CPU path at tiny sizes,
and imports nothing of the program. (This test imports both; the
reference itself may not.)"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest
import torch

from portbench import data, driving
from portbench.reference import adam, matern32

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def problem():
    gen = data.generator("cpu", 11)
    X, y = data.matern32_draw(200, 3, 1.5, 1.0, 0.04, gen, "cpu",
                              features=1024)
    p = driving.log_params(3, [0.8, 1.1, 1.7], 0.9, 0.07, "cpu")
    return X, y, p


def test_lml_and_gradient_match_the_program(problem):
    from cugp_tpu_torch.models import exact_gp

    X, y, p = problem
    lml, g = matern32.lml_and_grad(X, y, p, 1e-6, block=64)
    lml_p, g_p = exact_gp.lml_value_and_grad(p, X, y, kind="matern32",
                                            jitter=1e-6)
    assert lml == pytest.approx(float(lml_p), rel=1e-5)
    for k in g:
        torch.testing.assert_close(g[k].float(), g_p[k], rtol=1e-3,
                                   atol=1e-3)


def test_posterior_matches_the_program(problem):
    import cugp_tpu_torch

    X, y, p = problem
    Xt = data.uniform_inputs(50, 3, data.generator("cpu", 5), "cpu").float()
    gp = cugp_tpu_torch.GP(kind="matern32", device="cpu").condition(X, y, p)
    mu_p, var_p = gp.predict(Xt)
    L, a, _ = matern32.factor(X, y, p, 1e-6, block=64)
    mu, var = matern32.posterior(L, a, X, p, Xt, chunk=16)
    torch.testing.assert_close(mu.float(), mu_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(var.float(), var_p, rtol=0, atol=1e-4)


def test_estimator_gradient_and_residual_match_the_program(problem):
    from cugp_tpu_torch.inference import iterative

    X, y, p = problem
    z = data.rademacher(200, 4, data.generator("cpu", 6), "cpu")
    K = matern32.covariance(X, p, 1e-6, block=64)
    sol = torch.linalg.solve(K, torch.cat([y[:, None], z], 1).double())
    a, w = sol[:, 0].float(), sol[:, 1:].float()
    g_p = iterative.hutchinson_grads_program(p, X, a, w, z, kind="matern32",
                                             jitter=1e-6, block=64)
    g = matern32.estimator_grad(X, p, 1e-6, a, w, z, block=64)
    for k in g:
        torch.testing.assert_close(g[k].float(), g_p[k], rtol=1e-3,
                                   atol=1e-3)
    rhs = torch.cat([y[:, None], z], 1)
    res = matern32.relative_residuals(X, p, 1e-6, sol, rhs, block=64)
    assert float(res.max()) < 1e-10


def test_adam_matches_torch_adam():
    p0 = {"a": torch.tensor([0.5, -1.0], dtype=torch.float64)}

    def loss_and_grad(p):
        return float((p["a"] ** 2).sum()), {"a": 2 * p["a"]}

    _, g1, p_end = adam.follow(p0, loss_and_grad, 3, 0.1,
                               {"a": (-10.0, 10.0)})
    t = p0["a"].clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=0.1)
    for _ in range(3):
        opt.zero_grad()
        (t ** 2).sum().backward()
        opt.step()
    torch.testing.assert_close(p_end["a"], t.detach())
    torch.testing.assert_close(g1["a"], 2 * p0["a"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.matern32, portbench.reference.adam; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cugp_tpu', 'cugp_tpu_torch', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
