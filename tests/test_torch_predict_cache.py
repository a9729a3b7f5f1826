"""GP.predict's kept factor (``GP._kept_factor``): later requests on an
unchanged state reuse the first request's (L, alpha) and give the bits a
fresh GP gives; every change of the state, through assignment, a fit or
an in-place edit of a held tensor, makes the next request factor again;
the kept pair carries no autograd graph; the answers still match the JAX
package's GP.predict."""

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cugp_tpu
from cugp_tpu.ops import kernels as jk

import cugp_tpu_torch
from cugp_tpu_torch.utils import profiling

torch.set_num_threads(1)

KIND = "matern32"


@pytest.fixture(scope="module")
def data():
    """n=96, d=3 training rows, 40 test points and matern32 params, in
    float64 numpy as a user passes them."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-1.0, 1.0, (96, 3))
    y = np.sin(3.0 * X.sum(1)) + 0.1 * rng.standard_normal(96)
    Xs = rng.uniform(-1.2, 1.2, (40, 3))
    params = jax.tree.map(np.asarray, jk.default_init(KIND, d=3))
    return X, y, Xs, params


@pytest.fixture(scope="module")
def jax_answer(data):
    X, y, Xs, params = data
    gp = cugp_tpu.GP(kind=KIND).condition(X, y, params=params)
    return tuple(np.asarray(a) for a in gp.predict(Xs))


def _gp(data, **kw):
    X, y, _, params = data
    return cugp_tpu_torch.GP(kind=KIND, device="cpu", **kw).condition(
        X, y, params=params)


def _fresh(gp):
    """A new GP conditioned on `gp`'s present state."""
    return cugp_tpu_torch.GP(kind=gp.kind, jitter=gp.jitter,
                             device="cpu").condition(gp.X, gp.y,
                                                     params=gp.params)


def _traced_predict(gp, Xs):
    with profile(activities=[ProfilerActivity.CPU]):
        out = gp.predict(Xs)
    return out, profiling.counts()


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def test_later_requests_reuse_the_factor_bit_for_bit(data, jax_answer):
    """The first request factors (one miss, the ladder's one read), the
    second reuses it (one hit, no read); both give the same bits as each
    other and as a fresh GP, and match the JAX package."""
    Xs = data[2]
    gp = _gp(data)
    first, c1 = _traced_predict(gp, Xs)
    second, c2 = _traced_predict(gp, Xs)
    assert c1 == {"factor_cache.miss": 1, "host_read.chol_ladder": 1}
    assert c2 == {"factor_cache.hit": 1}
    assert _equal(first, second)
    assert _equal(second, _fresh(gp).predict(Xs))
    for got, want in zip(second, jax_answer):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_the_kept_factor_has_no_autograd_graph(data):
    """Params that require grad (as a fit leaves them) still give a kept
    L and alpha outside autograd."""
    gp = _gp(data)
    gp.params = {k: v.clone().requires_grad_() for k, v in gp.params.items()}
    gp.predict(data[2])
    _, (L, alpha) = gp._kept
    for t in (L, alpha):
        assert t.grad_fn is None and not t.requires_grad


def test_inference_tensors_are_never_kept(data):
    """An inference tensor has no version counter to compare, so a state
    holding one is factored on every request."""
    X, y, Xs, params = data
    with torch.inference_mode():
        Xi = torch.as_tensor(X, dtype=torch.float32)
    gp = cugp_tpu_torch.GP(kind=KIND, device="cpu").condition(
        Xi, y, params=params)
    first, c1 = _traced_predict(gp, Xs)
    second, c2 = _traced_predict(gp, Xs)
    assert c1 == c2 == {"factor_cache.miss": 1, "host_read.chol_ladder": 1}
    assert gp._kept is None and _equal(first, second)


@pytest.mark.parametrize("method", ["fit", "condition"])
def test_fit_and_condition_drop_the_factor_on_entry(data, method):
    X, y, Xs, params = data
    gp = _gp(data)
    gp.predict(Xs)
    assert gp._kept is not None
    seen, validate = [], gp._data

    def spy(*a):
        seen.append(gp._kept)
        return validate(*a)

    gp._data = spy
    if method == "fit":
        gp.fit(X, y, steps=1, init=params)
    else:
        gp.condition(X, y)
    assert seen == [None]


def _fit(gp, data):
    X, y, _, params = data
    gp.fit(X, y, steps=2, learning_rate=0.1, init=params)
    return gp


def _fit_iterative(gp, data):
    X, y, _, params = data
    gp.fit_iterative(X, y, steps=1, learning_rate=0.1, init=params,
                     num_probes=4, precond_rank=16, tol=1e-4, max_iters=200)
    return gp


def _condition(gp, data):
    X, y, _, params = data
    gp.condition(X[:80], y[:80], params=params)
    return gp


def _load(gp, data, tmp_path):
    gp.params["log_noise_var"].sub_(0.5)
    gp.save(str(tmp_path / "gp"))
    return cugp_tpu_torch.GP.load(str(tmp_path / "gp"), device="cpu")


def _params_reassigned(gp, data):
    gp.params = {k: v + 0.1 for k, v in gp.params.items()}
    return gp


def _params_entry_replaced(gp, data):
    gp.params["log_signal_var"] = gp.params["log_signal_var"] + 0.3
    return gp


def _param_edited_in_place(gp, data):
    gp.params["log_noise_var"].fill_(-3.0)
    return gp


def _X_edited_in_place(gp, data):
    gp.X.mul_(1.1)
    return gp


def _y_edited_in_place(gp, data):
    gp.y[::2] += 0.2
    return gp


def _jitter_changed(gp, data):
    gp.jitter = 1e-2
    return gp


def _kind_changed(gp, data):
    gp.kind = "rbf"
    return gp


CHANGES = {"fit": _fit, "fit_iterative": _fit_iterative,
           "condition": _condition, "load": _load,
           "params_reassigned": _params_reassigned,
           "params_entry_replaced": _params_entry_replaced,
           "param_edited_in_place": _param_edited_in_place,
           "X_edited_in_place": _X_edited_in_place,
           "y_edited_in_place": _y_edited_in_place,
           "jitter_changed": _jitter_changed, "kind_changed": _kind_changed}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_state_factors_again(data, change, tmp_path):
    """After each change the next request misses, factors the new state
    and gives a fresh GP's bits, which differ from the old answer; the
    request after it hits again."""
    Xs = data[2]
    gp = _gp(data)
    before = gp.predict(Xs)
    fn = CHANGES[change]
    gp = fn(gp, data, tmp_path) if change == "load" else fn(gp, data)
    after, counts = _traced_predict(gp, Xs)
    assert counts["factor_cache.miss"] == 1
    assert "factor_cache.hit" not in counts
    assert _equal(after, _fresh(gp).predict(Xs))
    assert not _equal(after, before)
    again, counts = _traced_predict(gp, Xs)
    assert counts == {"factor_cache.hit": 1}
    assert _equal(again, after)
