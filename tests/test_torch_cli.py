"""The port's CLI and process-level modules against the JAX package's (CPU).

``python -m cugp_tpu_torch.cli`` runs in this process through its
``main`` with ``--device=cpu`` (the kernels' plain versions) beside the
JAX package's ``main`` on the same argv: the same JSON keys, and where
the two draw no random numbers (fit, predict, classify, sgpr) the same
numbers within 1e-4 (relative for the LML/ELBO, absolute for params and
means; the bar of the fit trajectories, ROADMAP §3). Also: the config,
metrics, profiling, supervise and native-oracle copies;
``fit_iterative``'s checkpoint/resume, bit for bit where nothing is
rebuilt on resume and across the packages both ways; and the CLI path
with ``jax`` blocked.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cugp_tpu.cli.__main__ import main as jax_main
from cugp_tpu.inference import map_opt as jmap
from cugp_tpu.oracle import exact_gp_np as oracle
from cugp_tpu.ops import kernels as jk
from cugp_tpu.utils import checkpoint as jckpt
from cugp_tpu.utils import config as jconfig

from cugp_tpu_torch.cli.__main__ import main as torch_main
from cugp_tpu_torch.inference import map_opt as tmap
from cugp_tpu_torch.utils import checkpoint as tckpt
from cugp_tpu_torch.utils import config as tconfig
from cugp_tpu_torch.utils import metrics, profiling, supervise
from cugp_tpu_torch.utils.params import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(main, argv):
    """(rc, the JSON objects main printed, its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    text, dec, objs, i = out.getvalue(), json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        obj, i = dec.raw_decode(text, i)
        objs.append(obj)
    return rc, objs, err.getvalue()


def flat(tree, prefix=""):
    """{dotted path: float} of a JSON tree's numbers."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: float(tree)}


def keyset(tree):
    """The nested key structure of a JSON object (lists as leaves)."""
    if isinstance(tree, dict):
        return {k: keyset(v) for k, v in tree.items()}
    return None


# ---- config, metrics, profiling ----

CONFIG_ARGVS = [
    ["--model.kind=matern32", "--data.n=4096", "--fit.learning_rate=0.01",
     "--mesh.dp=2"],
    ["--fit.engine=iterative", "--fit.segment_iters=0", "--data.path=a.npz",
     "--model.normalize_y=true", "--svgp.optimize_inducing=0"],
    [],
]


@pytest.mark.parametrize("argv", CONFIG_ARGVS, ids=["ladder", "typed", "defaults"])
def test_config_matches_jax(argv):
    """One argv gives the same config in both packages (the JAX test's
    overrides among them), and the same to_json."""
    cfg_t, rest_t = tconfig.parse_overrides(argv)
    cfg_j, rest_j = jconfig.parse_overrides(argv)
    assert rest_t == rest_j == []
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert tconfig.to_json(cfg_t) == jconfig.to_json(cfg_j)
    if argv is CONFIG_ARGVS[0]:
        assert cfg_t.model.kind == "matern32" and cfg_t.data.n == 4096
        assert abs(cfg_t.fit.learning_rate - 0.01) < 1e-12
        assert cfg_t.mesh.dp == 2


def test_config_unknown_field():
    with pytest.raises(KeyError):
        tconfig.parse_overrides(["--model.bogus=1"])
    cfg, rest = tconfig.parse_overrides(["positional", "--no_value"])
    assert rest == ["positional", "--no_value"]


def test_metrics_logger_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "sub", "m.jsonl")
    with metrics.MetricsLogger(path) as m:
        m.log_series("loss", [3.0, 2.0, 1.0])
        m.log(event="done", lml=1.25)
    recs = metrics.read_metrics(path)
    assert len(recs) == 4
    assert recs[0]["loss"] == 3.0 and recs[0]["step"] == 0
    assert recs[-1]["event"] == "done" and recs[-1]["lml"] == 1.25


def test_profiling_trace_timed_and_flop_models(tmp_path):
    """trace writes a Chrome trace of the block; timed returns the
    median of its calls; the FLOP models are the JAX package's."""
    from cugp_tpu.utils import profiling as jprof

    a = torch.randn(64, 64)
    with profiling.trace(os.path.join(tmp_path, "tr")):
        torch.linalg.cholesky(a @ a.T + 64 * torch.eye(64))
    with open(os.path.join(tmp_path, "tr", "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    calls = []
    s = profiling.timed(lambda: calls.append(time.sleep(0.002)), warmup=2,
                        iters=3)
    assert len(calls) == 5 and 0.001 < s < 1.0
    for fn, args in ((profiling.chol_flops, (100,)),
                     (profiling.cov_flops, (10, 20, 3)),
                     (profiling.trsm_flops, (7, 5)),
                     (profiling.gflops, (1e9, 2.0))):
        assert fn(*args) == getattr(jprof, fn.__name__)(*args)


# ---- the CLI against the JAX package's ----

PARITY = {
    "fit": ["fit", "--data.n=100", "--fit.steps=20"],
    "predict": ["predict", "--data.n=100", "--fit.steps=20"],
    "classify": ["classify", "--data.n=100", "--fit.steps=5"],
    # multidim: on the default sinusoid (n=200, m=50) K_mm is so
    # ill-conditioned in fp32 that JAX's jitted fit meets a non-finite
    # gradient at step 8 and skips it (ROADMAP §3)
    "sgpr": ["sgpr", "--data.dataset=multidim", "--data.d=4",
             "--data.n=200", "--fit.steps=10"],
}


@pytest.fixture(scope="module")
def parity_runs():
    out = {}
    for verb, argv in PARITY.items():
        rc_j, j, _ = run(jax_main, argv)
        rc_t, t, _ = run(torch_main, argv + ["--device=cpu"])
        assert rc_j == rc_t == 0
        out[verb] = (j, t)
    return out


@pytest.mark.parametrize("verb", list(PARITY))
def test_cli_matches_jax(parity_runs, verb):
    """The same keys; the LML/ELBO within 1e-4 relative; params, means,
    variances, accuracy and RMSE within 1e-4."""
    j, t = parity_runs[verb]
    assert len(j) == len(t) == (2 if verb == "predict" else 1)
    for oj, ot in zip(j, t):
        assert keyset(ot) == keyset(oj)
        fj, ft = flat(oj), flat(ot)
        for k, v in fj.items():
            if k == "seconds":
                continue
            if k in ("lml", "laplace_lml", "elbo"):
                assert abs(ft[k] - v) <= 1e-4 * abs(v), (k, ft[k], v)
            else:
                assert abs(ft[k] - v) <= 1e-4, (k, ft[k], v)


SAMPLE = ["sample", "--data.n=64", "--sample.num_chains=4",
          "--sample.num_samples=8", "--sample.num_warmup=4",
          "--sample.sampler=hmc"]


@pytest.mark.parametrize("case", ["sample", "sample_checkpointed", "vi",
                                  "svgp_gaussian", "svgp_bernoulli"])
def test_cli_keys_where_draws_differ(case, tmp_path):
    """sample, vi and svgp draw other random numbers than JAX (CPU torch
    generators): the keys the JAX CLI writes
    (cugp_tpu/cli/__main__.py:124-135, 221-243, 251-254, 306-318), every
    value finite."""
    argv = {
        "sample": SAMPLE,
        "sample_checkpointed": SAMPLE + [
            f"--checkpoint_dir={tmp_path}/ck", "--sample.checkpoint_every=4"],
        "vi": ["vi", "--data.n=64", "--fit.steps=10"],
        "svgp_gaussian": ["svgp", "--data.n=200", "--fit.steps=20"],
        "svgp_bernoulli": ["svgp", "--svgp.likelihood=bernoulli",
                           "--data.n=200", "--fit.steps=20"],
    }[case]
    rc, (out,), _ = run(torch_main, argv + ["--device=cpu"])
    assert rc == 0
    stat = {"mean": None, "std": None, "r_hat": None, "ess": None}
    params = ("log_lengthscale", "log_signal_var", "log_noise_var")
    want = {
        "sample": {"seconds": None, "accept_rate": None,
                   "posterior": {k: stat for k in params}},
        "vi": {"elbo": None, "mean": dict.fromkeys(params)},
        "svgp_gaussian": {"seconds": None, "num_inducing": None,
                          "elbo_batch_final": None, "train_rmse_head": None},
        "svgp_bernoulli": {"seconds": None, "num_inducing": None,
                           "elbo_batch_final": None, "train_accuracy": None},
    }
    want["sample_checkpointed"] = dict(want["sample"], resumed=None,
                                       draws_done=None)
    assert keyset(out) == want[case]
    assert all(np.isfinite(v) for v in flat(out).values())


def test_ess_with_two_draws_is_the_empty_sum():
    """`sample --sample.num_samples=2` (phase 11(d)) reads ESS from 2
    draws: no lag to sum, tau = 1, ESS = draws x chains; the JAX
    package's stack of no lags raises there (ROADMAP §3)."""
    from cugp_tpu.inference import sampling as jsampling
    from cugp_tpu_torch.inference import sampling as tsampling

    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    assert float(tsampling.effective_sample_size(x)) == 8.0
    with pytest.raises(ValueError):
        jsampling.effective_sample_size(x)
    x3 = np.random.default_rng(1).standard_normal((12, 4)).astype(np.float32)
    assert abs(float(tsampling.effective_sample_size(x3))
               - float(jsampling.effective_sample_size(x3))) <= 1e-4


def test_cli_fit_checkpoint_resume(tmp_path):
    """As tests/test_api.py's: the second fit on one checkpoint_dir
    starts from the saved params; the metrics file gets a neg_lml line
    a step and a fit_done event a call."""
    ck, mf = os.path.join(tmp_path, "ck"), os.path.join(tmp_path, "m.jsonl")
    args = ["fit", "--device=cpu", "--data.n=100", "--fit.steps=20",
            f"--checkpoint_dir={ck}", f"--metrics_file={mf}"]
    rc1, (o1,), _ = run(torch_main, args)
    rc2, (o2,), _ = run(torch_main, args)
    assert rc1 == rc2 == 0
    assert o1["resumed"] is False and o2["resumed"] is True
    recs = metrics.read_metrics(mf)
    assert sum("neg_lml" in r for r in recs) == 40
    assert [r["event"] for r in recs if "event" in r] == ["fit_done"] * 2


def test_cli_fit_iterative_checkpoint_resume(tmp_path):
    """As tests/inference/test_fit_iterative.py's: the iterative fit
    keeps its optimizer state in the sibling <dir>_fit_state, and a
    re-run resumes."""
    ck = os.path.join(tmp_path, "it_ck")
    args = ["fit", "--device=cpu", "--data.n=256", "--fit.engine=iterative",
            "--fit.steps=6", "--fit.learning_rate=0.1",
            "--fit.precond_rank=0", "--fit.num_probes=8", "--fit.block=128",
            f"--checkpoint_dir={ck}"]
    rc, (o1,), _ = run(torch_main, args)
    assert rc == 0 and np.isfinite(o1["lml"]) and o1["resumed"] is False
    meta = tckpt.peek_meta(ck + "_fit_state")
    assert meta["step"] == 6 and meta["extra"] == {"kind": "rbf", "n": 256}
    rc, (o2,), _ = run(torch_main, args)
    assert rc == 0 and o2["resumed"] is True


def test_cli_profile_writes_a_trace(tmp_path):
    prof = os.path.join(tmp_path, "prof")
    rc, (out,), err = run(torch_main, ["fit", "--device=cpu", "--data.n=64",
                                       "--fit.steps=2", f"--profile={prof}"])
    assert rc == 0 and np.isfinite(out["lml"])
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    assert "trace written" in err


@pytest.mark.parametrize("argv", [
    ["banana"], ["fit", "--bogus.flag=1"], ["fit", "--device=tpu"],
    ["fit", "--device=cpu", "stray"]],
    ids=["unknown_verb", "bad_flag", "bad_device", "stray_arg"])
def test_cli_usage_errors_exit_2(argv):
    """An unknown verb or a bad flag exits 2 with the usage text."""
    rc, objs, err = run(torch_main, argv)
    assert rc == 2 and objs == []
    assert "python -m cugp_tpu_torch.cli fit" in err


def test_cli_bad_kind_is_a_value_error():
    with pytest.raises(ValueError, match="banana"):
        run(torch_main, ["fit", "--device=cpu", "--model.kind=banana",
                         "--data.n=32"])


def test_cli_help_and_info():
    rc, objs, _ = run(torch_main, [])
    assert rc == 0 and objs == []
    rc, (info,), _ = run(torch_main, ["info", "--device=cpu",
                                      "--data.n=7"])
    assert rc == 0 and info["backend"] == "cpu"
    assert info["torch"] == torch.__version__
    assert info["cuda_available"] == torch.cuda.is_available()
    assert len(info["devices"]) == info["device_count"]
    assert info["config"]["data"]["n"] == 7


def test_cli_never_imports_jax():
    """The CLI runs with jax blocked, as on the card's machine."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.argv = ['cli', 'fit', '--device=cpu', '--data.n=64', "
            "'--fit.steps=3']; "
            "runpy.run_module('cugp_tpu_torch.cli', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert np.isfinite(json.loads(res.stdout)["lml"])


# ---- fit_iterative checkpoint/resume ----

def _problem(n=128, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    init = jax.tree.map(np.asarray, jk.init_params(d=d, lengthscale=1.5,
                                                   noise_var=0.3))
    return X, y, init


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_fit_iterative_resume_is_bitwise(tmp_path):
    """With nothing rebuilt on resume (no preconditioner, no warm start),
    6 steps resumed to 12 equal 12 uninterrupted steps bit for bit: the
    params, Adam's moments and count, and every loss, with fresh probes
    (the generator skips the draws of the steps already taken)."""
    X, y, init = _problem()
    kw = dict(steps=12, learning_rate=0.1, block=64, num_probes=8,
              precond_rank=0, warm_start=False, split_programs=True,
              checkpoint_every=4)
    full, part = (os.path.join(tmp_path, k) for k in ("full", "part"))
    p_full, i_full = tmap.fit_iterative(params_from_numpy(init, "cpu"),
                                        t(X), t(y), checkpoint_dir=full, **kw)
    tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X), t(y),
                       checkpoint_dir=part, **dict(kw, steps=6))
    assert tckpt.peek_meta(part)["step"] == 6
    p_res, i_res = tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X),
                                      t(y), checkpoint_dir=part, **kw)
    for k in p_full:
        assert torch.equal(p_res[k], p_full[k]), k
    assert torch.equal(i_res["loss"], i_full["loss"])
    assert len(i_res["cg_iters"]) == 6  # only this call's steps
    probe = {"losses": np.zeros(0, np.float32),
             "opt": [np.zeros((), np.int32), init, init], "params": init}
    (a, ma), (b, mb) = (tckpt.restore(d, probe) for d in (full, part))
    assert ma["step"] == mb["step"] == 12
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(u, v)
    assert int(a["opt"][0]) == 12


def test_fit_iterative_resume_within_jax_bar(tmp_path):
    """JAX's own resume test's settings (warm start on, precond_rank 0,
    tol 1e-7, 16 fresh probes, a checkpoint every 3 steps): resumed and
    uninterrupted runs within 1e-4 (its bar), losses within 1e-3."""
    X, y, init = _problem(n=160, d=1, seed=1)
    kw = dict(steps=12, learning_rate=0.1, block=128, tol=1e-7,
              max_iters=1000, num_probes=16, precond_rank=0,
              split_programs=True, checkpoint_every=3)
    full, part = (os.path.join(tmp_path, k) for k in ("full", "part"))
    p_full, i_full = tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X),
                                        t(y), checkpoint_dir=full, **kw)
    tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X), t(y),
                       checkpoint_dir=part, **dict(kw, steps=6))
    p_res, i_res = tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X),
                                      t(y), checkpoint_dir=part, **kw)
    assert i_res["loss"].shape == (12,)
    for k in p_full:
        np.testing.assert_allclose(p_res[k].numpy(), p_full[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(i_res["loss"].numpy(), i_full["loss"].numpy(),
                               rtol=1e-3, atol=1e-3)


def test_fit_state_crosses_between_packages(tmp_path):
    """A fit-state directory written by the JAX package (frozen key(5)
    probes, 3 steps) resumes in the port, given those probes: its 4th
    step's params are JAX's own resumed 4th step's within 1e-5. And the
    port's directory restores under JAX's restore with JAX's probe tree
    (params, optax's Adam state, losses)."""
    X, y, init = _problem(n=96, d=2, seed=2)
    key = jax.random.key(5)
    kw = dict(learning_rate=0.1, block=96, num_probes=4, precond_rank=0,
              split_programs=True, probe_mode="frozen", tol=1e-6,
              max_iters=400)
    d_jax = os.path.join(tmp_path, "jax_state")
    jmap.fit_iterative(init, jnp.asarray(X), jnp.asarray(y), steps=3,
                       key=key, checkpoint_dir=d_jax, checkpoint_every=3, **kw)
    d_copy = os.path.join(tmp_path, "jax_state_copy")
    shutil.copytree(d_jax, d_copy)
    p_j, info_j = jmap.fit_iterative(init, jnp.asarray(X), jnp.asarray(y),
                                     steps=4, key=key, checkpoint_dir=d_jax,
                                     checkpoint_every=3, **kw)
    z = np.asarray(jax.random.rademacher(key, (96, 4), dtype=jnp.float32))
    p_t, info_t = tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X),
                                     t(y), steps=4, probes=t(z),
                                     checkpoint_dir=d_copy,
                                     checkpoint_every=3, **kw)
    for k, v in p_j.items():
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(v), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(info_t["loss"].numpy()[:3],
                                  np.asarray(info_j["loss"])[:3])

    # the port's state under JAX's restore
    tx = optax.adam(0.1)
    probe = {"params": init, "opt": tx.init(init), "losses": np.zeros(0)}
    tree, meta = jckpt.restore(d_copy, probe)
    assert meta["step"] == 4 and meta["extra"] == {"kind": "rbf", "n": 96}
    count = jax.tree.leaves(tree["opt"])[0]
    assert int(count) == 4
    for k, v in params_to_numpy(p_t).items():
        np.testing.assert_array_equal(tree["params"][k], v)
    np.testing.assert_array_equal(tree["losses"], info_t["loss"].numpy())
    jmap.fit_iterative(init, jnp.asarray(X), jnp.asarray(y), steps=5,
                       key=key, checkpoint_dir=d_copy, **kw)
    assert jckpt.restore(d_copy, probe)[1]["step"] == 5


def test_fit_iterative_refuses_another_problems_state(tmp_path):
    X, y, init = _problem(n=64)
    kw = dict(steps=2, num_probes=2, precond_rank=0, block=64,
              checkpoint_dir=os.path.join(tmp_path, "s"))
    tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X), t(y), **kw)
    with pytest.raises(ValueError, match="n=64"):
        tmap.fit_iterative(params_from_numpy(init, "cpu"), t(X[:32]),
                           t(y[:32]), **kw)


# ---- the native oracle (the repository's C++ baselines) ----

@pytest.fixture(scope="module")
def native():
    from cugp_tpu_torch.oracle import native as nat

    if shutil.which("g++") is None or not nat.available():
        pytest.skip("no g++ to build native/gp_serial.cpp")
    return nat


@pytest.fixture(scope="module")
def native_data():
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, size=(150, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(150)
    params = {"log_lengthscale": np.log([0.8, 1.2]),
              "log_signal_var": np.log(1.5), "log_noise_var": np.log(0.05)}
    return X, y, params


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52"])
def test_native_covariance_matches(native, native_data, kind):
    X, _, params = native_data
    K_np = oracle.train_covariance(params, X, kind, jitter=1e-6)
    K_cc = native.train_covariance(params, X, kind, jitter=1e-6)
    # the matern kernels' sqrt near r = 0 amplifies the two codes' other
    # rounding of the squared distance (tests/test_native_oracle.py)
    tol = 1e-12 if kind == "rbf" else 1e-7
    np.testing.assert_allclose(K_cc, K_np, rtol=tol, atol=tol)


def test_native_cholesky_matches_and_rejects_indefinite(native, native_data):
    X, _, params = native_data
    K = oracle.train_covariance(params, X, "rbf")
    np.testing.assert_allclose(native.cholesky(K), np.linalg.cholesky(K),
                               rtol=1e-10, atol=1e-12)
    a = np.eye(8)
    a[5, 5] = -1.0
    with pytest.raises(np.linalg.LinAlgError, match="column 5"):
        native.cholesky(a)


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_native_lml_matches(native, native_data, kind):
    X, y, params = native_data
    ref = oracle.log_marginal_likelihood(params, X, y, kind)
    assert abs(native.log_marginal_likelihood(params, X, y, kind) - ref) < 1e-8


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_native_parallel_lml_matches(native, native_data, kind):
    if not native.parallel_available():
        pytest.skip("no OpenMP toolchain for native/gp_parallel.cpp")
    X, y, params = native_data
    ref = oracle.log_marginal_likelihood(params, X, y, kind)
    val = native.log_marginal_likelihood_parallel(params, X, y, kind)
    assert abs(val - ref) < 1e-8
    assert native.num_threads() >= 1


def test_native_posterior_matches(native, native_data):
    X, y, params = native_data
    Xs = np.linspace(-2, 2, 33).reshape(-1, 1).repeat(2, axis=1)
    mu_ref, var_ref = oracle.posterior(params, X, y, Xs, "rbf")
    mu, var = native.posterior(params, X, y, Xs, "rbf")
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(var, var_ref, rtol=1e-8, atol=1e-10)


def test_native_scalar_lengthscale_broadcasts(native, native_data):
    """A scalar log_lengthscale is broadcast to every feature (the C code
    reads d of them)."""
    X, y, params = native_data
    p1 = dict(params, log_lengthscale=np.log(0.9))
    ref = oracle.log_marginal_likelihood(p1, X, y, "rbf")
    assert abs(native.log_marginal_likelihood(p1, X, y) - ref) < 1e-8
    with pytest.raises(ValueError, match="3 entries"):
        native.log_marginal_likelihood(
            dict(params, log_lengthscale=np.zeros(3)), X, y)


# ---- supervision ----

def test_supervised_cli_fit_killed_and_resumed(tmp_path, monkeypatch):
    """A real `python -m cugp_tpu_torch.cli fit` child is SIGKILLed once
    its heartbeat appears; the supervisor restarts it, the restarted
    child resumes from its checkpoint and the run ends with rc 0. The
    child is found among this process's children by its cmdline, never
    by pattern."""
    ck = os.path.join(tmp_path, "ck")
    hb = os.path.join(tmp_path, "metrics.jsonl")
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    child = [sys.executable, "-m", "cugp_tpu_torch.cli", "fit",
             "--device=cpu", "--data.n=100", "--fit.steps=30",
             f"--checkpoint_dir={ck}", f"--metrics_file={hb}"]
    killed, logs = [], []

    def own_cli_children():
        me = str(os.getpid())
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = f.read().rsplit(")", 1)[1].split()[1]
                with open(f"/proc/{pid}/cmdline") as f:
                    cmdline = f.read()
            except OSError:
                continue
            if ppid == me and "cugp_tpu_torch.cli" in cmdline:
                yield int(pid)

    def killer():
        # find the child first, so that the kill follows the heartbeat's
        # appearance within a poll (the child writes it when its fit and
        # checkpoint are done, just before it exits)
        deadline, pids = time.time() + 120, []
        while time.time() < deadline and not pids:
            pids = list(own_cli_children())
            time.sleep(0.01)
        while time.time() < deadline and not os.path.exists(hb):
            time.sleep(0.005)
        for pid in pids:
            os.kill(pid, 9)
            killed.append(pid)

    th = threading.Thread(target=killer)
    th.start()
    rc = supervise.supervise(child, hb, timeout=120, max_restarts=2,
                             poll=0.05, _log=logs.append)
    th.join(timeout=150)
    assert not th.is_alive()
    assert rc == 0 and tckpt.peek_meta(ck) is not None
    assert killed and any('"restarting"' in s for s in logs)
    recs = metrics.read_metrics(hb)
    assert sum(r.get("event") == "fit_done" for r in recs) >= 1


def test_supervise_main_builds_the_port_child(monkeypatch):
    """`python -m cugp_tpu_torch.utils.supervise -- <verb> ...` runs the
    port's CLI, with its --metrics_file as the heartbeat."""
    seen = {}

    def fake(cmd, heartbeat, **kw):
        seen.update(cmd=cmd, heartbeat=heartbeat, **kw)
        return 0

    monkeypatch.setattr(supervise, "supervise", fake)
    assert supervise.main(["--timeout=7", "--", "fit",
                           "--metrics_file=/x/hb.jsonl"]) == 0
    assert seen["cmd"][1:] == ["-m", "cugp_tpu_torch.cli", "fit",
                               "--metrics_file=/x/hb.jsonl"]
    assert seen["heartbeat"] == "/x/hb.jsonl" and seen["timeout"] == 7.0
    assert supervise.main(["--", "fit"]) == 2  # no heartbeat
