"""The port's matrix-free hyperparameter sampling and the checkpointed
sampler against the JAX package (CPU).

The JAX side runs as its own tests run it here (method "auto" on the CPU
is the blocked XLA matvec); both sides get the same float32 inputs from a
numpy seed, the same Rademacher probes (JAX's bits, handed to the port)
and the same preconditioner factors (JAX's, handed over as numpy).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.inference import iterative as jit_
from cugp_tpu.inference import sampling as jsampling
from cugp_tpu.utils import checkpoint as jckpt

from cugp_tpu_torch.data import synthetic
from cugp_tpu_torch.inference import hmc, iterative, sampling
from cugp_tpu_torch.ops import cov_matvec_cuda, kernels
from cugp_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(1)

N, RANK, PROBES, STEPS = 256, 16, 8, 16


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def data():
    X, y, _ = synthetic.sinusoid_1d(n=N, noise_std=0.1, seed=0)
    p_np = {"log_lengthscale": np.log(np.float32([0.8])),
            "log_noise_var": np.log(np.float32(0.05)),
            "log_signal_var": np.float32(0.0)}
    key = jax.random.key(3)
    z = np.asarray(jax.random.rademacher(key, (N, PROBES), jnp.float32))
    pj = jax.tree.map(jnp.asarray, p_np)
    pre_j = jit_.precond_factors(pj, jnp.asarray(X), RANK)
    qs = (np.float32([-0.22, -3.0, 0.0])
          + 0.2 * np.random.default_rng(5).standard_normal((3, 3))).astype(
              np.float32)
    return dict(X=X, y=y, p_np=p_np, pj=pj, key=key, z=z, qs=qs,
                pre_np=tuple(np.asarray(a) for a in pre_j), pre_j=pre_j)


@pytest.fixture(scope="module")
def jax_logprob(data):
    """JAX's make_iterative_logprob vmapped over the 3 states, with and
    without the preconditioner (one compile each)."""
    out = {}
    for use_pre in (False, True):
        lp, _, _ = jsampling.make_iterative_logprob(
            data["pj"], jnp.asarray(data["X"]), jnp.asarray(data["y"]),
            block=128, num_probes=PROBES, num_steps=STEPS,
            probe_key=data["key"],
            precond=data["pre_j"] if use_pre else None)
        v, g = jax.jit(jax.vmap(lp))(jnp.asarray(data["qs"]))
        out[use_pre] = (np.asarray(v), np.asarray(g))
    return out


def port_logprob(data, use_pre):
    pre = tuple(t(a) for a in data["pre_np"]) if use_pre else None
    lp, _, _ = sampling.make_iterative_logprob(
        params_from_numpy(data["p_np"], "cpu"), t(data["X"]), t(data["y"]),
        block=128, num_probes=PROBES, num_steps=STEPS, Z=t(data["z"]),
        precond=pre)
    return lp


@pytest.mark.parametrize("use_pre", [False, True])
def test_iterative_logprob_matches_jax(data, jax_logprob, use_pre):
    """Value and gradient of 3 chain states in one batched call against
    jax.vmap of JAX's closure, on JAX's probes (and factors): the same
    estimator in fp32 with CG stopped at tol 1e-5 on both sides, so the
    value to 1e-4 relative and the gradient to 1e-3 of its largest
    component (measured: ~1e-6 and ~1e-5)."""
    v_j, g_j = jax_logprob[use_pre]
    v, g = port_logprob(data, use_pre)(t(data["qs"]))
    np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-4)
    assert np.abs(g.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()


def test_batched_logprob_equals_one_chain_at_a_time(data):
    """The batch of 3 against each state alone (a batch of 1) on the same
    probes and factors: the chains share nothing but the folded
    preconditioner GEMMs, whose column sums may round differently; CG
    carries that rounding into alpha and w, and the gradient's two
    terms cancel (measured: 1.6e-5 of the largest component), so 1e-6
    relative on the value and 1e-4 of the largest gradient component,
    chip_smoke phase 8's bars."""
    lp = port_logprob(data, True)
    qs = t(data["qs"])
    v, g = lp(qs)
    for i in range(3):
        v1, g1 = lp(qs[i:i + 1])
        np.testing.assert_allclose(v1.numpy(), v[i:i + 1].numpy(),
                                   rtol=1e-6)
        assert (g1[0] - g[i]).abs().max() <= 1e-4 * g[i].abs().max()


def test_batched_cg_freezes_a_converged_chain(data):
    """An easy chain (noise 1) and a harder one (noise 0.05) in one batched
    solve: the easy chain stops at its own count and is frozen there
    (bitwise the same batch run only that long), the loop runs on for
    the hard one. Each chain's solution is its solo solve's: both stop
    at ||r|| <= tol ||y||, and K >= noise I, so they lie within
    2 tol ||y|| / noise of each other (on the CPU the batched plain
    matvec sums in another order than the 2-D one, and CG carries that
    into the last digits and the residual test); the counts agree
    within 2."""
    X, y = t(data["X"]), t(data["y"])
    noise = [1.0, 0.05]
    params = {"log_lengthscale": t([[-0.2], [-0.2]]),
              "log_signal_var": t([0.0, 0.0]),
              "log_noise_var": t(np.log(noise))}
    mv = iterative.make_matvec(params, X)
    b = torch.stack([y, y])[..., None]
    tol = 1e-5
    x, its = iterative.cg_solve(mv, b, tol=tol, max_iters=400)
    assert its.dtype == torch.int64 and its.shape == (2,)
    assert int(its[0]) < int(its[1]) < 400
    x_short, its_short = iterative.cg_solve(mv, b, tol=tol,
                                            max_iters=int(its[0]))
    assert int(its_short[0]) == int(its[0])
    assert torch.equal(x_short[0], x[0])
    for i in range(2):
        mv1 = iterative.make_matvec({k: v[i] for k, v in params.items()}, X)
        x1, it1 = iterative.cg_solve(mv1, y, tol=tol, max_iters=400)
        assert abs(it1 - int(its[i])) <= 2
        gap = torch.linalg.vector_norm(x1 - x[i, :, 0])
        assert gap <= 2 * tol * torch.linalg.vector_norm(y) / noise[i]


def test_cg_diagnostic_matches_jax(data):
    """The one-solve staleness probe counts JAX's iterations within one
    (the last iteration's residual sits at tol in fp32)."""
    pj, X, y = data["pj"], data["X"], data["y"]
    for rank_pre in (None, data["pre_np"]):
        it_j = jsampling.cg_diagnostic(
            pj, None if rank_pre is None else data["pre_j"],
            jnp.asarray(X), jnp.asarray(y), block=128)
        it = sampling.cg_diagnostic(
            params_from_numpy(data["p_np"], "cpu"),
            None if rank_pre is None else tuple(t(a) for a in rank_pre),
            t(X), t(y), block=128)
        assert isinstance(it, float) and abs(it - it_j) <= 1


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_batched_plain_matvec_equals_the_loop(kind):
    """cov_matvec_plain on a (B, n, d) batch against its 2-D call per
    element: the same tile arithmetic, so 1e-6 relative (batched and
    2-D GEMMs may block the sums differently)."""
    rng = np.random.default_rng(2)
    B, n, d, r = 3, 300, 2, 5
    xs = t(rng.uniform(-2, 2, (B, n, d)))
    v = t(rng.standard_normal((B, n, r)))
    scal = t([[1.3, 0.1, 1.0], [0.7, 0.2, 1.0], [1.0, 0.05, 1.0]])
    out = cov_matvec_cuda.cov_matvec(xs, v, scal, kind, n)
    assert out.shape == (B, n, r)
    for b in range(B):
        one = cov_matvec_cuda.cov_matvec(xs[b], v[b], scal[b], kind, n)
        torch.testing.assert_close(out[b], one, rtol=1e-6, atol=1e-6)


# ---- the checkpointed sampler ----


def _ckpt_setup(n):
    X, y, _ = synthetic.sinusoid_1d(n=n, noise_std=0.1, seed=0)
    return (kernels.init_params(d=1, lengthscale=0.8, noise_var=0.05),
            t(X), t(y))


ENGINES = {
    "dense": dict(n=64, kw=dict(engine="dense")),
    "iterative": dict(n=128, kw=dict(
        engine="iterative", precond_rank=16, num_probes=4, num_steps=8,
        block=64, refresh_factor=1e-3)),
}


def _run(tmp, name, engine, num_samples, **extra):
    p, X, y = _ckpt_setup(ENGINES[engine]["n"])
    return sampling.sample_hyperparams_checkpointed(
        p, X, y, checkpoint_dir=os.path.join(tmp, name), checkpoint_every=2,
        num_samples=num_samples, num_chains=3, num_warmup=4, sampler="hmc",
        n_leapfrog=3, rng=torch.Generator().manual_seed(1),
        **ENGINES[engine]["kw"], **extra)


@pytest.mark.parametrize("engine", ["dense", "iterative"])
def test_resume_equals_the_uninterrupted_run(tmp_path, engine):
    """Killed after its first segment and resumed, a run gives the
    uninterrupted run's draws bitwise (the iterative engine with its
    preconditioner rebuilt after every segment: refresh_factor 1e-3)."""
    full = _run(tmp_path, "full", engine, 6)
    part = _run(tmp_path, "part", engine, 2)
    assert not part["resumed"] and part["draws_done"] == 2
    res = _run(tmp_path, "part", engine, 6)
    assert res["resumed"] and res["draws_done"] == 6
    assert torch.equal(res["samples_flat"], full["samples_flat"])
    assert torch.equal(res["samples_flat"][:2], part["samples_flat"])
    assert res["samples_flat"].shape == (6, 3, 3)
    assert float(res["accept_rate"]) == float(full["accept_rate"])
    if engine == "iterative":
        assert len(full["cg_iters_per_segment"]) == 3
        assert res["cg_iters_per_segment"] == full["cg_iters_per_segment"][1:]


def test_extend_finished_checkpoint_and_engine_mismatch(tmp_path):
    """A finished checkpoint asked for more draws extends the chain (its
    first draws unchanged, the rest the run's own); the other engine
    refuses the directory."""
    first = _run(tmp_path, "a", "dense", 2)
    again = _run(tmp_path, "a", "dense", 2)
    assert again["resumed"] and torch.equal(again["samples_flat"],
                                            first["samples_flat"])
    longer = _run(tmp_path, "a", "dense", 4)
    assert longer["draws_done"] == 4
    assert torch.equal(longer["samples_flat"][:2], first["samples_flat"])
    assert torch.equal(longer["samples_flat"],
                       _run(tmp_path, "b", "dense", 4)["samples_flat"])
    with pytest.raises(ValueError, match="engine"):
        _run(tmp_path, "a", "iterative", 4)


@pytest.mark.parametrize("layout", ["current", "six_leaves", "iterative"])
def test_jax_written_checkpoint_resumes(tmp_path, layout):
    """A checkpoint in the JAX sampler's layout, written by the JAX
    package's checkpoint.save (its current leaves, or the older six
    without logp/grad), resumes in the port: q, eps, inv_mass and the
    samples carry over, logp/grad are read (or recomputed for six
    leaves), and the port's next draws follow from the stored key_data.
    An iterative-engine checkpoint was taken under the JAX package's
    probes, which the port cannot redraw: its logp/grad (here those of
    other probes) are recomputed under the port's default probes, and
    the draws continue on that target."""
    iterative_engine = layout == "iterative"
    p, X, y = _ckpt_setup(64)
    kw = dict(num_probes=4, num_steps=8, block=64)
    if iterative_engine:
        foreign, _, _ = sampling.make_iterative_logprob(
            p, X, y, Z=iterative.rademacher(
                64, 4, "cpu", torch.Generator().manual_seed(99)), **kw)
        lp, _, _ = sampling.make_iterative_logprob(p, X, y, **kw)
    else:
        lp, _, _ = sampling.make_flat_logprob(p, X, y)
    rng = np.random.default_rng(0)
    q = (np.float32([-0.22, -3.0, 0.0])
         + 0.1 * rng.standard_normal((3, 3))).astype(np.float32)
    logp, grad = (foreign if iterative_engine else lp)(t(q))
    blob = {"q": q, "eps": np.float32(0.05),
            "inv_mass": np.float32([0.5, 0.4, 0.3]),
            "key_data": np.asarray(jax.random.key_data(jax.random.key(11))),
            "samples": rng.standard_normal(2 * 3 * 3).astype(np.float32),
            "accept_sum": np.asarray(4.5)}
    if layout != "six_leaves":
        blob.update(logp=logp.numpy(), grad=grad.numpy())
    path = os.path.join(tmp_path, "jax")
    engine = "iterative" if iterative_engine else "dense"
    jckpt.save(path, blob, step=2, extra_json={
        "sampler": "hmc", "kind": "rbf", "num_chains": 3, "num_warmup": 4,
        "engine": engine})
    out = sampling.sample_hyperparams_checkpointed(
        p, X, y, checkpoint_dir=path, checkpoint_every=2, num_samples=4,
        num_chains=3, num_warmup=4, sampler="hmc", n_leapfrog=3,
        rng=torch.Generator().manual_seed(1), engine=engine,
        **(kw if iterative_engine else {}))
    assert out["resumed"] and out["draws_done"] == 4
    np.testing.assert_array_equal(out["samples_flat"][:2].numpy(),
                                  blob["samples"].reshape(2, 3, 3))
    assert float(out["eps"]) == np.float32(0.05)
    np.testing.assert_array_equal(out["inv_mass"].numpy(),
                                  blob["inv_mass"])
    # the same two draws as a segment from the stored positions (their
    # logp/grad under the port's target) and key
    kernel = hmc.make_hmc_kernel(lp, 3)
    state = hmc.HMCState(t(q), *lp(t(q)))
    _, qs, _, _ = hmc.sample_segment(
        state, sampling.segment_generator(blob["key_data"], 2, "cpu"),
        kernel, out["eps"], out["inv_mass"], 2)
    torch.testing.assert_close(out["samples_flat"][2:], qs, rtol=0, atol=0)


def test_iterative_sampler_output_matches_jax():
    """sample_hyperparams_iterative's keys and shapes against JAX's on a
    2-chain, 2 + 2-draw HMC run at n=32; chain_block and the host
    preconditioner raise (ROADMAP items 14 and 12)."""
    X, y, _ = synthetic.sinusoid_1d(n=32, noise_std=0.1, seed=0)
    p_np = {"log_lengthscale": np.log(np.float32([0.8])),
            "log_noise_var": np.log(np.float32(0.05)),
            "log_signal_var": np.float32(0.0)}
    kw = dict(num_samples=2, num_chains=2, num_warmup=2, n_leapfrog=2,
              num_probes=2, num_steps=4, block=16, max_iters=50)
    out_j = jsampling.sample_hyperparams_iterative(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(X), jnp.asarray(y),
        **kw)
    p = params_from_numpy(p_np, "cpu")
    out = sampling.sample_hyperparams_iterative(p, t(X), t(y),
                                                precond_rank=4, **kw)
    assert set(out) == set(out_j)
    for k in out:
        if k == "samples":
            for name in out_j[k]:
                assert out[k][name].shape == out_j[k][name].shape
        else:
            assert tuple(np.shape(out[k])) == tuple(np.shape(out_j[k])), k
    assert torch.isfinite(out["samples_flat"]).all()
    with pytest.raises(NotImplementedError, match="item 12"):
        sampling.sample_hyperparams_iterative(p, t(X), t(y), precond_rank=4,
                                              precond_where="host", **kw)
    with pytest.raises(NotImplementedError, match="chain_block"):
        sampling.sample_hyperparams_iterative(p, t(X), t(y), chain_block=2,
                                              **kw)


def test_default_random_streams_are_drawn_on_the_cpu(monkeypatch):
    """Every generator the port seeds itself is a CPU torch.Generator,
    whatever device the draws are asked for (torch's CPU and CUDA
    generators give other numbers for one seed): a segment's generator,
    the default probes of the samplers and of rademacher, as_draws(None),
    GP's sampler default, and fit_iterative's. "meta" stands in for a
    card here: a generator on it cannot even be built, so a default that
    still followed the device would raise."""
    from cugp_tpu_torch import GP
    from cugp_tpu_torch.inference import map_opt

    cuda = torch.device("cuda")
    assert sampling.segment_generator([1, 2], 3, cuda).device.type == "cpu"
    assert hmc.as_draws(None, cuda).generator.device.type == "cpu"
    assert GP(device=cuda)._rng(None, None).generator.device.type == "cpu"
    meta = torch.device("meta")
    assert iterative.rademacher(40, 3, meta).device == meta
    want = 2 * torch.randint(0, 2, (40, 3), generator=torch.Generator(
    ).manual_seed(0)) - 1
    assert torch.equal(iterative.rademacher(40, 3, "cpu"), want.float())
    z = sampling._probes(40, 3, None, None, meta)
    assert z.device == meta
    want = iterative.rademacher(40, 3, "cpu", torch.Generator().manual_seed(
        sampling.DEFAULT_PROBE_SEED))
    assert torch.equal(sampling._probes(40, 3, None, None, "cpu"), want)
    # fit_iterative's default generator, seen by the probes it draws
    seen = []
    real = iterative.rademacher

    def spy(n, p, device, generator=None):
        seen.append(generator.device.type)
        return real(n, p, device, generator)

    monkeypatch.setattr(iterative, "rademacher", spy)
    p, X, y = _ckpt_setup(32)
    map_opt.fit_iterative(p, X, y, steps=1, num_probes=2, precond_rank=0,
                          block=32, probe_mode="frozen")
    assert seen == ["cpu"]
