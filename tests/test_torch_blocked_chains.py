"""The port's blocked chains (``chain_block``) against the JAX package
(CPU).

``hmc.blocked_chains`` evaluates the log density ``chain_block`` chains
at a time; the kernels' draws and the adaptation stay as wide as the
chains. Held to tests/inference/test_samplers.py's blocked checks (one
HMC and one NUTS transition against the unblocked kernel and against
JAX's blocked kernel on its draws at 1e-5, the non-divisible case, the
statistical run) and tests/inference/test_checkpointed_sampling.py's
blocked resume; the GP density at one transition; the samplers and the
CLI's ``--sample.chain_block`` against the JAX CLI's keys.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.cli.__main__ import main as jax_main
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.inference import hmc as jhmc
from cugp_tpu.inference import nuts as jnuts
from cugp_tpu.ops import kernels as jk

from cugp_tpu_torch.cli.__main__ import main as torch_main
from cugp_tpu_torch.inference import hmc, nuts, sampling
from cugp_tpu_torch.utils.params import params_from_numpy
from tests.test_torch_cli import flat, keyset, run
from tests.test_torch_sampling import _hmc_draws, _nuts_draws, gauss_pair

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def counted(lp):
    """lp, recording the chain count of every call."""
    sizes = []

    def fn(q):
        sizes.append(q.shape[0])
        return lp(q)

    return fn, sizes


def _gauss_state(chains, dim, seed=0):
    """test_samplers.py's standard Gaussian, C chains from key(seed)."""
    lp_j, lp_t = gauss_pair(np.zeros(dim, np.float32),
                            np.eye(dim, dtype=np.float32))
    q0 = np.asarray(jax.random.normal(jax.random.key(seed), (chains, dim)))
    logp0, grad0 = jax.vmap(lp_j)(q0)
    return (lp_j, lp_t, jhmc.HMCState(q0, logp0, grad0),
            hmc.HMCState(t(q0), t(np.asarray(logp0)), t(np.asarray(grad0))))


@pytest.mark.parametrize("chains,block", [(16, 4), (6, 4)],
                         ids=["divisible", "non_divisible"])
def test_blocked_hmc_transition_matches_unblocked_and_jax(chains, block):
    """One HMC transition (8 leapfrog steps, eps 0.2, the fixed-step
    kernel) with chain_block: positions and accept probabilities within
    1e-5 of the unblocked kernel on the same draws and of JAX's blocked
    kernel on its per-chain keys' draws; every evaluation in blocks of
    at most chain_block (the last one smaller when it does not divide
    the chains, where JAX pads it with copies of chain 0)."""
    dim = 3
    lp_j, lp_t, state_j, state = _gauss_state(chains, dim)
    keys = jax.random.split(jax.random.key(1), chains)
    eps, inv_mass = 0.2, np.ones(dim, np.float32)
    s_j, a_j, _ = jhmc.make_hmc_kernel(lp_j, 8, chain_block=block)(
        state_j, keys, jnp.asarray(eps), jnp.asarray(inv_mass))
    mom, uni = _hmc_draws(keys, dim)
    lp_c, sizes = counted(lp_t)
    outs = []
    for cb, fn in ((0, lp_t), (block, lp_c)):
        kernel = hmc.make_hmc_kernel(fn, 8, chain_block=cb, step_jitter=0.0)
        outs.append(kernel(state, hmc.Draws(normals=[mom], uniforms=[uni]),
                           t(eps), t(inv_mass)))
    (s_full, a_full, _), (s_blk, a_blk, _) = outs
    assert s_blk.q.shape == (chains, dim)
    for got, want in ((s_blk.q, s_full.q.numpy()), (a_blk, a_full.numpy()),
                      (s_blk.q, s_j.q), (a_blk, a_j)):
        close(got, want)
    tail = chains % block or block
    assert sizes == ([block] * (chains // block)
                     + ([tail] if chains % block else [])) * 8


def test_blocked_nuts_transition_matches_unblocked_and_jax():
    """One NUTS transition (max_depth 5, eps 0.2) of 16 chains with
    chain_block=8: the chosen states and accept statistics within 1e-5
    of the unblocked kernel and of JAX's blocked kernel on its draws,
    the same depths and leapfrog counts."""
    chains, dim = 16, 3
    lp_j, lp_t, state_j, state = _gauss_state(chains, dim)
    keys = jax.random.split(jax.random.key(1), chains)
    inv_mass = np.ones(dim, np.float32)
    ns_j, na_j, (_, nlf_j) = jnuts.make_nuts_kernel(
        lp_j, max_depth=5, chain_block=8)(state_j, keys, jnp.asarray(0.2),
                                          jnp.asarray(inv_mass))
    mom, uniforms = _nuts_draws(keys, dim, 5)
    outs = [nuts.make_nuts_kernel(lp_t, max_depth=5, chain_block=cb)(
        state, hmc.Draws(normals=[mom], uniforms=uniforms), 0.2,
        t(inv_mass)) for cb in (0, 8)]
    (s_full, a_full, (_, nlf_full)), (s_blk, a_blk, (_, nlf_blk)) = outs
    np.testing.assert_array_equal(nlf_blk.numpy(), nlf_full.numpy())
    np.testing.assert_array_equal(nlf_blk.numpy(), np.asarray(nlf_j))
    for got, want in ((s_blk.q, s_full.q.numpy()), (a_blk, a_full.numpy()),
                      (s_blk.q, ns_j.q), (a_blk, na_j)):
        close(got, want)


def test_blocked_run_is_statistically_correct():
    """test_blocked_chain_run_statistically_correct: 16 chains in blocks
    of 4 on a 3-D standard Gaussian, 16 leapfrog steps, 300 warm-up and
    1200 draws: accept rate in (0.4, 1], the mean within 0.2 of 0 and
    the standard deviation within 0.15 of 1; a non-divisible run (6
    chains, blocks of 4) gives draws of every chain."""
    dim, chains = 3, 16
    _, lp_t, _, state = _gauss_state(chains, dim)
    out = hmc.run_hmc(state.q, torch.Generator().manual_seed(1), lp_t,
                      n_leapfrog=16, num_warmup=300, num_samples=1200,
                      eps0=0.2, chain_block=4)
    qs = out["samples_flat"].numpy().reshape(-1, dim)
    assert 0.4 < float(out["accept_rate"]) <= 1.0
    np.testing.assert_allclose(qs.mean(axis=0), 0.0, atol=0.2)
    np.testing.assert_allclose(qs.std(axis=0), 1.0, atol=0.15)
    out = nuts.run_nuts(state.q[:6], torch.Generator().manual_seed(2), lp_t,
                        max_depth=4, num_warmup=10, num_samples=10,
                        chain_block=4)
    assert out["samples_flat"].shape == (10, 6, dim)
    with pytest.raises(ValueError, match="chain_block"):
        hmc.make_hmc_kernel(lp_t, 4, chain_block=-1)


@pytest.fixture(scope="module")
def gp_problem():
    X, y, _ = jsyn.sinusoid_1d(n=32, noise_std=0.1, seed=0)
    P = jk.init_params(d=1, lengthscale=0.8, noise_var=0.05)
    return (t(X), t(y), params_from_numpy(jax.tree.map(np.asarray, P),
                                          "cpu"))


def test_blocked_gp_density_one_transition(gp_problem):
    """The GP posterior (make_flat_logprob, n=32): 8 chains in blocks of
    3, the initial density and gradient and one jittered HMC transition
    (8 leapfrog steps) on the same draws within 1e-5 of the unblocked
    ones (JAX's bar for one blocked transition)."""
    X, y, p = gp_problem
    lp, _unravel, q0 = sampling.make_flat_logprob(p, X, y)
    qs = sampling.init_chains(q0, torch.Generator().manual_seed(0), 8)
    lp3 = hmc.blocked_chains(lp, 3)
    for got, want in zip(lp3(qs), lp(qs)):
        close(got, want.numpy())
    outs = []
    for cb in (0, 3):
        kernel = hmc.make_hmc_kernel(lp, 8, chain_block=cb)
        outs.append(kernel(hmc.init_state(qs, lp),
                           torch.Generator().manual_seed(4), t(0.05),
                           torch.ones(qs.shape[1])))
    for got, want in zip(outs[1][0], outs[0][0]):
        close(got, want.numpy())
    close(outs[1][1], outs[0][1].numpy())


@pytest.mark.parametrize("engine", ["dense", "iterative"])
def test_checkpointed_chain_block_resumes_bitwise(gp_problem, engine,
                                                  tmp_path):
    """test_checkpointed_chain_block_resume_equality: with chain_block=2
    (4 chains), 4 draws resumed to 8 equal 8 uninterrupted bit for
    bit, on both engines; the iterative engine's host-built
    preconditioner resumes too."""
    X, y, p = gp_problem
    kw = dict(num_chains=4, num_warmup=2, sampler="hmc", n_leapfrog=4,
              checkpoint_every=4, chain_block=2, engine=engine)
    if engine == "iterative":
        kw.update(num_probes=4, num_steps=4, block=16, cg_max_iters=50,
                  precond_rank=4, precond_where="host", n_leapfrog=2)

    def go(d, draws):
        return sampling.sample_hyperparams_checkpointed(
            p, X, y, checkpoint_dir=os.path.join(tmp_path, d),
            num_samples=draws, rng=torch.Generator().manual_seed(0), **kw)

    full = go("full", 8)
    assert go("part", 4)["draws_done"] == 4
    res = go("part", 8)
    assert res["resumed"] and res["draws_done"] == 8
    assert torch.equal(res["samples_flat"], full["samples_flat"])


def test_samplers_take_chain_block_and_host_precond(gp_problem):
    """sample_hyperparams_iterative with chain_block=2 and a host-built
    preconditioner, and GP.sample_hyperparams with chain_block=3: finite
    draws of every chain, each the unblocked run's within 1e-4 after
    two warm-up and two draws (the same draws; the evaluations sum in
    blocks)."""
    import cugp_tpu_torch

    X, y, p = gp_problem
    kw = dict(num_samples=2, num_chains=4, num_warmup=2, n_leapfrog=2,
              num_probes=2, num_steps=4, block=16, max_iters=50,
              precond_rank=4, precond_where="host")
    outs = [sampling.sample_hyperparams_iterative(
        p, X, y, chain_block=cb, rng=torch.Generator().manual_seed(0), **kw)
        for cb in (0, 2)]
    assert torch.isfinite(outs[1]["samples_flat"]).all()
    close(outs[1]["samples_flat"], outs[0]["samples_flat"].numpy(), 1e-4)
    gp = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(X, y,
                                                               params=p)
    kw = dict(num_samples=2, num_chains=4, num_warmup=2, sampler="nuts",
              max_tree_depth=3)
    a = gp.sample_hyperparams(chain_block=3, **kw)["samples"]
    b = gp.sample_hyperparams(**kw)["samples"]
    for k in b:
        assert a[k].shape[:2] == (2, 4)
        close(a[k], b[k].numpy(), 1e-4)


def test_cli_sample_chain_block_matches_jax_keys():
    """`sample --sample.chain_block=2` (4 chains, HMC, 4 + 8; tests/
    test_torch_cli.py's SAMPLE cell): rc 0, the JAX CLI's JSON keys,
    every number finite and within 1e-4 of the port's unblocked run
    (the same draws)."""
    argv = ["sample", "--data.n=64", "--sample.num_chains=4",
            "--sample.num_samples=8", "--sample.num_warmup=4",
            "--sample.sampler=hmc"]
    rc_j, (o_j,), _ = run(jax_main, argv + ["--sample.chain_block=2"])
    rc, (o,), _ = run(torch_main, argv + ["--sample.chain_block=2",
                                          "--device=cpu"])
    rc0, (o0,), _ = run(torch_main, argv + ["--device=cpu"])
    assert rc_j == rc == rc0 == 0
    assert keyset(o) == keyset(o_j)
    f, f0 = flat(o), flat(o0)
    assert all(np.isfinite(v) for v in f.values())
    assert all(abs(f[k] - f0[k]) <= 1e-4 for k in f0 if k != "seconds")
