"""The port's hyperparameter samplers and VI against the JAX package (CPU).

Pieces are held against their JAX twins on fixed inputs, with the random
numbers the JAX code draws (momenta, accept and tree uniforms, ELBO
draws) derived from its own key splits and fed to the port through
hmc.Draws; runs are held to the statistics of
tests/inference/test_samplers.py; the GP entry points to JAX's output
structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cugp_tpu
from cugp_tpu.data import synthetic as jsyn
from cugp_tpu.inference import hmc as jhmc
from cugp_tpu.inference import nuts as jnuts
from cugp_tpu.inference import sampling as jsampling
from cugp_tpu.inference import vi as jvi
from cugp_tpu.models import exact_gp as jgp
from cugp_tpu.ops import kernels as jk

import cugp_tpu_torch
from cugp_tpu_torch.inference import hmc, nuts, sampling, vi
from cugp_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-6, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def gauss_pair(mean, cov_inv):
    """(JAX single-chain value_and_grad, port batched logprob_and_grad) of
    a Gaussian log density."""
    mean_j, ci_j = jnp.asarray(mean), jnp.asarray(cov_inv)
    mean_t, ci_t = t(mean), t(cov_inv)

    def lp_j(q):
        d = q - mean_j
        return -0.5 * d @ ci_j @ d

    def lp_t(q):
        d = q - mean_t
        g = d @ ci_t
        return -0.5 * torch.sum(g * d, dim=-1), -g

    return jax.value_and_grad(lp_j), lp_t


COV_INV = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]],
                   np.float32)


def test_dual_averaging_and_moments_match_jax():
    """da_init/da_update over a fixed accept sequence, and the raw-moment
    accumulator and its (regularized) variance, at rtol/atol 1e-6."""
    da_j, da_t = jhmc.da_init(jnp.asarray(0.1)), hmc.da_init(0.1)
    for a in (0.3, 0.9, 0.75, 1.0, 0.0, 0.81):
        da_j = jhmc.da_update(da_j, jnp.asarray(a))
        da_t = hmc.da_update(da_t, t(a))
        for got, want in zip(da_t, da_j):
            close(got, want)
    xs = np.random.default_rng(0).standard_normal((3, 8, 4)).astype(
        np.float32)
    m_j, m_t = jhmc.moments_init(4), hmc.moments_init(4)
    for x in xs:
        m_j, m_t = jhmc.moments_update(m_j, x), hmc.moments_update(m_t, t(x))
    for got, want in zip(m_t, m_j):
        close(got, want)
    for reg in (True, False):
        close(hmc.moments_variance(m_t, reg), jhmc.moments_variance(m_j, reg))
    # psum_axis: a group of one rank reduces over the local chains only;
    # a bare axis name has no mesh to resolve it
    from cugp_tpu_torch.parallel import collectives

    one = collectives.Group([0], None)
    for got, want in zip(hmc.moments_update(m_t, t(xs[0]), psum_axis=one),
                         hmc.moments_update(m_t, t(xs[0]))):
        assert torch.equal(got, want)
    with pytest.raises(TypeError, match="mesh.group"):
        hmc.moments_update(m_t, t(xs[0]), psum_axis="dp")


def test_leapfrog_matches_jax():
    """10 leapfrog steps of 4 chains on a correlated Gaussian (eps 0.1, a
    diagonal inverse mass) against jax.vmap of JAX's, rtol/atol 1e-6."""
    lp_j, lp_t = gauss_pair(np.zeros(3, np.float32), COV_INV)
    rng = np.random.default_rng(1)
    q, p = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    inv_mass = np.array([1.0, 0.5, 2.0], np.float32)
    grad = jax.vmap(lp_j)(q)[1]
    got = hmc.leapfrog(t(q), t(p), t(np.asarray(grad)), t(0.1), t(inv_mass),
                       lp_t, 10)
    want = jax.vmap(lambda q, p, g: jhmc.leapfrog(
        q, p, g, 0.1, inv_mass, lp_j, 10))(q, p, grad)
    for a, b in zip(got, want):
        close(a, b)


def _hmc_draws(keys, dim):
    """hmc_kernel's momentum (hmc.py:123-124: split into the momentum key,
    then the accept key) and accept uniform, per chain."""
    mom, uni = [], []
    for k in keys:
        k_mom, k_acc = jax.random.split(k)
        mom.append(np.asarray(jax.random.normal(k_mom, (dim,))))
        uni.append(float(jax.random.uniform(k_acc)))
    return np.stack(mom), np.asarray(uni, np.float32)


def test_hmc_transition_matches_jax():
    """One hmc_kernel transition of 8 chains (8 leapfrog steps at eps 1.2,
    so that some proposals are rejected) with JAX's momenta and accept
    uniforms fed in: positions, log densities, gradients and accept
    probabilities at rtol/atol 1e-6, the same accept decisions."""
    lp_j, lp_t = gauss_pair(np.zeros(3, np.float32), COV_INV)
    q0 = np.random.default_rng(2).standard_normal((8, 3)).astype(np.float32)
    logp0, grad0 = jax.vmap(lp_j)(q0)
    keys = jax.random.split(jax.random.key(3), 8)
    inv_mass = np.array([1.0, 0.5, 2.0], np.float32)
    s_j, a_j = jax.vmap(lambda s, k: jhmc.hmc_kernel(
        s, k, 1.2, inv_mass, lp_j, 8))(jhmc.HMCState(q0, logp0, grad0), keys)
    mom, uni = _hmc_draws(keys, 3)
    state = hmc.HMCState(t(q0), t(np.asarray(logp0)), t(np.asarray(grad0)))
    s_t, a_t = hmc.hmc_kernel(state, hmc.Draws(normals=[mom],
                                               uniforms=[uni]),
                              t(1.2), t(inv_mass), lp_t, 8)
    acc = uni < np.asarray(a_j)
    assert acc.any() and not acc.all()
    np.testing.assert_array_equal(uni < a_t.numpy(), acc)
    for a, b in zip(s_t, s_j):
        close(a, b)
    close(a_t, a_j)


def _run_draws(windows, n_chains, dim):
    """The draws of a JAX driver: for each (key, transitions) window, the
    key split into a key a transition, each of those into a key a chain
    (hmc.py:176 and :253), and each chain's key into the momentum and
    accept keys (hmc.py:123-124). Returned in the order the port's driver
    takes them: each transition's (C, D) momenta and (C,) accept
    uniforms, window after window."""

    def chain(k):
        k_mom, k_acc = jax.random.split(k)
        return jax.random.normal(k_mom, (dim,)), jax.random.uniform(k_acc)

    normals, uniforms = [], []
    for k, steps in windows:
        for ks in jax.random.split(k, steps):
            mom, uni = jax.vmap(chain)(jax.random.split(ks, n_chains))
            normals.append(np.array(mom))
            uniforms.append(np.array(uni))
    return normals, uniforms


@pytest.mark.parametrize("driver", ["adaptive_run", "retune_eps"])
def test_drivers_match_jax(driver):
    """The port's drivers with the fixed-step kernel (make_hmc_kernel,
    step_jitter 0) against JAX's with its draws replayed, on the
    correlated Gaussian: 8 chains, 8 leapfrog steps.

    adaptive_run (warmup_adapt over its three windows, 16 transitions,
    then sample_segment, 8 draws; JAX: one key for each window and one
    for the draws, hmc.py:262): the same accept decisions at every draw,
    the draws at rtol 1e-5 / atol 3e-5 (measured 1.4e-5: fp32 rounding
    of the step size through 24 transitions), the step size and inverse
    mass at rtol/atol 1e-5. retune_eps (12 transitions from eps0 0.3;
    the dual averaging's second step, near 10 eps0, is rejected by every
    chain): the state at rtol 1e-5 / atol 5e-5 (measured 2.7e-05), the
    step size at rtol/atol 1e-5. From a larger eps0 the leapfrog runs
    near its stability limit, which amplifies fp32 rounding: from 1.0
    the two part by 1.9e-3.

    The target is a Gaussian because its fp32 gradient is exact to an
    ulp: the GP log density's fp32 gradient moves by ~1e-4 under a
    one-ulp change of q, so two fp32 implementations of one GP posterior
    part after a few transitions whatever the driver. The drivers do not
    look at the target."""
    n_chains, n_lf, dim = 8, 8, 3
    lp_j, lp_t = gauss_pair(np.zeros(dim, np.float32), COV_INV)
    q0 = np.random.default_rng(8).standard_normal(
        (n_chains, dim)).astype(np.float32)
    key = jax.random.key(9)
    state_j = jhmc.HMCState(q0, *jax.vmap(lp_j)(q0))
    kernel_j = jhmc.make_hmc_kernel(lp_j, n_lf)
    kernel = hmc.make_hmc_kernel(lp_t, n_lf, step_jitter=0.0)
    state = hmc.init_state(t(q0), lp_t)
    if driver == "retune_eps":
        inv_mass = np.array([0.5, 1.0, 2.0], np.float32)
        s_j, eps_j = jhmc.retune_eps(state_j, key, kernel_j, 0.3, inv_mass,
                                     num_steps=12)
        normals, uniforms = _run_draws([(key, 12)], n_chains, dim)
        s_t, eps = hmc.retune_eps(
            state, hmc.Draws(normals=normals, uniforms=uniforms), kernel,
            0.3, t(inv_mass), num_steps=12)
        for a, b in zip(s_t, s_j):
            close(a, b, rtol=1e-5, atol=5e-5)
        close(eps, eps_j, rtol=1e-5, atol=1e-5)
        return
    num_warmup, num_samples = 16, 8
    out_j = jhmc.adaptive_run(state_j, key, kernel_j, num_warmup,
                              num_samples, 0.1, 0.8)
    _, k1, k2, k3, k4 = jax.random.split(key, 5)
    normals, uniforms = _run_draws(
        [(k1, 4), (k2, 8), (k3, 4), (k4, num_samples)], n_chains, dim)
    out = hmc.adaptive_run(state, hmc.Draws(normals=normals,
                                            uniforms=uniforms),
                           kernel, num_warmup, num_samples, 0.1, 0.8)
    u = np.stack(uniforms[-num_samples:])
    acc_j = u < np.asarray(out_j["aux"])
    assert not acc_j.all()
    np.testing.assert_array_equal(u < out["aux"].numpy(), acc_j)
    close(out["samples_flat"], out_j["samples_flat"], rtol=1e-5, atol=3e-5)
    close(out["aux"], out_j["aux"], rtol=1e-5, atol=1e-5)
    close(out["eps"], out_j["eps"], rtol=1e-5, atol=1e-5)
    close(out["inv_mass"], out_j["inv_mass"], rtol=1e-5, atol=1e-5)


def _nuts_draws(keys, dim, max_depth):
    """nuts_kernel's draws per chain, in the port's order: the momentum
    (nuts.py:181-182, the first of three keys; the third seeds the
    doublings), then for each doubling its direction uniform, one uniform
    a leaf (the subtree key split once a leaf) and its merge uniform.
    Returns the (C, dim) momenta and the list of (C,) uniforms."""
    mom, seqs = [], []
    for k in keys:
        k_mom, _, k_c = jax.random.split(k, 3)
        mom.append(np.asarray(jax.random.normal(k_mom, (dim,))))
        seq = []
        for depth in range(max_depth):
            k_c, k_dir, k_sub, k_merge = jax.random.split(k_c, 4)
            seq.append(float(jax.random.uniform(k_dir)))
            for _ in range(1 << depth):
                k_sub, k_sel = jax.random.split(k_sub)
                seq.append(float(jax.random.uniform(k_sel)))
            seq.append(float(jax.random.uniform(k_merge)))
        seqs.append(seq)
    uniforms = np.asarray(seqs, np.float32).T  # (draws, C)
    return np.stack(mom), list(uniforms)


def test_nuts_transition_matches_jax():
    """One NUTS transition of 6 chains on a 2-D correlated Gaussian
    (max_depth 5, eps 0.3) with JAX's draws fed in: the same tree depth and
    leapfrog count for every chain, the chosen state and the accept
    statistic at rtol/atol 1e-6."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
    lp_j, lp_t = gauss_pair(np.zeros(2, np.float32),
                            np.linalg.inv(cov).astype(np.float32))
    q0 = np.random.default_rng(4).standard_normal((6, 2)).astype(np.float32)
    logp0, grad0 = jax.vmap(lp_j)(q0)
    keys = jax.random.split(jax.random.key(5), 6)
    inv_mass = np.ones(2, np.float32)
    s_j, info_j = jax.vmap(lambda s, k: jnuts.nuts_kernel(
        s, k, 0.3, inv_mass, lp_j, max_depth=5))(
            jhmc.HMCState(q0, logp0, grad0), keys)
    mom, uniforms = _nuts_draws(keys, 2, 5)
    state = hmc.HMCState(t(q0), t(np.asarray(logp0)), t(np.asarray(grad0)))
    s_t, info_t = nuts.nuts_kernel(
        state, hmc.Draws(normals=[mom], uniforms=uniforms), 0.3,
        t(inv_mass), lp_t, max_depth=5)
    np.testing.assert_array_equal(info_t.depth.numpy(), info_j.depth)
    np.testing.assert_array_equal(info_t.n_leapfrog.numpy(),
                                  info_j.n_leapfrog)
    assert len(set(np.asarray(info_j.depth).tolist())) > 1  # chains differ
    for a, b in zip(s_t, s_j):
        close(a, b)
    close(info_t.accept_prob, info_j.accept_prob)
    np.testing.assert_array_equal(info_t.diverging.numpy(), info_j.diverging)


def test_rhat_and_ess_match_jax():
    """Split R-hat and the crude ESS on fixed AR(1) draws (400, 4), in
    float64 on both sides, at rtol 1e-6."""
    rng = np.random.default_rng(6)
    x = np.zeros((400, 4))
    for i in range(1, 400):
        x[i] = 0.7 * x[i - 1] + rng.standard_normal(4)
    with jax.enable_x64(True):
        r_j = float(jsampling.potential_scale_reduction(jnp.asarray(x)))
        e_j = float(jsampling.effective_sample_size(jnp.asarray(x)))
    xt = torch.tensor(x)
    close(sampling.potential_scale_reduction(xt), r_j, atol=0.0)
    close(sampling.effective_sample_size(xt), e_j, atol=0.0)


@pytest.fixture(scope="module")
def sinusoid():
    X, y, _ = jsyn.sinusoid_1d(n=32, noise_std=0.1, seed=0)
    return X.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("rank", ["meanfield", "fullrank"])
def test_vi_elbo_matches_jax(sinusoid, rank):
    """The negative ELBO of 4 draws (one batched LML in the port) and its
    gradient in the variational parameters, against JAX's with the same
    standard-normal draws (jax.random.normal of one key): value at rtol
    1e-5, gradient at rtol 1e-4 (atol 1e-4), the LML's bars elsewhere."""
    X, y = sinusoid
    init = jk.init_params(d=1, lengthscale=0.8, noise_var=0.05)
    q0, unravel = jax.flatten_util.ravel_pytree(init)
    dim, num_mc = q0.shape[0], 4
    vp = {"mean": np.asarray(q0) + 0.1}
    if rank == "meanfield":
        vp["log_scale"] = np.full(dim, -1.5, np.float32)
    else:
        vp["chol"] = np.concatenate([np.full(dim, -1.5), [0.1, -0.2, 0.05]]
                                    ).astype(np.float32)
    key = jax.random.key(7)

    def logprob(q):
        return (jgp.log_marginal_likelihood(unravel(q), X, y)
                + jhmc.default_log_prior(q))

    def neg_elbo_j(vp):
        if rank == "meanfield":
            qs = jvi._sample_meanfield(vp, key, num_mc, dim)
            ent = jvi._entropy_meanfield(vp["log_scale"])
        else:
            qs = jvi._sample_fullrank(vp, key, num_mc, dim)
            ent = jvi._entropy_fullrank(vp["chol"], dim)
        return -(jnp.mean(jax.vmap(logprob)(qs)) + ent)

    val_j, g_j = jax.value_and_grad(neg_elbo_j)(vp)
    eps = np.asarray(jax.random.normal(key, (num_mc, dim)))
    lpg, unravel_t, _ = sampling.make_flat_logprob(
        params_from_numpy(init, "cpu"), t(X), t(y))
    from cugp_tpu_torch.models import exact_gp as tgp

    def logprob_t(q):
        return tgp.log_marginal_likelihood(unravel_t(q), t(X), t(y)) + \
            hmc.default_log_prior(q)

    vp_t = {k: t(v).requires_grad_(True) for k, v in vp.items()}
    val = vi.neg_elbo(vp_t, t(eps), logprob_t, rank, dim)
    grads = torch.autograd.grad(val, list(vp_t.values()))
    close(val, val_j, rtol=1e-5, atol=0.0)
    for g, k in zip(grads, vp_t):
        close(g, g_j[k], rtol=1e-4, atol=1e-4)
    if rank == "fullrank":
        close(vi._chol_from_flat(t(vp["chol"]), dim),
              jvi._chol_from_flat(vp["chol"], dim))


def test_step_jitter_breaks_the_resonance():
    """On a unit Gaussian with eps = 2 sin(pi / 32), 32 leapfrog steps are
    one whole period of the leapfrog map: at a fixed step size (the JAX
    kernel: hmc_kernel at eps) every transition returns each chain to
    where it was; with make_hmc_kernel's default jitter the chains move and their
    draws have about unit variance (0.6-1.6 over 8 chains x 100 draws).
    A jittered transition equals hmc_kernel at each chain's drawn step
    size, its uniform drawn first."""
    _, lp = gauss_pair(np.zeros(1, np.float32), np.eye(1, dtype=np.float32))
    eps = t(2.0 * np.sin(np.pi / 32))
    q0 = torch.linspace(-1.5, 1.5, 8)[:, None]
    state = hmc.init_state(q0, lp)
    ones = torch.ones(1)
    g = torch.Generator().manual_seed(0)
    fixed = hmc.make_hmc_kernel(lp, n_leapfrog=32, step_jitter=0.0)
    _, qs, _, _ = hmc.sample_segment(state, g, fixed, eps, ones, 20)
    assert float((qs - q0).abs().max()) < 1e-3
    jit = hmc.make_hmc_kernel(lp, n_leapfrog=32)
    _, qs, _, _ = hmc.sample_segment(state, g, jit, eps, ones, 100)
    assert 0.6 < float(qs.var()) < 1.6

    u, mom, acc = torch.rand(8), torch.randn(8, 1), torch.rand(8)
    got = jit(state, hmc.Draws(normals=[mom], uniforms=[u, acc]), eps, ones)
    eps_c = eps * (1.0 + hmc.STEP_JITTER * (2.0 * u - 1.0))[:, None]
    want = hmc.hmc_kernel(state, hmc.Draws(normals=[mom], uniforms=[acc]),
                          eps_c, ones, lp, 32)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])


def test_retune_eps_recenters_the_step_size():
    """retune_eps from eps0 = 3 on a standard Gaussian, where the leapfrog
    is unstable (eps > 2), (8 chains, 16 leapfrog steps, 32 re-tune
    transitions) returns a stable step size under which the accept rate
    is 0.5-1.0."""
    _, lp = gauss_pair(np.zeros(3, np.float32), np.eye(3, dtype=np.float32))
    g = torch.Generator().manual_seed(7)
    kernel = hmc.make_hmc_kernel(lp, n_leapfrog=16)
    state = hmc.init_state(torch.randn(8, 3, generator=g), lp)
    state, eps = hmc.retune_eps(state, g, kernel, 3.0, torch.ones(3),
                                num_steps=32)
    assert float(eps) < 2.0
    _, _, aprobs, _ = hmc.sample_segment(state, g, kernel, eps,
                                         torch.ones(3), 20)
    assert 0.5 < float(aprobs.mean()) <= 1.0


def _stats(qs):
    qs = qs.reshape(-1, qs.shape[-1]).numpy()
    return qs.mean(axis=0), qs.std(axis=0)


def test_hmc_standard_gaussian():
    """test_samplers.py's bars: accept in (0.4, 1], mean within 0.2,
    std within 0.15 of 1."""
    _, lp = gauss_pair(np.zeros(3, np.float32), np.eye(3, dtype=np.float32))
    g = torch.Generator().manual_seed(0)
    out = hmc.run_hmc(torch.randn(8, 3, generator=g), g, lp, n_leapfrog=16,
                      num_warmup=200, num_samples=500, eps0=0.2)
    mean, std = _stats(out["samples_flat"])
    assert 0.4 < float(out["accept_rate"]) <= 1.0
    np.testing.assert_allclose(mean, 0.0, atol=0.2)
    np.testing.assert_allclose(std, 1.0, atol=0.15)


def test_hmc_correlated_gaussian_mass_adaptation():
    """Anisotropic target: the std within 25% of each scale, inv_mass
    within 60% of the variances (test_samplers.py's bars)."""
    scales = np.array([1.0, 0.05], np.float32)
    _, lp = gauss_pair(np.zeros(2, np.float32), np.diag(1.0 / scales ** 2))
    g = torch.Generator().manual_seed(1)
    out = hmc.run_hmc(0.1 * torch.randn(8, 2, generator=g), g, lp,
                      n_leapfrog=16, num_warmup=400, num_samples=600,
                      eps0=0.05)
    _, std = _stats(out["samples_flat"])
    np.testing.assert_allclose(std, scales, rtol=0.25)
    np.testing.assert_allclose(out["inv_mass"].numpy(), scales ** 2,
                               rtol=0.6)


def test_nuts_standard_gaussian():
    """test_samplers.py's bars, and not every tree at the depth bound."""
    _, lp = gauss_pair(np.zeros(3, np.float32), np.eye(3, dtype=np.float32))
    g = torch.Generator().manual_seed(2)
    out = nuts.run_nuts(torch.randn(8, 3, generator=g), g, lp, max_depth=6,
                        num_warmup=200, num_samples=500, eps0=0.2)
    mean, std = _stats(out["samples_flat"])
    assert float(out["divergence_rate"]) < 0.05
    np.testing.assert_allclose(mean, 0.0, atol=0.2)
    np.testing.assert_allclose(std, 1.0, atol=0.15)
    assert float(out["mean_leapfrog"]) < 2 ** 6


def test_nuts_correlated_gaussian():
    """rho = 0.9: the empirical correlation within 0.1, std within 0.2."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
    _, lp = gauss_pair(np.zeros(2, np.float32),
                       np.linalg.inv(cov).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    out = nuts.run_nuts(torch.randn(8, 2, generator=g), g, lp, max_depth=7,
                        num_warmup=300, num_samples=600, eps0=0.1)
    qs = out["samples_flat"].reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.corrcoef(qs.T)[0, 1], 0.9, atol=0.1)
    np.testing.assert_allclose(qs.std(axis=0), 1.0, atol=0.2)


def _structure(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.fixture(scope="module")
def gps(sinusoid):
    X, y = sinusoid
    init = jax.tree.map(np.asarray, jk.default_init("rbf", d=1))
    gp_j = cugp_tpu.GP(kind="rbf")
    gp_j.X, gp_j.y = jnp.asarray(X), jnp.asarray(y)
    gp_j.params = init
    gp_t = cugp_tpu_torch.GP(kind="rbf", device="cpu").condition(
        X, y, params=init)
    return gp_j, gp_t


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_gp_sample_hyperparams_matches_jax_structure(gps, sampler):
    """GP.sample_hyperparams at n=32, 4 chains, 4 warm-up and 4 draws: the
    output's keys and shapes equal to JAX's, the draws finite."""
    gp_j, gp_t = gps
    kw = dict(num_samples=4, num_chains=4, num_warmup=4, sampler=sampler,
              max_tree_depth=3)
    out_j = gp_j.sample_hyperparams(key=jax.random.key(0), **kw)
    out_t = gp_t.sample_hyperparams(
        generator=torch.Generator().manual_seed(0), **kw)
    assert sorted(out_t) == sorted(out_j)
    assert _structure(out_t) == _structure(out_j)
    for leaf in jax.tree.leaves(out_t["samples"]):
        assert torch.isfinite(leaf).all()
    with pytest.raises(NotImplementedError, match="chain_block"):
        gp_t.sample_hyperparams(chain_block=4, **kw)


def test_gp_fit_vi_matches_jax_structure(gps):
    """GP.fit_vi (5 steps, 4 draws): keys and shapes of the result and of
    draw() equal to JAX's; explicit draws replay (two fits fed the same
    standard normals give the same ELBO trace bitwise)."""
    gp_j, gp_t = gps
    out_j = gp_j.fit_vi(steps=5, num_mc=4, key=jax.random.key(0))
    out_t = gp_t.fit_vi(steps=5, num_mc=4)
    assert sorted(out_t) == sorted(out_j)
    for k in ("vp", "elbo", "mean", "scale"):
        assert _structure(out_t[k]) == _structure(out_j[k])
    assert (_structure(out_t["draw"](None, 3))
            == _structure(out_j["draw"](jax.random.key(1), 3)))
    eps = [torch.randn(4, 3, generator=torch.Generator().manual_seed(i))
           for i in range(5)]
    a = gp_t.fit_vi(steps=5, num_mc=4, draws=hmc.Draws(normals=eps))
    b = gp_t.fit_vi(steps=5, num_mc=4, draws=hmc.Draws(normals=eps))
    assert torch.equal(a["elbo"], b["elbo"])
