"""The port's batched dense paths against jax.vmap of the JAX functions
(CPU; the kernels' plain versions): covariance builds, the Cholesky and
the three solves, the LML and its gradient, and the per-chain jitter
ladder, with hyperparameters (or matrices) carrying a leading batch of
B = 4 at n = 64. Each batched result also equals the unbatched port call
on its element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.models import exact_gp as jgp
from cugp_tpu.ops import cholesky as jchol
from cugp_tpu.ops import kernels as jk
from cugp_tpu.ops import trsm as jtrsm
from cugp_tpu_torch.models import exact_gp as tgp
from cugp_tpu_torch.ops import cholesky as tchol
from cugp_tpu_torch.ops import kernels as tk
from cugp_tpu_torch.ops import trsm as ttrsm
from cugp_tpu_torch.utils.params import params_from_numpy, tree_leaves
from tests.test_torch_ops import assert_close, inputs, matern12_slack

torch.set_num_threads(1)

B, N, D = 4, 64, 2
KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "periodic",
         "linear", "rbf*periodic+matern32")


def batched_params(kind, seed):
    """JAX's default_init with a leading batch of B, each element's leaves
    shifted by its own seeded offset."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v, np.float32)[None]
                   + rng.uniform(-0.3, 0.3, (B,) + np.shape(v))
                   ).astype(np.float32),
        jk.default_init(kind, d=D))


def element(P, b):
    return jax.tree.map(lambda v: v[b], P)


def spd_batch(n, seed):
    g = np.random.default_rng(seed).standard_normal((B, n, n))
    return (g @ g.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def slack(kind, X1, X2, P):
    """matern12's near-coincident slack of test_torch_ops, per element."""
    return np.stack([np.broadcast_to(matern12_slack(kind, X1, X2,
                                                    element(P, b)),
                                     (X1.shape[0], X2.shape[0]))
                     for b in range(B)])


@pytest.mark.parametrize("kind", KINDS)
def test_batched_covariance_matches_vmap_jax(kind):
    """train_covariance and cross_covariance with batched params: values
    against jax.vmap of the JAX XLA builders at rtol 1e-5 (atol 1e-6, and
    matern12's slack near r = 0); each element equal to the unbatched port
    build bitwise."""
    P = batched_params(kind, seed=1)
    X, Xs = inputs(N, D, seed=2), inputs(20, D, seed=3)
    pt = params_from_numpy(P, "cpu")
    K = tk.train_covariance(pt, t(X), kind, 1e-6)
    Kc = tk.cross_covariance(pt, t(X), t(Xs), kind)
    K_j = jax.vmap(lambda p: jk.train_covariance(p, X, kind, 1e-6,
                                                 method="xla"))(P)
    Kc_j = jax.vmap(lambda p: jk.cross_covariance(p, X, Xs, kind,
                                                  method="xla"))(P)
    assert K.shape == (B, N, N) and Kc.shape == (B, N, 20)
    assert_close(K, K_j, atol=slack(kind, X, X, P))
    assert_close(Kc, Kc_j, atol=slack(kind, X, Xs, P))
    for b in range(B):
        pe = params_from_numpy(element(P, b), "cpu")
        assert torch.equal(K[b], tk.train_covariance(pe, t(X), kind, 1e-6))
        assert torch.equal(Kc[b], tk.cross_covariance(pe, t(X), t(Xs), kind))


@pytest.mark.parametrize("kind", ["rbf", "matern32", "periodic",
                                  "rbf*periodic+matern32"])
def test_batched_covariance_gradient_matches_vmap_jax(kind):
    """The gradient of <W_b, K_b> over every batched leaf against
    jax.vmap(jax.grad(...)), rtol 1e-4, atol 1e-4 (test_torch_ops' bars
    for the unbatched gradient)."""
    P = batched_params(kind, seed=4)
    X = inputs(N, D, seed=5)
    W = np.random.default_rng(6).standard_normal((B, N, N)).astype(
        np.float32)

    def f_jax(p, w):
        return jnp.sum(jk.train_covariance(p, X, kind, 1e-6, method="xla")
                       * w)

    g_j = jax.vmap(jax.grad(f_jax))(P, W)
    pt = params_from_numpy(P, "cpu")
    leaves = tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    f = torch.sum(tk.train_covariance(pt, t(X), kind, 1e-6) * t(W))
    grads = torch.autograd.grad(f, leaves)
    want = tree_leaves(jax.tree.map(np.asarray, g_j))
    for got, w in zip(grads, want):
        assert_close(got, w, rtol=1e-4, atol=1e-4)


def test_batched_cholesky_and_solves_match_vmap_jax():
    """cholesky and solve_lx / solve_ltx / solve_xlt (matrix and vector
    right-hand sides) on a (B, n, n) batch against jax.vmap of the JAX XLA
    routes at rtol 1e-5 (atol 1e-6), each element equal to the unbatched
    port call bitwise; the Cholesky gradient of <W, L> against
    jax.vmap(jax.grad) at rtol 1e-4 (atol 1e-5)."""
    A = spd_batch(N, seed=7)
    rng = np.random.default_rng(8)
    Bm = rng.standard_normal((B, N, 5)).astype(np.float32)
    Bv = rng.standard_normal((B, N)).astype(np.float32)
    Br = rng.standard_normal((B, 5, N)).astype(np.float32)
    L = tchol.cholesky(t(A))
    L_j = jax.vmap(lambda a: jchol.cholesky(a, method="xla"))(A)
    assert_close(L, L_j)
    for b in range(B):
        assert torch.equal(L[b], tchol.cholesky(t(A[b])))
    Lj = np.asarray(L_j)
    for name, rhs in (("solve_lx", Bm), ("solve_ltx", Bm), ("solve_lx", Bv),
                      ("solve_ltx", Bv), ("solve_xlt", Br)):
        got = getattr(ttrsm, name)(L, t(rhs))
        want = jax.vmap(getattr(jtrsm, name))(Lj, rhs)
        assert got.shape == rhs.shape
        assert_close(got, want)
        for b in range(B):
            assert torch.equal(got[b], getattr(ttrsm, name)(L[b], t(rhs[b])))

    W = rng.standard_normal((B, N, N)).astype(np.float32)
    g_j = jax.vmap(jax.grad(lambda a, w: jnp.sum(
        jchol.cholesky(a, method="xla") * w)))(A, W)
    a = t(A).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(tchol.cholesky(a) * t(W)), a)
    # the rules differ (Murray's symmetric average against XLA's), so both
    # gradients are held as their symmetric parts
    sym = 0.5 * (np.asarray(g_j) + np.asarray(g_j).transpose(0, 2, 1))
    assert_close(0.5 * (g + g.mT), sym, rtol=1e-4, atol=1e-5)


def test_batched_recursion_above_the_base_block():
    """At n = 1100 the Cholesky and the solves recurse (split at 512) with
    batched GEMMs (baddbmm_); a batch of 2 against the unbatched calls at
    rtol 1e-5 (atol 1e-6; the batched and unbatched GEMMs may sum in
    another order)."""
    n = 1100
    A = spd_batch(n, seed=9)[:2]
    L = tchol.cholesky(t(A))
    rhs = np.random.default_rng(10).standard_normal((2, n, 3)).astype(
        np.float32)
    X1, X2 = ttrsm.solve_lx(L, t(rhs)), ttrsm.solve_ltx(L, t(rhs))
    for b in range(2):
        Lb = tchol.cholesky(t(A[b]))
        assert_close(L[b], Lb.numpy())
        assert_close(X1[b], ttrsm.solve_lx(Lb, t(rhs[b])).numpy())
        assert_close(X2[b], ttrsm.solve_ltx(Lb, t(rhs[b])).numpy())


@pytest.mark.parametrize("kind", ["rbf", "matern12", "periodic",
                                  "rbf*periodic+matern32"])
def test_batched_lml_matches_vmap_jax(kind):
    """log_marginal_likelihood with batched params returns (B,): against
    jax.vmap of the JAX LML at rtol 1e-5, its gradient against
    jax.vmap(jax.grad) at rtol 1e-4 (atol 1e-4 for components near 0),
    and each element against the unbatched port LML at rtol 1e-6."""
    P = batched_params(kind, seed=11)
    X = inputs(N, D, seed=12)
    y = np.sin(3.0 * X[:, 0]) + 0.1 * np.random.default_rng(13).standard_normal(
        N).astype(np.float32)
    y = y.astype(np.float32)
    lml_j, g_j = jax.vmap(jax.value_and_grad(
        lambda p: jgp.log_marginal_likelihood(p, X, y, kind=kind)))(P)
    pt = params_from_numpy(P, "cpu")
    leaves = tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lml = tgp.log_marginal_likelihood(pt, t(X), t(y), kind=kind)
    assert lml.shape == (B,)
    grads = torch.autograd.grad(lml.sum(), leaves)
    assert_close(lml, lml_j, rtol=1e-5, atol=0.0)
    for got, want in zip(grads, tree_leaves(jax.tree.map(np.asarray, g_j))):
        assert_close(got, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        for b in range(B):
            one = tgp.log_marginal_likelihood(
                params_from_numpy(element(P, b), "cpu"), t(X), t(y),
                kind=kind)
            assert_close(lml[b], one.numpy(), rtol=1e-6, atol=0.0)


def test_safe_cholesky_per_chain_matches_vmap_jax():
    """One element of the batch has a negative eigenvalue (-1e-6): its
    first factor is not finite, so it alone gets the retry's jitter
    (1e-4 sf2 = 1e-2, leaving it with cond ~ 200) and comes out finite;
    the others keep the bits of their first factor. All against jax.vmap
    of JAX's ladder at rtol 1e-5 (atol 1e-6)."""
    rng = np.random.default_rng(14)
    A = spd_batch(N, seed=15).astype(np.float64)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    lam = np.linspace(-1e-6, 2.0, N)
    A[2] = (q * lam) @ q.T
    A = A.astype(np.float32)
    sf2 = np.array([1.0, 2.0, 100.0, 0.5], np.float32)
    L = tgp.safe_cholesky(t(A), t(sf2))
    L_j = jax.vmap(lambda a, s: jgp.safe_cholesky(a, s, method="xla"))(A, sf2)
    assert not torch.isfinite(tchol.cholesky(t(A[2]))).all()
    assert torch.isfinite(L).all()
    assert_close(L, L_j)
    for b in (0, 1, 3):
        assert torch.equal(L[b], tchol.cholesky(t(A[b])))
    assert torch.equal(L[2], tgp.safe_cholesky(t(A[2]), t(sf2[2])))


@pytest.mark.parametrize("q", [(0.0, -20.0, 0.0), (0.5, -14.0, 1.0)])
def test_ladder_gradient_where_jax_gives_nan(q):
    """sinusoid_1d(n=128), rbf, (log lengthscale, log noise variance, log
    signal variance) = q: the first fp32 factor is not finite, so the
    jitter ladder retries at +1e-4 sf2. JAX's LML returns the retried
    value with a NaN gradient (its lax.cond differentiates through the
    failed factor too; ROADMAP.md section 3). The port's value and
    gradient are bitwise those of its LML built with jitter 1.01e-4 and
    no ladder: finite, and only the retried factor in the graph."""
    from cugp_tpu.data import synthetic as jsyn

    X, y, _ = jsyn.sinusoid_1d(n=128, noise_std=0.1, seed=0)
    X, y = X.astype(np.float32), y.astype(np.float32)
    p = {"log_lengthscale": np.array([q[0]], np.float32),
         "log_noise_var": np.float32(q[1]),
         "log_signal_var": np.float32(q[2])}
    val_j, g_j = jax.value_and_grad(
        lambda p: jgp.log_marginal_likelihood(p, X, y))(p)
    assert np.isfinite(float(val_j))
    assert all(np.isnan(np.asarray(v)).all() for v in jax.tree.leaves(g_j))
    pt = params_from_numpy(p, "cpu")
    assert not torch.isfinite(tchol.cholesky(
        tk.train_covariance(pt, t(X)))).all()
    val, g = tgp.lml_value_and_grad(pt, t(X), t(y))
    val2, g2 = tgp.lml_value_and_grad(pt, t(X), t(y), jitter=1.01e-4,
                                      safe=False)
    assert torch.equal(val, val2)
    for a, b in zip(tree_leaves(g), tree_leaves(g2)):
        assert torch.isfinite(a).all() and torch.equal(a, b)
