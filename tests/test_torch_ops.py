"""Parity of the PyTorch port's kernel modules with the JAX package (CPU).

On CPU tensors each port wrapper runs its kernel's plain version
(cov_cuda.cov_tile_plain, chol_cuda.potrf_plain, trsm_cuda.trsm_plain);
the same float32 inputs, made with numpy from a seed, go through the
JAX covariance functions (XLA and Pallas in interpret mode). The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py. fp32 against fp32 across frameworks: rtol 1e-5,
atol 1e-6 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.ops import chol_pallas, trsm_pallas
from cugp_tpu.ops import kernels as jk
from cugp_tpu_torch.ops import chol_cuda, cov_cuda, trsm_cuda
from cugp_tpu_torch.ops import kernels as tk
from cugp_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BASE_KINDS = ("rbf", "matern12", "matern32", "matern52", "rq", "linear",
              "periodic")
COMPOSITE = "rbf*periodic+linear"
# every family at d=3; the d=1 and d > 32 (d=40) builds on a subset
COV_CASES = ([(k, 3) for k in BASE_KINDS + (COMPOSITE,)]
             + [(k, 1) for k in ("rbf", "matern12", "linear", "periodic")]
             + [(k, 40) for k in ("rbf", "matern32", "rq", "linear")])


def np_params(kind, d, seed):
    """The JAX default_init tree, each leaf shifted by a seeded offset."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (np.asarray(v, np.float32)
                   + rng.uniform(-0.3, 0.3, np.shape(v))).astype(np.float32),
        jk.default_init(kind, d=d))


def inputs(n, d, seed):
    """U(-1.5, 1.5) features over sqrt(d): unit-order scaled distances at
    every d, as a fitted lengthscale gives. (The rbf tile's fused exponent
    cross - s1/2 - s2/2 differs from the XLA version's clamped d2 by a few
    eps (s1 + s2), so unscaled d = 40 inputs would measure that gap.)"""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (n, d)) / np.sqrt(d)).astype(np.float32)


def matern12_slack(kind, X1, X2, params):
    """Extra absolute tolerance near coincident points for matern12.

    exp(-r) has slope -1 at r = 0, so the fp32 rounding of
    d2 = s1 + s2 - 2 cross (summed in another order by each framework)
    shows up as its square root: sf2 sqrt(8 eps (s1 + s2)) where d2 is
    tiny. Every other entry, and every other family, keeps ATOL.
    """
    if kind != "matern12":
        return ATOL
    ell = np.exp(np.asarray(params["log_lengthscale"], np.float64))
    a, b = X1 / ell, X2 / ell
    s12 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    d2 = np.maximum(s12 - 2 * a @ b.T, 0.0)
    sf2 = float(np.exp(params["log_signal_var"]))
    slack = 1.3 * sf2 * np.sqrt(8 * np.finfo(np.float32).eps * s12)
    return ATOL + np.where(d2 < 1e-2, slack, 0.0)


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), f"max abs err {err.max():.3e} ({bad.sum()} over)"


@pytest.mark.parametrize("kind,d", COV_CASES)
def test_train_covariance_matches_jax(kind, d):
    """Square build, n=300 (ragged), identity block beyond n_true=280."""
    P = np_params(kind, d, seed=d)
    X = inputs(300, d, seed=10 + d)
    K = tk.train_covariance(params_from_numpy(P, "cpu"), torch.tensor(X),
                            kind=kind, jitter=1e-6, n_true=280)
    K_xla = np.asarray(jk.train_covariance_xla(
        P, jnp.asarray(X), kind, 1e-6, n_true=280))
    tol = matern12_slack(kind, X, X, P)
    assert_close(K, K_xla, atol=tol)
    if d > 1:  # the Pallas tile at d=1 is the d=3 path with zero lanes
        K_pal = jk.train_covariance(P, jnp.asarray(X), kind, 1e-6,
                                    method="pallas", n_true=280)
        assert_close(K, K_pal, atol=tol)
    assert np.array_equal(K.numpy()[280:, 280:], np.eye(20, dtype=np.float32))
    assert not K.numpy()[280:, :280].any() and not K.numpy()[:280, 280:].any()


@pytest.mark.parametrize("kind,d", COV_CASES)
def test_cross_covariance_matches_jax(kind, d):
    """Cross build 300 x 70, rows of X1 at or beyond n_true=290 masked."""
    P = np_params(kind, d, seed=20 + d)
    X1, X2 = inputs(300, d, seed=30 + d), inputs(70, d, seed=40 + d)
    K = tk.cross_covariance(params_from_numpy(P, "cpu"), torch.tensor(X1),
                            torch.tensor(X2), kind=kind, n_true=290)
    K_xla = np.asarray(jk.cross_covariance_xla(
        P, jnp.asarray(X1), jnp.asarray(X2), kind, n_true=290))
    tol = matern12_slack(kind, X1, X2, P)
    assert_close(K, K_xla, atol=tol)
    if d > 1:
        K_pal = jk.cross_covariance(P, jnp.asarray(X1), jnp.asarray(X2),
                                    kind, method="pallas", n_true=290)
        assert_close(K, K_pal, atol=tol)
    assert not K.numpy()[290:].any()


@pytest.mark.parametrize("kind", ["rbf", "matern32", "rq", "linear",
                                  "periodic", COMPOSITE])
def test_covariance_gradient_matches_jax(kind):
    """CovTile's backward (VJP of the plain tile) against jax.grad of the
    JAX XLA covariance (the backward of its Pallas custom VJP), for <W, K>
    over every hyperparameter leaf and the inputs; rtol 1e-4 (two
    gradient formulas in fp32)."""
    d = 3
    P = np_params(kind, d, seed=5)
    X = inputs(120, d, seed=6)
    Xs = inputs(40, d, seed=7)
    W = np.random.default_rng(8).standard_normal((120, 120)).astype(
        np.float32)
    Wc = np.random.default_rng(9).standard_normal((120, 40)).astype(
        np.float32)

    def f_jax(p, x):
        K = jk.train_covariance(p, x, kind, 1e-6, method="xla", n_true=110)
        Kc = jk.cross_covariance(p, x, jnp.asarray(Xs), kind, method="xla",
                                 n_true=110)
        return jnp.sum(K * W) + jnp.sum(Kc * Wc)

    g_p, g_x = jax.grad(f_jax, argnums=(0, 1))(P, jnp.asarray(X))

    pt = params_from_numpy(P, "cpu")
    leaves = jax.tree.leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.tensor(X, requires_grad=True)
    K = tk.train_covariance(pt, xt, kind, 1e-6, n_true=110)
    Kc = tk.cross_covariance(pt, xt, torch.tensor(Xs), kind, n_true=110)
    f = torch.sum(K * torch.tensor(W)) + torch.sum(Kc * torch.tensor(Wc))
    grads = torch.autograd.grad(f, leaves + [xt])
    for got, want in zip(grads, jax.tree.leaves(g_p) + [g_x]):
        assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["linear", COMPOSITE])
def test_flatten_terms_matches_jax(kind):
    """Per-term amplitudes and unit-amplitude factor params, as the JAX
    twin lays them out (base-linear moves its bias under the amplitude)."""
    P = np_params(kind, 2, seed=11)
    got = tk.flatten_terms(params_from_numpy(P, "cpu"), kind)
    want = jk.flatten_terms(P, kind)
    assert len(got) == len(want)
    for (amp_t, fac_t), (amp_j, fac_j) in zip(got, want):
        assert_close(amp_t, amp_j)
        assert [b for b, _ in fac_t] == [b for b, _ in fac_j]
        for (_, ft), (_, fj) in zip(fac_t, fac_j):
            assert sorted(ft) == sorted(fj)
            for k in fj:
                assert_close(ft[k], fj[k])


def test_cov_tile_rejects_unported_kind():
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        cov_cuda.cov_tile(x, x, torch.ones(3), "periodic", True, 4, 4)
    with pytest.raises(ValueError):
        tk.train_covariance(tk.default_init("rbf", d=2), x, method="xla")


def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return ((q * eigs) @ q.T).astype(np.float32)


@pytest.mark.parametrize("n", [128, 256])
def test_potrf_plain_matches_pallas(n):
    """rtol 1e-4 (cond 1e3): both fp32 factors sit within cond * eps."""
    a = _spd(n, seed=n)
    # only the lower triangle may be read
    garbage = a + np.triu(np.full_like(a, 5.0), 1)
    L = chol_cuda.potrf(torch.tensor(garbage))
    L_pal = chol_pallas.potrf(jnp.asarray(a), interpret=True)
    assert_close(L, L_pal, rtol=1e-4, atol=1e-5)
    assert not np.triu(L.numpy(), 1).any()


def _tiled_potrf_model(a, T):
    """csrc/potrf.cu's tile loop in float32 PyTorch, for a CPU check of
    the schedule the kernel runs. Step k: the diagonal tile, identity
    padded past n, is factored right-looking (column j scaled by
    1 / sqrt(pivot), then a rank-1 update of the lower trailing part), as
    each panel owner does; every panel tile (i, k) is solved against it
    by substitution, rows in parallel (x_j = a_j / L_jj, then
    a_c -= x_j L_cj for c > j); every trailing tile (i, j), k < j <= i,
    gets A_ij -= L_ik L_jk^T. Only the lower triangle is read."""
    n = a.shape[0]
    nt = -(-n // T)
    A = a.clone()

    def tile(i, j):
        return A[i * T:min(n, (i + 1) * T), j * T:min(n, (j + 1) * T)]

    for k in range(nt):
        kb = min(T, n - k * T)
        D = torch.eye(T)
        D[:kb, :kb] = torch.tril(tile(k, k))
        rinv = torch.empty(T)
        for j in range(T):
            d = torch.sqrt(D[j, j])
            rinv[j] = 1.0 / d
            col = D[j + 1:, j] * rinv[j]
            D[j + 1:, j + 1:] -= torch.tril(torch.outer(col, col))
            D[j + 1:, j] = col
            D[j, j] = d
        L_kk = torch.tril(D)
        for i in range(k + 1, nt):
            P = tile(i, k)
            X = torch.zeros(T, T)
            X[:P.shape[0], :kb] = P
            for j in range(T):
                X[:, j] *= rinv[j]
                X[:, j + 1:] -= torch.outer(X[:, j], L_kk[j + 1:, j])
            P.copy_(X[:P.shape[0], :kb])
        tile(k, k).copy_(L_kk[:kb, :kb])
        for i in range(k + 1, nt):
            for j in range(k + 1, i + 1):
                tile(i, j).sub_(tile(i, k) @ tile(j, k).T)
    return torch.tril(A)


@pytest.mark.parametrize("T", [32, 64])
@pytest.mark.parametrize("n", [64, 128, 200, 256, 1000])
def test_potrf_tile_schedule_model(n, T):
    """The kernel's tile loop (one ragged tile at n=200 and 1000) against
    potrf_plain, and at n % 128 == 0 against the Pallas potrf; rtol 1e-4
    (cond 1e3: fp32 factors sit within cond * eps of each other)."""
    a = _spd(n, seed=n)
    garbage = a + np.triu(np.full_like(a, 5.0), 1)  # only the lower is read
    L = _tiled_potrf_model(torch.tensor(garbage), T)
    assert_close(L, chol_cuda.potrf_plain(torch.tensor(a)), rtol=1e-4,
                 atol=1e-5)
    if n in (128, 256):
        L_pal = chol_pallas.potrf(jnp.asarray(a), interpret=True)
        assert_close(L, L_pal, rtol=1e-4, atol=1e-5)


def test_potrf_in_place_block_and_batch():
    """potrf_ factors a diagonal block of a larger buffer in place and
    leaves the rest alone; a batch equals the loop over its blocks."""
    a = _spd(200, seed=1)
    buf = np.random.default_rng(2).standard_normal((400, 400)).astype(
        np.float32)
    buf[100:300, 100:300] = a
    bt = torch.tensor(buf)
    chol_cuda.potrf_(bt[100:300, 100:300])
    L_ref = np.linalg.cholesky(a.astype(np.float64))
    assert_close(bt[100:300, 100:300], L_ref, rtol=1e-4, atol=1e-5)
    out = bt.numpy().copy()
    out[100:300, 100:300] = buf[100:300, 100:300]
    assert np.array_equal(out, buf)
    batch = torch.tensor(np.stack([_spd(64, s) for s in range(3)]))
    Lb = chol_cuda.potrf(batch)
    assert torch.equal(Lb, torch.stack([chol_cuda.potrf(b) for b in batch]))


def test_potrf_nonpd_gives_nan():
    a = _spd(64, seed=3)
    a[40, 40] = -1.0
    L = chol_cuda.potrf(torch.tensor(a))
    assert not torch.isfinite(torch.diagonal(L)).all()


@pytest.mark.parametrize("left,transpose", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_trsm_plain_matches_pallas(left, transpose):
    n, k = 256, 40
    L = np.linalg.cholesky(_spd(n, seed=4, cond=1e2)).astype(np.float32)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, k) if left else (k, n)).astype(np.float32)
    X = trsm_cuda.trsm(torch.tensor(L), torch.tensor(B), left, transpose)
    X_pal = trsm_pallas.trsm(jnp.asarray(L), jnp.asarray(B), left=left,
                             transpose=transpose, interpret=True)
    assert_close(X, X_pal, rtol=1e-4, atol=1e-5)


TRSM_TILE = 64  # the tile edge T fixed in csrc/trsm.cu
_trtri_tile_jit = jax.jit(chol_pallas._trtri_tile)  # one compile per shape


def _trtri_tile_model(d):
    """csrc/trsm.cu's trtri pass on one lower (T, T) tile, as 2 x 2 blocks
    [[A, 0], [C, D]]: A^{-1} and D^{-1} by substitution (every column
    right-looking at once, x_j = v_j (1 / L_jj), then v_r -= L_rj x_j for
    r > j), then the corner -D^{-1} (C A^{-1})."""
    def subst(a):
        x = torch.eye(a.shape[0])
        for j in range(a.shape[0]):
            x[j] = x[j] * (1.0 / a[j, j])
            x[j + 1:] -= torch.outer(a[j + 1:, j], x[j])
        return x

    h = d.shape[0] // 2
    ai, di = subst(d[:h, :h]), subst(d[h:, h:])
    x = torch.zeros_like(d)
    x[:h, :h], x[h:, h:] = ai, di
    x[h:, :h] = -(di @ (d[h:, :h] @ ai))
    return x


def _blocked_trsm_model(l, b, T, transpose):
    """csrc/trsm.cu's schedule in float32 PyTorch: op(L) X = B with the
    diagonal tiles of tril(L), identity padded past n, inverted by the
    trtri pass; panels walked forward for L and backward for L^T, each a
    strip update over the solved tiles in ascending m, R_p = B_p - strip,
    then X_p = W_p R_p with W_p = op(L_pp)^{-1}."""
    n, k = b.shape
    nt = -(-n // T)
    lp = torch.eye(nt * T)
    lp[:n, :n] = torch.tril(l)
    x = torch.zeros(nt * T, k)
    x[:n] = b

    def rows(i):
        return slice(i * T, (i + 1) * T)

    for p in (range(nt - 1, -1, -1) if transpose else range(nt)):
        winv = _trtri_tile_model(lp[rows(p), rows(p)])
        w = winv.T if transpose else winv
        acc = torch.zeros(T, k)
        if transpose:
            for q in range(p + 1, nt):
                acc += lp[rows(q), rows(p)].T @ x[rows(q)]
        else:
            for q in range(p):
                acc += lp[rows(p), rows(q)] @ x[rows(q)]
        x[rows(p)] = w @ (x[rows(p)] - acc)
    return x[:n]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("k", [1, 9, 40])
@pytest.mark.parametrize("n", [8, 100, 128, 200, 256, 1000])
def test_trsm_tile_schedule_model(n, k, transpose):
    """The kernel's schedule (ragged last tile at n = 8, 100, 200, 1000;
    L with 7.0 above its diagonal) against trsm_plain, its tile inverse
    against chol_pallas._trtri_tile, and at n = 128, 256 the model
    against the Pallas TRSM. rtol 1e-4, atol 1e-5 at cond 1e2, as
    test_trsm_plain_matches_pallas: fp32 solves by different orders of
    summation (and through inverted tiles, whose error grows with
    cond(L_pp) <= cond(L)) sit within cond * eps of each other."""
    L = np.linalg.cholesky(_spd(n, seed=n + k, cond=1e2)).astype(np.float32)
    stale = torch.tensor(L + np.triu(np.full_like(L, 7.0), 1))
    B = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    X = _blocked_trsm_model(stale, torch.tensor(B), TRSM_TILE, transpose)
    want = trsm_cuda.trsm_plain(stale, torch.tensor(B), True, transpose)
    assert_close(X, want, rtol=1e-4, atol=1e-5)

    last = (n - 1) // TRSM_TILE * TRSM_TILE  # the ragged, padded tile
    for p0 in sorted({0, last}):
        d = torch.eye(TRSM_TILE)
        pb = min(TRSM_TILE, n - p0)
        d[:pb, :pb] = torch.tril(stale[p0:p0 + pb, p0:p0 + pb])
        assert_close(_trtri_tile_model(d),
                     _trtri_tile_jit(jnp.asarray(d.numpy())),
                     rtol=1e-4, atol=1e-5)
    if n in (128, 256):
        X_pal = trsm_pallas.trsm(jnp.asarray(L), jnp.asarray(B),
                                 transpose=transpose, interpret=True)
        assert_close(X, X_pal, rtol=1e-4, atol=1e-5)


def test_trsm_vector_and_strided_in_place():
    """A vector right-hand side, and trsm_ on a strided view of a larger
    buffer (the right-side solve of the Cholesky recursion)."""
    n = 256
    L = np.linalg.cholesky(_spd(n, seed=6, cond=1e2)).astype(np.float32)
    b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    x = trsm_cuda.trsm(torch.tensor(L), torch.tensor(b), True, True)
    x_pal = trsm_pallas.trsm(jnp.asarray(L), jnp.asarray(b), left=True,
                             transpose=True, interpret=True)
    assert_close(x, x_pal, rtol=1e-4, atol=1e-5)

    buf = np.random.default_rng(8).standard_normal((60, 2 * n)).astype(
        np.float32)
    bt = torch.tensor(buf)
    view = bt[5:55, ::2]  # (50, n), column stride 2
    trsm_cuda.trsm_(torch.tensor(L), view, left=False, transpose=True)
    want = trsm_pallas.trsm(jnp.asarray(L), jnp.asarray(buf[5:55, ::2]),
                            left=False, transpose=True, interpret=True)
    assert_close(bt[5:55, ::2], want, rtol=1e-4, atol=1e-5)
    rest = bt.numpy().copy()
    rest[5:55, ::2] = buf[5:55, ::2]
    assert np.array_equal(rest, buf)
