"""Parity of the port's recursive Cholesky and solves with the JAX package.

Both recursions split at blocking.split_point; with the base-case size
shrunk to 256 on both sides (as tests/ops/test_cholesky.py does for the
JAX recursion) n=640 runs two levels of split/TRSM/SYRK in each package.
On CPU tensors the port's base cases are its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.ops import cholesky as jchol
from cugp_tpu.ops import trsm as jtrsm
from cugp_tpu_torch.ops import cholesky as tchol
from cugp_tpu_torch.ops import trsm as ttrsm

torch.set_num_threads(1)


@pytest.fixture
def small_base(monkeypatch):
    for mod in (jchol, jtrsm, tchol, ttrsm):
        monkeypatch.setattr(mod, "_BASE", 256)
    for mod in (jchol, tchol):
        monkeypatch.setattr(mod, "_SYRK_FULL", 256)


def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return ((q * eigs) @ q.T).astype(np.float32)


def assert_normwise(got, want, rtol=1e-5):
    """max |got - want| <= rtol * max |want|: solutions and gradients have
    entries that cancel, where an elementwise relative bar means nothing."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _gram(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def test_recursive_cholesky_matches_jax(small_base):
    """rtol 2e-5: the same splits in fp32 on both sides."""
    a = _gram(640, seed=0)
    l_t = tchol.cholesky(torch.tensor(a))
    l_j = np.asarray(jchol.cholesky(jnp.asarray(a), method="blocked"))
    np.testing.assert_allclose(l_t.numpy(), l_j, rtol=2e-5, atol=2e-5)
    assert not np.triu(l_t.numpy(), 1).any()


def test_cholesky_reads_only_the_lower_triangle(small_base):
    a = _gram(640, seed=1)
    junk = a + np.triu(np.full_like(a, 9.0), 1)
    np.testing.assert_array_equal(tchol.cholesky(torch.tensor(junk)).numpy(),
                                  tchol.cholesky(torch.tensor(a)).numpy())


@pytest.mark.parametrize("name,vec", [
    ("solve_lx", False), ("solve_ltx", False), ("solve_xlt", False),
    ("cho_solve", False), ("solve_lx", True), ("solve_ltx", True),
    ("cho_solve", True)])
def test_recursive_solves_match_jax(small_base, name, vec):
    n = 640
    l = np.linalg.cholesky(_spd(n, seed=2, cond=1e2)).astype(np.float32)
    rng = np.random.default_rng(3)
    shape = (n,) if vec else ((7, n) if name == "solve_xlt" else (n, 7))
    b = rng.standard_normal(shape).astype(np.float32)
    x_t = getattr(ttrsm, name)(torch.tensor(l), torch.tensor(b))
    x_j = np.asarray(getattr(jtrsm, name)(jnp.asarray(l), jnp.asarray(b)))
    assert_normwise(x_t.numpy(), x_j)


def test_method_other_than_the_kernels_raises():
    l = torch.eye(4)
    for method in ("xla", "blocked", "bogus"):
        with pytest.raises(ValueError):
            tchol.cholesky(l, method=method)
        with pytest.raises(ValueError):
            ttrsm.solve_lx(l, torch.ones(4), method=method)


@pytest.mark.parametrize("n,patched", [(96, False), (640, True)])
def test_cholesky_backward_matches_jax(request, n, patched):
    """Murray's rule against jax.grad through the JAX custom VJP; rtol
    1e-3 (the JAX test's own bar, tests/ops/test_cholesky.py:74-75). At
    n=640 with the small base the backward's solves recurse too."""
    if patched:
        request.getfixturevalue("small_base")
    a = _spd(n, seed=4, cond=1e2)
    w = np.random.default_rng(5).standard_normal((n, n)).astype(np.float32)

    def f_jax(a):
        l = jchol.cholesky((a + a.T) / 2, method="blocked")
        return (jnp.sum(jnp.log(jnp.diagonal(l))) + jnp.sum(l**2) * 1e-3
                + jnp.sum(l * w) * 1e-3)

    g_j = np.asarray(jax.grad(f_jax)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    l = tchol.cholesky((at + at.T) / 2)
    f = (torch.sum(torch.log(torch.diagonal(l))) + torch.sum(l**2) * 1e-3
         + torch.sum(l * torch.tensor(w)) * 1e-3)
    (g_t,) = torch.autograd.grad(f, at)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["solve_lx", "solve_ltx"])
def test_solve_gradient_matches_jax(small_base, name):
    """The solves' autograd rule (two more solves) against jax.grad."""
    n = 640
    l = np.linalg.cholesky(_spd(n, seed=6, cond=1e2)).astype(np.float32)
    b = np.random.default_rng(7).standard_normal((n, 3)).astype(np.float32)
    w = np.random.default_rng(8).standard_normal((n, 3)).astype(np.float32)

    def f_jax(l, b):
        return jnp.sum(getattr(jtrsm, name)(l, b) * w)

    gl_j, gb_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(l),
                                                 jnp.asarray(b))
    lt = torch.tensor(l, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    f = torch.sum(getattr(ttrsm, name)(lt, bt) * torch.tensor(w))
    gl_t, gb_t = torch.autograd.grad(f, (lt, bt))
    assert_normwise(gb_t.numpy(), gb_j)
    assert_normwise(np.tril(gl_t.numpy()), np.tril(np.asarray(gl_j)))


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("n", [1, 7, 1024, 1025, 2500])
def test_cho_inverse_matches_float64(n, batch):
    """cho_inverse (the blocked triangular inverse and W^T W, at the real
    base size: 2500 recurses past it twice) against float64
    torch.cholesky_inverse of the same factor (cond 1e2, off-diagonal
    entries of the inverse near its largest), normwise at rtol 5e-6;
    symmetric bit for bit; only L's lower triangle read."""
    a = np.stack([_spd(n, seed=n + b, cond=1e2).astype(np.float64)
                  for b in range(batch or 1)])
    l64 = torch.linalg.cholesky(torch.tensor(a if batch else a[0]))
    l = l64.float()
    inv = tchol.cho_inverse(l)
    assert_normwise(inv.numpy(), torch.cholesky_inverse(l64).numpy(),
                    rtol=5e-6)
    assert torch.equal(inv, inv.mT)
    junk = l + torch.triu(torch.full_like(l, 9.0), 1)
    assert torch.equal(tchol.cho_inverse(junk), inv)
