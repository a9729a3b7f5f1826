"""The Cholesky precision policies against the JAX package (CPU).

Both recursions run with their blocking cut down (base blocks of 32,
splits aligned to 32, SYRK recursion below 128, mixed diagonal blocks of
64) so that a 256 x 256 factor takes every branch. The JAX side runs its
blocked recursion with the XLA base (method "blocked"); on the CPU every
XLA precision is fp32, so the port's factor under a policy is held to
JAX's at the emulated TF32 error: the port rounds its operands to TF32
on every device, and only the card runs those products on tensor cores.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugp_tpu.ops import blocking as jblocking
from cugp_tpu.ops import cholesky as jchol
from cugp_tpu.ops import trsm as jtrsm

from cugp_tpu_torch.ops import blocking as tblocking
from cugp_tpu_torch.ops import cholesky as tchol
from cugp_tpu_torch.ops import trsm as ttrsm

torch.set_num_threads(1)

N = 256
_JAX_LEVELS = {jax.lax.Precision.HIGHEST: "highest",
               jax.lax.Precision.HIGH: "high",
               jax.lax.Precision.DEFAULT: "default"}


@pytest.fixture
def small_blocks(monkeypatch):
    """Both packages' recursions cut to n = 256 scale."""
    for mod in (jchol, jtrsm, tchol, ttrsm):
        monkeypatch.setattr(mod, "_BASE", 32)
    for mod in (jblocking, tblocking):
        monkeypatch.setattr(mod, "ALIGN", 32)
    for mod in (jchol, tchol):
        monkeypatch.setattr(mod, "_SYRK_FULL", 128)
        monkeypatch.setattr(mod, "_MIXED_DIAG", 64)


@pytest.fixture(scope="module")
def spd():
    """G G^T / n + I / 2: an SPD matrix with eigenvalues in ~[0.5, 4]."""
    g = np.random.default_rng(0).standard_normal((N, N))
    return (g @ g.T / N + 0.5 * np.eye(N)).astype(np.float32)


def _recon(L, A):
    return float(np.abs(L @ L.T - A).max() / np.abs(A).max())


@pytest.mark.parametrize("policy,dist_bar,recon_bar", [
    (None, 1e-6, 1e-6), ("high", 1e-5, 1e-5), ("mixed", 1e-5, 1e-5),
    ("mixed_fast", 1e-3, 1e-3)])
def test_policy_follows_jax_structure(small_blocks, monkeypatch, spd,
                                      policy, dist_bar, recon_bar):
    """Each policy ("high" is JAX's Precision.HIGH) runs JAX's GEMMs
    (every (M K N, precision) pair, as a multiset) and lands within its
    emulated-TF32 error of JAX's fp32 factor: None within fp32 rounding
    (measured 9.4e-8), split TF32 ("high", "mixed") within 1e-5
    (measured 1.9e-7 / 9.4e-8), one TF32 pass on the off-diagonal
    quadrants ("mixed_fast") bounded at 1e-3 (measured 2.1e-5: TF32
    keeps 10 mantissa bits), each in max abs distance over max |L| and
    in reconstruction relerr."""
    seen_j, seen_t = collections.Counter(), collections.Counter()
    matmul = jnp.matmul

    def record_j(a, b, precision=None, **kw):
        seen_j[a.shape[-2] * a.shape[-1] * b.shape[-1],
               _JAX_LEVELS[precision]] += 1
        return matmul(a, b, precision=precision, **kw)

    sub_mm_ = ttrsm.sub_mm_

    def record_t(c, a, b, precision="highest"):
        seen_t[a.shape[-2] * a.shape[-1] * b.shape[-1], precision] += 1
        return sub_mm_(c, a, b, precision)

    monkeypatch.setattr(jnp, "matmul", record_j)
    monkeypatch.setattr(ttrsm, "sub_mm_", record_t)
    jax_policy = jax.lax.Precision.HIGH if policy == "high" else policy
    L_j = np.asarray(jchol.cholesky(jnp.asarray(spd), method="blocked",
                                    precision=jax_policy))
    L = tchol.cholesky(torch.tensor(spd), precision=policy).numpy()
    assert seen_t == seen_j and len(seen_t) > 1
    dist = np.abs(L - L_j).max() / np.abs(L_j).max()
    assert dist <= dist_bar
    assert _recon(L, spd) <= recon_bar
    levels = {p for _, p in seen_t}
    assert levels == {None: {"highest"}, "high": {"high"},
                      "mixed": {"highest", "high"},
                      "mixed_fast": {"high", "default"}}[policy]


def test_default_is_true_fp32_and_never_enables_tf32(small_blocks,
                                                     monkeypatch, spd):
    """None and "highest" give the same bits, and neither enters the TF32
    scope; the factor's gradient is the same fp32 Murray rule under a
    policy (its backward enters no TF32 scope either)."""
    entered = []
    scope = ttrsm.tf32_matmul

    def watch():
        entered.append(1)
        return scope()

    monkeypatch.setattr(ttrsm, "tf32_matmul", watch)
    A = torch.tensor(spd)
    L0 = tchol.cholesky(A)
    assert torch.equal(L0, tchol.cholesky(A, precision="highest"))
    assert not entered
    a = A.clone().requires_grad_(True)
    L = tchol.cholesky(a, precision="mixed")
    n_forward = len(entered)
    assert n_forward > 0
    (g,) = torch.autograd.grad(L.sum(), a)
    assert len(entered) == n_forward and torch.isfinite(g).all()


def test_tf32_flag_restored_when_a_gemm_raises(small_blocks, monkeypatch,
                                               spd):
    """allow_tf32 is on only inside a low-precision GEMM and is False
    again after the factorization, also when a GEMM inside raises."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    flags = []
    sub = ttrsm._sub_

    def failing(c, a, b):
        flags.append(torch.backends.cuda.matmul.allow_tf32)
        if len(flags) == 3:
            raise RuntimeError("injected")
        return sub(c, a, b)

    monkeypatch.setattr(ttrsm, "_sub_", failing)
    with pytest.raises(RuntimeError, match="injected"):
        tchol.cholesky(torch.tensor(spd), precision="high")
    assert flags == [True, True, True]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(ttrsm, "_sub_", sub)
    tchol.cholesky(torch.tensor(spd), precision="mixed_fast")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="precision policy"):
        tchol.cholesky(torch.eye(8) * 2.0, precision="bf16")


def test_tf32_split_is_exact_to_21_bits():
    """round_tf32 clears the low 13 mantissa bits (to nearest), and the
    hi + lo split holds x to 2^-21 relative."""
    x = torch.tensor(np.random.default_rng(1).standard_normal(4096),
                     dtype=torch.float32)
    hi, lo = ttrsm.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("precision,calls", [("high", 12), ("default", 4)])
def test_tf32_gemms_sum_k_in_chunks(monkeypatch, precision, calls):
    """A low-precision c -= a b runs its contraction in TF32_K_CHUNK
    pieces (here 64 of k = 200: 4 a pass, 3 passes for "high"), each
    added into c; the result is the unchunked one's up to fp32 sums of
    other grouping (1e-5 relative: the products are exact on TF32
    operands, so only the order of the fp32 sums differs)."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((8, 200)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((200, 6)), dtype=torch.float32)
    c0 = torch.tensor(rng.standard_normal((8, 6)), dtype=torch.float32)
    whole = c0.clone()
    ttrsm.sub_mm_(whole, a, b, precision)
    seen = []
    sub = ttrsm._sub_

    def count(c, x, y):
        seen.append(x.shape[-1])
        return sub(c, x, y)

    monkeypatch.setattr(ttrsm, "_sub_", count)
    monkeypatch.setattr(ttrsm, "TF32_K_CHUNK", 64)
    chunked = c0.clone()
    ttrsm.sub_mm_(chunked, a, b, precision)
    assert len(seen) == calls and max(seen) == 64
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-5)

