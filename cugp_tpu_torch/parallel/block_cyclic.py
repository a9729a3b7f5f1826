"""2D block-cyclic distributed Cholesky, as
``cugp_tpu/parallel/block_cyclic.py``.

The ScaLAPACK-style factorization: block (i, j) of the matrix lives on
rank (i mod R, j mod C) of the ('r', 'c') grid; each panel step factors
the diagonal block, moves the panel along the mesh axes, and every rank
applies its local trailing SYRK update. The layout transition to and from
cyclic order is relayout.to_block_cyclic / from_block_cyclic (one
all_to_all per mesh axis), or, with relayout="gather", the global
permutation of the gathered matrix (the comparison path).

Two schedules:
  pipelined=True  the look-ahead: panel k+1's column strip takes update k
                  first, and its broadcast along 'c' is started
                  (``async_op``) before the bulk trailing update of panel
                  k, so the next panel travels while the update runs; the
                  panels move by broadcasts (no all_reduce), and each
                  update touches only the active trailing region;
  pipelined=False the legacy reference: masked all_reduce broadcasts and a
                  full-size masked update every panel.

Divergences from the JAX package, neither of which changes the function:
the diagonal block and the panel solve run ``ops.cholesky`` and
``ops.trsm`` (the potrf and TRSM kernels) where JAX calls
``method="xla"``; and JAX's split between a static unroll (up to
``_STATIC_UNROLL_MAX_NB`` panels) and a chunked-rolled body bounds its
trace size, which eager torch does not have: one loop serves every panel
count, and ``chunk`` is accepted (a positive int) and changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.parallel import collectives, relayout as relayout_lib
from cugp_tpu_torch.parallel.mesh import Sharding


def cyclic_permutation(nb, R, block):
    """Row permutation (as an index array) realizing block-cyclic order."""
    order = [i for p in range(R) for i in range(p, nb, R)]
    return torch.as_tensor(np.concatenate(
        [np.arange(i * block, (i + 1) * block) for i in order]))


def _inverse_perm(idx):
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(idx.shape[0])
    return inv


def _ceil_div(a, b):
    return -(-a // b)


class _Grid:
    """This rank's place in the block-cyclic grid: local block-row t is
    global block-row t*R + my_r, local block-col t is t*C + my_c."""

    def __init__(self, mesh, nb, block, nbr, nbc):
        self.gr, self.gc = mesh.group("r"), mesh.group("c")
        self.R, self.C = mesh.shape["r"], mesh.shape["c"]
        self.my_r, self.my_c = mesh.coords["r"], mesh.coords["c"]
        self.nb, self.block, self.nbr, self.nbc = nb, block, nbr, nbc

    def row_blocks(self):
        return np.arange(self.nbr) * self.R + self.my_r

    def col_blocks(self):
        return np.arange(self.nbc) * self.C + self.my_c

    def transpose_panel(self, panel_all, k, r_off, c_off):
        """L_jk rows for my local block-cols t >= c_off, from the panels of
        every mesh row (panel_all (R, rows - r_off*block, block)); blocks
        with j <= k are zero."""
        b = self.block
        j = (np.arange(c_off, self.nbc)) * self.C + self.my_c
        nblk = panel_all.shape[1] // b
        src = (j % self.R) * nblk + np.maximum(j // self.R - r_off, 0)
        q = panel_all.reshape(self.R * nblk, b, b)[
            torch.as_tensor(src, device=panel_all.device)]
        q = q * torch.as_tensor(j > k, dtype=q.dtype,
                                device=q.device)[:, None, None]
        return q.reshape(-1, b)

    def lower_mask(self, A_loc):
        b = self.block
        gr = np.repeat(self.row_blocks(), b) * b + np.tile(np.arange(b),
                                                           self.nbr)
        gc = np.repeat(self.col_blocks(), b) * b + np.tile(np.arange(b),
                                                           self.nbc)
        mask = torch.as_tensor(gr[:, None] >= gc[None, :],
                               device=A_loc.device)
        return torch.where(mask, A_loc, 0.0)


def _factor_local(A, grid):
    """Legacy body: masked all_reduce broadcasts, full-size updates."""
    b, R, C = grid.block, grid.R, grid.C
    g_row = torch.as_tensor(np.repeat(grid.row_blocks(), b), device=A.device)
    for k in range(grid.nb):
        r_k, c_k, kb_r, kb_c = k % R, k % C, k // R, k // C
        strip = A[:, kb_c * b:(kb_c + 1) * b]
        strip = strip.clone() if grid.my_c == c_k else torch.zeros_like(strip)
        strip = collectives.all_reduce(strip, grid.gc)
        diag = strip[kb_r * b:(kb_r + 1) * b]
        diag = (diag.clone() if grid.my_r == r_k
                else torch.zeros_like(diag))
        l_kk = chol_ops.cholesky(collectives.all_reduce(diag, grid.gr))
        panel = trsm_ops.solve_xlt(l_kk, strip)
        panel = torch.where((g_row > k)[:, None], panel, 0.0)
        if grid.my_c == c_k:
            new = panel.clone()
            if grid.my_r == r_k:
                new[kb_r * b:(kb_r + 1) * b] = l_kk
            A[:, kb_c * b:(kb_c + 1) * b] = new
        panel_all = collectives.all_gather(panel[None], grid.gr)
        q = grid.transpose_panel(panel_all, k, 0, 0)
        A -= panel @ q.mT
    return A


def _factor_local_la(A, grid):
    """Look-ahead body: broadcasts, shrinking updates, panel k+1 sent
    while the bulk update of panel k runs."""
    b, R, C, nb = grid.block, grid.R, grid.C, grid.nb
    g_row = np.repeat(grid.row_blocks(), b)

    def lr0(k):  # first local block-row that can hold g_row >= k (any rank)
        return max(0, _ceil_div(k + 1 - R, R))

    def lc0(k):
        return max(0, _ceil_div(k + 1 - C, C))

    def finish_panel(k, strip, r_off):
        """Factor panel k from its strip (already on every rank of the
        mesh row): the diagonal block along 'r', the panel solve."""
        d_off = (k // R - r_off) * b
        diag = collectives.broadcast(strip[d_off:d_off + b], grid.gr, k % R)
        l_kk = chol_ops.cholesky(diag)
        panel = trsm_ops.solve_xlt(l_kk, strip)
        keep = torch.as_tensor(g_row[r_off * b:] > k, device=strip.device)
        return l_kk, torch.where(keep[:, None], panel, 0.0)

    r_off = lr0(0)
    strip = A[r_off * b:, 0:b].clone()
    work = collectives.broadcast_async(strip, grid.gc, 0)
    for k in range(nb):
        if work is not None:
            work.wait()
        l_kk, panel = finish_panel(k, strip, r_off)
        kb_r, kb_c = k // R, k // C
        if grid.my_c == k % C:
            new = panel.clone()
            if grid.my_r == k % R:
                d_off = (kb_r - r_off) * b
                new[d_off:d_off + b] = l_kk
            A[r_off * b:, kb_c * b:(kb_c + 1) * b] = new
        c_off = lc0(k)
        panel_all = collectives.all_gather(panel[None], grid.gr)
        q = grid.transpose_panel(panel_all, k, r_off, c_off)
        work = None
        if k + 1 < nb:
            # look-ahead: column k+1's strip takes update k first and is
            # sent along 'c' while the bulk update below runs
            kn, rn_off = k + 1, lr0(k + 1)
            cn = (kn // C - c_off) * b
            strip = A[rn_off * b:, (kn // C) * b:(kn // C + 1) * b].clone()
            if grid.my_c == kn % C:
                strip -= panel[(rn_off - r_off) * b:] @ q[cn:cn + b].mT
                q[cn:cn + b] = 0.0  # the bulk update leaves column k+1
            work = collectives.broadcast_async(strip, grid.gc, kn % C)
        A[r_off * b:, c_off * b:] -= panel @ q.mT
        r_off = lr0(k + 1)
    return A


def block_cyclic_cholesky(K_loc, mesh, block=128, pipelined=True, chunk=8,
                          relayout="all_to_all"):
    """Lower Cholesky of K through the block-cyclic algorithm.

    K_loc: this rank's 2D block of K (rows over 'r', columns over 'c';
    replicated over 'dp'), n divisible by block*R and block*C. Returns
    the same block of L, in natural (unpermuted) order.

    pipelined: the look-ahead schedule (True) or the legacy reference
    (False), see the module docstring. relayout: "all_to_all" (the
    scheduled exchange, relayout.py) or "gather" (the global permutation
    of the all-gathered matrix). chunk: the JAX package's trace-size knob;
    accepted and unused here.
    """
    if not (isinstance(chunk, int) and chunk > 0):
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    R, C = mesh.shape["r"], mesh.shape["c"]
    n = K_loc.shape[0] * R
    if (K_loc.shape[1] * C != n or n % (block * R) or n % (block * C)):
        raise ValueError(
            f"n={n} (local block {tuple(K_loc.shape)}) must be square over "
            f"the grid and divisible by block*R={block * R} and "
            f"block*C={block * C}")
    nb = n // block
    grid = _Grid(mesh, nb, block, nb // R, nb // C)
    spec = Sharding(mesh, ("r", "c"))
    with torch.no_grad():
        if relayout == "all_to_all":
            Kp = relayout_lib.to_block_cyclic(K_loc, mesh, block)
        elif relayout == "gather":
            row_perm = cyclic_permutation(nb, R, block)
            col_perm = cyclic_permutation(nb, C, block)
            Kp = spec.shard(spec.gather(K_loc)[row_perm][:, col_perm])
        else:
            raise ValueError(f"unknown relayout: {relayout}")
        body = _factor_local_la if pipelined else _factor_local
        Lp = grid.lower_mask(body(Kp.clone(), grid))
        if relayout == "all_to_all":
            return relayout_lib.from_block_cyclic(Lp, mesh, block)
        L = spec.gather(Lp)[_inverse_perm(row_perm)][:, _inverse_perm(
            col_perm)]
        return spec.shard(L)
