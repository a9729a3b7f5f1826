"""2D block-cyclic distributed Cholesky, as
``cugp_tpu/parallel/block_cyclic.py``.

The ScaLAPACK-style factorization: block (i, j) of the matrix lives on
rank (i mod R, j mod C) of the grid; each panel step factors the
diagonal block, moves the panel along the mesh axes, and every rank
applies its local trailing SYRK update. ``factor_`` is the one body, a
look-ahead schedule: panel k+1's column strip takes update k first, and
its broadcast along 'c' is started (``async_op``) before the bulk
trailing update of panel k, so the next panel travels while the update
runs; the panels move by broadcasts (no all_reduce), and each update
touches only the trailing blocks on or below the block diagonal (one
GEMM a local block-row: n^3/3 in all); the strictly-upper blocks keep
stale values.

Both Cholesky entry points take and return a rank's 2D-contiguous block:
``block_cyclic_cholesky`` (rows over 'r') and
``distributed_chol.distributed_cholesky`` (rows over ('dp', 'r')). Both
go through ``_cholesky_2d``: the move to cyclic order
(relayout.to_block_cyclic's exchange, one all_to_all along the grid's
rows and one along 'c', or, with relayout="gather", the global
permutation of the gathered matrix, the comparison path), ``factor_``,
and the move back.

Divergences from the JAX package, none of which changes the function:
the diagonal block and the panel solve run ``ops.cholesky`` and
``ops.trsm`` (the potrf and TRSM kernels) where JAX calls
``method="xla"``; JAX's ``pipelined=False`` selects its legacy body
(masked all_reduce broadcasts, a full-size update every panel), which
the port does not keep: ``pipelined`` is accepted (a bool) and changes
nothing; and JAX's split between a static unroll (up to
``_STATIC_UNROLL_MAX_NB`` panels) and a chunked-rolled body bounds its
trace size, which eager torch does not have: one loop serves every panel
count, and ``chunk`` is accepted (a positive int) and changes nothing.

The distributed LML (distributed_chol.py) works on a rank's block-cyclic
array in place with the look-ahead body (``factor_``) and three more
loops over the nb block rows or columns, the counterparts of ScaLAPACK's
p?trtrs, p?trtri and p?lauum:

  tri_solve  L x = v or L^T x = v for a replicated vector v: a block's
             partial products reduced along the mesh axis that holds its
             row (column), then solved by the diagonal block's owner and
             broadcast to every rank;
  trtri_     W = L^{-1} (n^3/3), right-looking: block row k of W is
             L_kk^{-1} B[k, :k+1], then B[i>k, :k+1] -= L[i>k, k]
             W[k, :k+1], B the identity so updated; one broadcast of L's
             column k along 'c' and of W's row k along the rows a step;
  lauum_     the lower blocks of W^T W (n^3/3): step l adds W[l, i]^T
             W[l, j] to each block j <= i <= l, W's row l broadcast along
             the rows and gathered along 'c'.

Each leaves the strictly-upper blocks stale. The grid's rows may be one
mesh axis or several: ('dp', 'r') for the LML, whose rows are sharded
over both (``Grid(..., rows=...)``).
"""

from __future__ import annotations

import math

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


def block_size(n, R, C, limit):
    """The largest block at most `limit` that tiles n over an R x C grid
    (a divisor of n/R and of n/C)."""
    if n % R or n % C:
        raise ValueError(f"n={n} is not divisible by the grid's R={R} "
                         f"and C={C}")
    g = math.gcd(n // R, n // C)
    return max(d for d in range(1, min(limit, g) + 1) if g % d == 0)


class Grid:
    """This rank's place in the block-cyclic grid: local block-row t is
    global block-row t*R + my_r, local block-col t is t*C + my_c. rows:
    the mesh axis, or tuple of axes, the grid's rows are sharded over."""

    def __init__(self, mesh, nb, block, rows="r"):
        rows = (rows,) if isinstance(rows, str) else tuple(rows)
        self.gr, self.gc = mesh.group(rows), mesh.group("c")
        self.gall = mesh.group(rows + ("c",))
        self.R, self.C = self.gr.size, self.gc.size
        self.my_r, self.my_c = self.gr.index, self.gc.index
        self.nb, self.block = nb, block
        self.nbr, self.nbc = nb // self.R, nb // self.C

    def row_blocks(self):
        return np.arange(self.nbr) * self.R + self.my_r

    def col_blocks(self):
        return np.arange(self.nbc) * self.C + self.my_c

    def _index(self, blocks, device):
        b = self.block
        return torch.as_tensor((blocks[:, None] * b + np.arange(b)).reshape(
            -1), device=device)

    def rows_index(self, device=None):
        """Global indices of the local rows, in local order."""
        return self._index(self.row_blocks(), device)

    def cols_index(self, device=None):
        return self._index(self.col_blocks(), device)

    def rows_from(self, k):
        """The first local block-row whose global block-row is >= k."""
        return min(max(0, _ceil_div(k - self.my_r, self.R)), self.nbr)

    def cols_to(self, k):
        """How many local block-cols have a global block-col <= k."""
        return min(max(0, (k - self.my_c) // self.C + 1), self.nbc)

    def owner(self, k):
        """The index in ``gall`` of the rank holding diagonal block k."""
        return (k % self.R) * self.C + k % self.C

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
        """A_loc with the entries above the global diagonal zeroed (the
        mask built on A_loc's device, not on the host)."""
        gr = self.rows_index(A_loc.device)
        gc = self.cols_index(A_loc.device)
        return torch.where(gr[:, None] >= gc[None, :], A_loc, 0.0)

    def block_weights(self, device, dtype=torch.float32):
        """(nbr, nbc): 2 below the block diagonal, 1 on it, 0 above; a
        symmetric matrix's sum over all its entries is the sum of its
        lower blocks so weighted."""
        rb, cb = self.row_blocks()[:, None], self.col_blocks()[None, :]
        return torch.as_tensor(np.where(rb > cb, 2.0, (rb == cb) * 1.0),
                               dtype=dtype, device=device)


def _sub_lower_(A, panel, q, grid, r_off, c_off):
    """A[r_off*b:, c_off*b:] -= panel @ q^T on the blocks on or below the
    block diagonal: local block-row t takes the block-cols up to its own
    global block-row, one GEMM a row."""
    b = grid.block
    for t in range(r_off, grid.nbr):
        hi = grid.cols_to(t * grid.R + grid.my_r)
        if hi > c_off:
            A[t * b:(t + 1) * b, c_off * b:hi * b].addmm_(
                panel[(t - r_off) * b:(t - r_off + 1) * b],
                q[:(hi - c_off) * b].mT, alpha=-1.0)


def factor_(A, grid):
    """Look-ahead body: broadcasts, shrinking lower-block updates, panel
    k+1 sent while the bulk update of panel k runs. Factors A in place:
    its lower blocks become L's (each diagonal block lower triangular
    with zeros above)."""
    b, R, C, nb = grid.block, grid.R, grid.C, grid.nb
    g_row = np.repeat(grid.row_blocks(), b)

    def lr0(k):  # first local block-row that can hold g_row >= k (any rank)
        return max(0, _ceil_div(k + 1 - R, R))

    def lc0(k):
        return max(0, _ceil_div(k + 1 - C, C))

    def finish_panel(k, strip, r_off):
        """Factor panel k from its strip (already on every rank of the
        mesh row): the diagonal block along the rows, the panel solve."""
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
        _sub_lower_(A, panel, q, grid, r_off, c_off)
        r_off = lr0(k + 1)
    return A



def tri_solve(A, grid, v, transpose=False):
    """x = L^{-1} v, or L^{-T} v with transpose, for L in A's lower blocks
    (as factor_ leaves them) and v replicated (n,); x is replicated, the
    same bits on every rank."""
    b, R, C = grid.block, grid.R, grid.C
    x = v.clone()
    rows, cols = grid.rows_index(A.device), grid.cols_index(A.device)
    steps = range(grid.nb - 1, -1, -1) if transpose else range(grid.nb)
    for k in steps:
        kb_r, kb_c = k // R, k // C
        s = None
        if not transpose and grid.my_r == k % R:
            # row k of L left of its diagonal block, along 'c'
            hi = grid.cols_to(k - 1)
            s = collectives.all_reduce(
                A[kb_r * b:(kb_r + 1) * b, :hi * b] @ x[cols[:hi * b]],
                grid.gc)
        elif transpose and grid.my_c == k % C:
            # column k of L below its diagonal block, along the rows
            lo = grid.rows_from(k + 1)
            s = collectives.all_reduce(
                A[lo * b:, kb_c * b:(kb_c + 1) * b].mT @ x[rows[lo * b:]],
                grid.gr)
        if grid.my_r == k % R and grid.my_c == k % C:
            l_kk = A[kb_r * b:(kb_r + 1) * b, kb_c * b:(kb_c + 1) * b]
            rhs = x[k * b:(k + 1) * b] - s
            xk = (trsm_ops.solve_ltx(l_kk, rhs) if transpose
                  else trsm_ops.solve_lx(l_kk, rhs))
        else:
            xk = x.new_empty(b)
        x[k * b:(k + 1) * b] = collectives.broadcast(xk, grid.gall,
                                                     grid.owner(k))
    return x


def trtri_(A, grid):
    """W = L^{-1} in place on A's lower blocks (L as factor_ leaves it):
    each diagonal block becomes its inverse, lower triangular with zeros
    above."""
    b, R, C = grid.block, grid.R, grid.C
    for k in range(grid.nb):
        kb_r, kb_c = k // R, k // C
        lo, gt = grid.rows_from(k), grid.rows_from(k + 1)
        # L's column k, rows >= k, to every rank of the mesh row
        mine_c = grid.my_c == k % C
        src = (A[lo * b:, kb_c * b:(kb_c + 1) * b].clone() if mine_c
               else A.new_empty(((grid.nbr - lo) * b, b)))
        strip = collectives.broadcast(src, grid.gc, k % C)
        if mine_c:
            A[gt * b:, kb_c * b:(kb_c + 1) * b].zero_()  # B's column k
        # W's row k = L_kk^{-1} B[k, :k+1], to every rank of the column
        hi = grid.cols_to(k)
        if grid.my_r == k % R:
            row = A[kb_r * b:(kb_r + 1) * b, :hi * b]
            if mine_c:
                row[:, kb_c * b:].copy_(torch.eye(b, dtype=A.dtype,
                                                  device=A.device))
            trsm_ops.solve_lx_(strip[:b], row)
            if mine_c:
                row[:, kb_c * b:].tril_()
        else:
            row = A.new_empty((b, hi * b))
        w_row = collectives.broadcast(row, grid.gr, k % R)
        if gt < grid.nbr and hi:
            A[gt * b:, :hi * b].addmm_(strip[(gt - lo) * b:], w_row,
                                       alpha=-1.0)
    return A


def lauum_(A, grid):
    """The lower blocks of W^T W in place on A's lower blocks (W as
    trtri_ leaves it); the diagonal blocks come out whole."""
    b, R, C = grid.block, grid.R, grid.C
    for k in range(grid.nb):
        kb_r, hi = k // R, grid.cols_to(k)
        # W's row k on my columns (zeros right of its diagonal block),
        # then on every column
        if grid.my_r == k % R:
            src = A[kb_r * b:(kb_r + 1) * b].clone()
            src[:, hi * b:] = 0.0
            A[kb_r * b:(kb_r + 1) * b].zero_()  # C's row k starts here
        else:
            src = A.new_empty((b, grid.nbc * b))
        w_row = collectives.broadcast(src, grid.gr, k % R)
        w_all = collectives.all_gather(w_row, grid.gc).view(
            C, b, grid.nbc, b)
        for t in range(grid.rows_from(k + 1)):
            i = t * R + grid.my_r
            h = grid.cols_to(i)
            A[t * b:(t + 1) * b, :h * b].addmm_(
                w_all[i % C, :, i // C].mT, w_row[:, :h * b])
    return A


def _cholesky_2d(K_loc, mesh, rows, block, relayout="all_to_all"):
    """L's block from K's: K_loc is this rank's 2D-contiguous block (rows
    over the mesh axis or axes `rows`, columns over 'c'), n divisible by
    block times the rows' and the columns' rank counts. Moves it to
    block-cyclic order, factors it with factor_ and moves it back."""
    R, C = mesh.axis_size(rows), mesh.shape["c"]
    n = K_loc.shape[0] * R
    if (K_loc.shape[1] * C != n or n % (block * R) or n % (block * C)):
        raise ValueError(
            f"n={n} (local block {tuple(K_loc.shape)}) must be square over "
            f"the grid and divisible by block*R={block * R} and "
            f"block*C={block * C}")
    grid = Grid(mesh, n // block, block, rows=rows)
    spec = Sharding(mesh, (rows, "c"))
    with torch.no_grad():
        if relayout == "all_to_all":
            Kp = relayout_lib._cyclic(K_loc, block, grid.gr, grid.gc, True)
        elif relayout == "gather":
            row_perm = cyclic_permutation(grid.nb, R, block)
            col_perm = cyclic_permutation(grid.nb, C, block)
            Kp = spec.shard(spec.gather(K_loc)[row_perm][:, col_perm])
        else:
            raise ValueError(f"unknown relayout: {relayout}")
        Lp = grid.lower_mask(factor_(Kp.clone(), grid))
        if relayout == "all_to_all":
            return relayout_lib._cyclic(Lp, block, grid.gr, grid.gc, False)
        L = spec.gather(Lp)[_inverse_perm(row_perm)][:, _inverse_perm(
            col_perm)]
        return spec.shard(L)


def block_cyclic_cholesky(K_loc, mesh, block=128, pipelined=True, chunk=8,
                          relayout="all_to_all"):
    """Lower Cholesky of K through the block-cyclic algorithm.

    K_loc: this rank's 2D block of K (rows over 'r', columns over 'c';
    replicated over 'dp'), n divisible by block*R and block*C. Returns
    the same block of L, in natural (unpermuted) order.

    relayout: "all_to_all" (the scheduled exchange, relayout.py) or
    "gather" (the global permutation of the all-gathered matrix).
    pipelined and chunk: the JAX package's schedule and trace-size knobs;
    accepted (a bool, a positive int) and unused here: every call runs
    the look-ahead body (the module docstring).
    """
    if not isinstance(pipelined, bool):
        raise ValueError(f"pipelined must be a bool, got {pipelined!r}")
    if not (isinstance(chunk, int) and chunk > 0):
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    return _cholesky_2d(K_loc, mesh, "r", block, relayout)
