"""Explicit layout transitions (the Ulysses analog), as
``cugp_tpu/parallel/relayout.py``.

The two layouts of the dense N x N matrix:

  row-sharded  rows split over ALL ranks of the ('r', 'c') grid, full
               column width local: the covariance-build layout (ring.py);
  2D           rows over 'r', columns over 'c': the factorization layout.

The transition is one ``all_to_all`` along 'c': within each mesh row,
every rank splits its row block column-wise into C chunks and exchanges
them with its row peers (traffic per rank = its local bytes). Row-block
convention: rank (r, c) of the row-sharded layout holds global rows
[(r*C + c) * n/(R*C), ...), so the exchange along 'c' reassembles the
contiguous n/R row band of mesh row r.

The 2D-contiguous <-> 2D-block-cyclic transition (block (i, j) on rank
(i mod R, j mod C), block_cyclic.py's ownership): along the grid's rows
(one mesh axis, or several such as ('dp', 'r')) and along 'c', every
rank sorts its local blocks by destination, exchanges them in ONE
all_to_all (padded to ceil(nb_local / P) blocks a peer when P does not
divide nb_local), and compacts what it received into cyclic order.

Every function takes and returns the rank's own block.
"""

from __future__ import annotations

import numpy as np
import torch

from cugp_tpu_torch.parallel import collectives


def row_to_2d(A_loc, mesh):
    """Row-sharded (n/(R*C), n) block -> the 2D (n/R, n/C) block."""
    R, C = mesh.shape["r"], mesh.shape["c"]
    rows, n1 = A_loc.shape
    if n1 % C:
        raise ValueError(f"row_to_2d: {n1} columns are not divisible by "
                         f"C={C}")
    send = A_loc.reshape(rows, C, n1 // C).transpose(0, 1)
    recv = collectives.all_to_all(send.contiguous(), mesh.group("c"))
    return recv.reshape(C * rows, n1 // C)


def two_d_to_row(A_loc, mesh):
    """Inverse of row_to_2d: the 2D (n/R, n/C) block -> (n/(R*C), n)."""
    R, C = mesh.shape["r"], mesh.shape["c"]
    rows, cols = A_loc.shape
    if rows % C:
        raise ValueError(f"two_d_to_row: {rows} rows are not divisible by "
                         f"C={C}")
    recv = collectives.all_to_all(A_loc.reshape(C, rows // C, cols),
                                  mesh.group("c"))
    return recv.transpose(0, 1).reshape(rows // C, C * cols)


def _exchange(blocks, g, send_slot, recv_slot):
    """Move blocks (nb_local, ...) between the ranks of g: local block t
    goes to slot send_slot[t] (peer * m + rank among its blocks there),
    result t is received slot recv_slot[t]."""
    P, nbl = g.size, blocks.shape[0]
    m = -(-nbl // P)
    dev = blocks.device
    send = blocks.new_zeros((P * m,) + blocks.shape[1:])
    send[torch.as_tensor(send_slot, device=dev)] = blocks
    recv = collectives.all_to_all(send, g)
    return recv[torch.as_tensor(recv_slot, device=dev)]


def _cyclic_fwd_exchange(blocks, g):
    """Contiguous -> cyclic along one mesh axis: local block t is global
    block me*nb_local + t before, me + t*P after."""
    P, me, nbl = g.size, g.index, blocks.shape[0]
    m = -(-nbl // P)
    t = np.arange(nbl)
    gi = me * nbl + t
    dest = gi % P
    rank = (t - (dest - me * nbl) % P) // P
    i2 = me + t * P
    q = i2 // nbl
    j = (i2 - q * nbl - (me - q * nbl) % P) // P
    return _exchange(blocks, g, dest * m + rank, q * m + j)


def _cyclic_inv_exchange(blocks, g):
    """Cyclic -> contiguous along one mesh axis (inverse of the above)."""
    P, me, nbl = g.size, g.index, blocks.shape[0]
    m = -(-nbl // P)
    t = np.arange(nbl)
    gi = me + t * P
    dest = gi // nbl
    rank = t - (-(-(dest * nbl - me) // P))
    i2 = me * nbl + t
    p = i2 % P
    tt = (i2 - p) // P
    j = tt - (-(-(me * nbl - p) // P))
    return _exchange(blocks, g, dest * m + rank, p * m + j)


def _cyclic(A_loc, block, gr, gc, fwd):
    """The 2D-contiguous <-> block-cyclic exchange of this rank's block
    (forward with fwd) along the groups of the grid's rows (gr) and its
    columns (gc)."""
    rows, cols = A_loc.shape
    if rows % block or cols % block:
        raise ValueError(f"local block ({rows}, {cols}) is not a multiple "
                         f"of block={block} (R={gr.size}, C={gc.size})")
    ex = _cyclic_fwd_exchange if fwd else _cyclic_inv_exchange
    a = A_loc
    if gr.size > 1:
        a = ex(a.reshape(rows // block, block, cols), gr).reshape(rows, cols)
    if gc.size > 1:
        a = a.reshape(rows, cols // block, block).transpose(0, 1)
        a = ex(a, gc).transpose(0, 1).reshape(rows, cols)
    return a


def to_block_cyclic(A_loc, mesh, block):
    """The 2D-contiguous block of A -> this rank's block of the permuted
    matrix A[row_perm][:, col_perm] (block_cyclic.cyclic_permutation),
    by one all_to_all along 'r' and one along 'c'."""
    return _cyclic(A_loc, block, mesh.group("r"), mesh.group("c"), True)


def from_block_cyclic(A_loc, mesh, block):
    """Inverse of to_block_cyclic (cyclic order back to natural order)."""
    return _cyclic(A_loc, block, mesh.group("r"), mesh.group("c"), False)
