"""Distributed Cholesky over the mesh, as
``cugp_tpu/parallel/distributed_chol.py``.

A chunked right-looking sweep over the 2D layout (rows over ('dp', 'r'),
columns over 'c'). The JAX package writes it under GSPMD sharding
constraints and lets XLA place the collectives; here they are explicit.
For each diagonal chunk s (size B_c, e.g. 8192):

  1. the chunk's columns reach every rank of a mesh row (a broadcast
     along 'c' from each column owner), its diagonal block every rank (a
     broadcast along the rows from each row owner), and each rank factors
     the diagonal block itself with ``ops.cholesky`` (the potrf kernel);
  2. each rank solves its own rows of the panel, P = K[s+1:, s]
     L_ss^{-T}, with ``ops.trsm`` (the TRSM kernel);
  3. the panel is all-gathered along the rows, so each rank holds the
     panel rows of its columns;
  4. each rank applies its part of the SYRK update K[s+1:, s+1:] -= P
     P^T with one ``torch.matmul``.

The layout stays where it is: a rank's trailing block shrinks as the
sweep passes its rows and columns (the block-cyclic layout of
block_cyclic.py is the one that balances it). The diagonal chunks are
factored redundantly on every rank, as the JAX package replicates them.

Every step is differentiable (the collectives' backward is their adjoint,
collectives.py), so ``distributed_lml`` has a gradient: the hyperparameters
enter through ``grad_sync`` and the replicated LML leaves through
``replicated_out``, and every rank that calls backward() receives the
full gradient.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.models.exact_gp import LOG2PI
from cugp_tpu_torch.ops import cholesky as chol_ops
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.parallel import collectives
from cugp_tpu_torch.parallel.mesh import AXES
from cugp_tpu_torch.utils.params import tree_map

ROWS = ("dp", "r")  # the row axes of the 2D layout (P(('dp','r'), 'c'))


def _owners(lo, hi, width):
    """[(owner, a, b)]: the owners of global range [lo, hi) when owner j
    holds [j*width, (j+1)*width), with the range in its local indices."""
    return [(j, max(lo, j * width) - j * width,
             min(hi, (j + 1) * width) - j * width)
            for j in range(lo // width, -(-hi // width))]


def _placeholder(like, shape):
    """Zeros of `shape` that require grad exactly when `like` does: what a
    non-source rank hands a broadcast, so that every rank records the same
    autograd nodes (and runs the same collectives in backward)."""
    return like.new_zeros(shape) + like[:0].sum()


def _gather_pieces(src_of, owners, g, shape_of, cat_dim):
    """Concatenate the pieces of `owners`, each broadcast along g from its
    owner (src_of(a, b) on the owner, a placeholder elsewhere)."""
    pieces = []
    for j, a, b in owners:
        src = src_of(a, b) if j == g.index else _placeholder(
            src_of(0, 0), shape_of(b - a))
        pieces.append(collectives.broadcast(src, g, j))
    return torch.cat(pieces, dim=cat_dim)


def _sweep(K_loc, mesh, chunk, y=None, want_L=True):
    """The chunked right-looking sweep on this rank's 2D block.

    y: optional replicated (n,) right-hand side; its forward substitution
    rides the sweep (z_s = L_ss^{-1} y_s, then y[s+1:] -= P z_s on the
    replicated panel). Returns (L_loc or None, sum of z_s^2 or None,
    sum of log diag L)."""
    grow, gcol = mesh.group(ROWS), mesh.group("c")
    nr, nc = K_loc.shape
    n = nr * grow.size
    if nc * gcol.size != n:
        raise ValueError(f"local block {tuple(K_loc.shape)} is not a "
                         f"({grow.size} x {gcol.size}) grid's block of a "
                         "square matrix")
    ro, co = grow.index * nr, gcol.index * nc
    chunk = min(chunk, n)
    A, r0 = K_loc, 0  # the trailing block; its first local row
    L_cols, quad, logdet_half = [], None, 0.0
    for o in range(0, n, chunk):
        b = min(chunk, n - o)
        # 1. the chunk's columns of my active rows, then its diagonal block
        strip = _gather_pieces(lambda a, e: A[:, :e - a],
                               _owners(o, o + b, nc), gcol,
                               lambda w: (A.shape[0], w), 1)
        A_ss = _gather_pieces(lambda a, e: strip[:e - a],
                              _owners(o, o + b, nr), grow,
                              lambda h: (h, b), 0)
        L_ss = chol_ops.cholesky(A_ss)
        logdet_half = logdet_half + torch.sum(torch.log(torch.diagonal(L_ss)))
        # 2. my rows of the panel
        k_in = min(max(o + b - (ro + r0), 0), strip.shape[0])
        panel = strip[k_in:]
        if panel.shape[0]:
            panel = trsm_ops.solve_xlt(L_ss, panel)
        if want_L:
            top = max(ro + r0 - o, 0)
            lcol = torch.cat([strip.new_zeros((r0, b)),
                              L_ss[top:top + k_in], panel])
            lo, hi = max(o, co), min(o + b, co + nc)
            if hi > lo:
                L_cols.append(lcol[:, lo - o:hi - o])
        if y is not None:
            z = trsm_ops.solve_lx(L_ss, y[:b])
            q = torch.sum(z * z)
            quad = q if quad is None else quad + q
        if o + b == n:
            break
        # 3. the panel rows of every global row (zeros above the chunk's
        # end), then those of my trailing columns
        P = collectives.all_gather(
            torch.cat([panel.new_zeros((nr - panel.shape[0], b)), panel]),
            grow)
        cl = max(o + b, co)
        # 4. my part of the trailing update
        A = A[k_in:, A.shape[1] - (co + nc - cl):] - panel @ P[cl:co + nc].mT
        r0 += k_in
        if y is not None:
            y = y[b:] - P[o + b:] @ z
    L_loc = torch.cat(L_cols, dim=1) if want_L else None
    return L_loc, quad, logdet_half


def distributed_cholesky(K_loc, mesh, chunk=8192, method="auto"):
    """Lower Cholesky factor of K from its 2D blocks: K_loc is this rank's
    (n/(dp*r), n/c) block (rows over ('dp', 'r'), columns over 'c'); the
    result is the same block of L. chunk: diagonal chunk size."""
    trsm_ops.check_method(method)
    return _sweep(K_loc, mesh, chunk)[0]


def covariance_2d(params, X_loc, mesh, kind="rbf", jitter=1e-6):
    """This rank's 2D block of K(X, X) + noise diag, and the gathered X.

    X_loc: the rank's rows of X over ('dp', 'r'). X (n x d) is
    all-gathered along the rows; the block goes through the covariance
    tile kernel, the square route (its diagonal exact) where the block
    holds the global diagonal, else the cross route with the diagonal
    added where global row equals global column."""
    grow, gcol = mesh.group(ROWS), mesh.group("c")
    X = collectives.all_gather(X_loc.detach(), grow)
    nr, n = X_loc.shape[0], X.shape[0]
    if n % gcol.size:
        raise ValueError(f"n={n} is not divisible by c={gcol.size}")
    nc = n // gcol.size
    ro, co = grow.index * nr, gcol.index * nc
    if ro == co and nr == nc:
        return kernel_ops.train_covariance(params, X_loc, kind=kind,
                                           jitter=jitter), X
    K = kernel_ops.cross_covariance(params, X_loc, X[co:co + nc], kind=kind)
    diag_add = (torch.exp(params["log_noise_var"])
                + jitter * kernel_ops.signal_scale(params))
    K.diagonal(ro - co).add_(diag_add)
    return K, X


def distributed_lml(params, X_loc, y_loc, mesh, kind="rbf", jitter=1e-6,
                    chunk=8192, cov_method="auto"):
    """LML with the 2D-sharded covariance and the chunked distributed
    Cholesky; the same value on every rank.

    X_loc, y_loc: the rank's rows over ('dp', 'r'). The solve against y
    is the forward substitution that rides the sweep (the LML needs
    |L^-1 y|^2); the O(N^2)/O(N^3) work is sharded. Differentiable in
    params: every rank's backward() gives the full gradient.
    """
    trsm_ops.check_method(cov_method)
    world = mesh.group(AXES)
    params = tree_map(lambda t: collectives.grad_sync(t, world), params)
    K_loc, X = covariance_2d(params, X_loc, mesh, kind=kind, jitter=jitter)
    y = collectives.all_gather(y_loc.detach(), mesh.group(ROWS))
    _, quad, logdet_half = _sweep(K_loc, mesh, chunk, y=y, want_L=False)
    n = X.shape[0]
    lml = -0.5 * quad - logdet_half - 0.5 * n * LOG2PI
    return collectives.replicated_out(lml, world)
