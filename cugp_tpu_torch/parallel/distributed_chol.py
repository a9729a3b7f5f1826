"""Distributed Cholesky over the mesh, as
``cugp_tpu/parallel/distributed_chol.py``.

The 2D layout holds rows over ('dp', 'r') and columns over 'c'. The JAX
package factors it with a chunked right-looking sweep under GSPMD
sharding constraints and lets XLA place the collectives. Here
``distributed_cholesky`` runs block_cyclic's look-ahead factorization
on it: the rank's 2D block moves to block-cyclic order (rows over ('dp',
'r'), block size ``block_cyclic.block_size(n, R, C, chunk)``), is
factored in place with ``block_cyclic.factor_`` and moves back
(``block_cyclic._cholesky_2d``, which ``block_cyclic_cholesky`` shares).
Its L carries no autograd graph; the LML's gradient is the closed form
below.

``distributed_lml`` builds each rank's block of K straight in
block-cyclic order (the same rows and block size): the covariance tile
kernel on the rows and columns of X that the block holds, so no relayout
moves K. Under the span ``cugp.factorize`` it factors that block in place
with block_cyclic's look-ahead schedule, keeps L there, and solves
alpha = K^{-1} y by a distributed forward and back substitution (alpha
replicated): LML = -1/2 |L^{-1} y|^2 - sum log L_ii - n/2 log 2 pi. Its
gradient is the closed form of ``models/exact_gp._LML`` across the ranks
(``_DistLML``, span ``cugp.chol_backward``, counter
``lml_backward.distributed``): the rank's block of K^{-1} from the
distributed triangular inverse and product (block_cyclic.trtri_ and
lauum_, 2 n^3/3 in all, in the same buffer), then K_bar = g/2
(alpha_rows alpha_cols^T - K^{-1}) on the lower blocks, the blocks below
the diagonal counted twice for the mirrored ones above, and the
covariance kernel's VJP of it (``CovTile``, in row tiles). The
hyperparameters enter through ``grad_sync`` and the replicated LML leaves
through ``replicated_out``: every rank that calls backward() receives
the full gradient, all-reduced, the same bits on every rank. A rank holds
one n/R x n/C buffer (K, then L, W = L^{-1}, K^{-1} and K_bar in turn)
and the panels of one step.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.models.exact_gp import LOG2PI
from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.ops import trsm as trsm_ops
from cugp_tpu_torch.parallel import block_cyclic, collectives
from cugp_tpu_torch.parallel.mesh import AXES
from cugp_tpu_torch.utils import profiling
from cugp_tpu_torch.utils.params import tree_map

ROWS = ("dp", "r")  # the row axes of the 2D layout (P(('dp','r'), 'c'))


def distributed_cholesky(K_loc, mesh, chunk=8192, method="auto"):
    """Lower Cholesky factor of K from its 2D blocks: K_loc is this rank's
    (n/(dp*r), n/c) block (rows over ('dp', 'r'), columns over 'c'); the
    result is the same block of L, with no autograd graph. chunk: the
    largest block of the block-cyclic layout, as distributed_lml's."""
    trsm_ops.check_method(method)
    R, C = mesh.axis_size(ROWS), mesh.shape["c"]
    block = block_cyclic.block_size(K_loc.shape[0] * R, R, C, chunk)
    return block_cyclic._cholesky_2d(K_loc, mesh, ROWS, block)


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


def _covariance_cyclic(params, X, grid, kind, jitter):
    """This rank's block of K(X, X) + noise diag in block-cyclic order,
    through the covariance tile kernel. Returns (K_loc, diag_add): a
    block whose rows are its columns takes the square route (the noise
    inside the kernel; diag_add None); any other takes the cross route,
    and diag_add (differentiable) is for the caller to add on the global
    diagonal's entries (``_diagonal``)."""
    dev = X.device
    rows, cols = grid.rows_index(dev), grid.cols_index(dev)
    if grid.R == grid.C and grid.my_r == grid.my_c:
        return kernel_ops.train_covariance(params, X[rows], kind=kind,
                                           jitter=jitter), None
    return (kernel_ops.cross_covariance(params, X[rows], X[cols],
                                        kind=kind),
            torch.exp(params["log_noise_var"])
            + jitter * kernel_ops.signal_scale(params))


def _diagonal(grid, device):
    """(local rows, local cols) of the global diagonal's entries that this
    rank holds: the diagonals of its blocks (t, u) with t*R + my_r ==
    u*C + my_c."""
    b, off = grid.block, torch.arange(grid.block)
    tu = [(t, (t * grid.R + grid.my_r) // grid.C) for t in range(grid.nbr)
          if (t * grid.R + grid.my_r) % grid.C == grid.my_c]
    rows = torch.cat([t * b + off for t, _ in tu] or [off[:0]])
    cols = torch.cat([u * b + off for _, u in tu] or [off[:0]])
    return rows.to(device), cols.to(device)


class _DistLML(torch.autograd.Function):
    """The distributed LML from the forward's factor (held in `fac`, the
    rank's block-cyclic buffer, outside the graph), differentiable in the
    rank's block of K and in the diagonal term the cross-route blocks
    add: K_bar = g/2 (alpha alpha^T - K^{-1}) on this rank's entries."""

    @staticmethod
    def forward(ctx, k_loc, diag_add, lml, fac):
        ctx.fac = fac
        return lml.clone()

    @staticmethod
    def backward(ctx, g):
        A, grid, alpha, diag = ctx.fac
        ctx.fac = None
        with profiling.span("cugp.chol_backward", A.device):
            profiling.count("lml_backward.distributed")
            # the parts of g the ranks hold, summed (collectives.py)
            g = collectives.all_reduce(g.detach(), grid.gall)
            block_cyclic.trtri_(A, grid)
            block_cyclic.lauum_(A, grid)
            A.addr_(alpha[grid.rows_index(A.device)],
                    alpha[grid.cols_index(A.device)], beta=-1.0)
            b = grid.block
            A.view(grid.nbr, b, grid.nbc, b).mul_(
                (0.5 * g) * grid.block_weights(A.device, A.dtype)[
                    :, None, :, None])
            g_diag = A[diag].sum() if ctx.needs_input_grad[1] else None
        return A, g_diag, None, None


def distributed_lml(params, X_loc, y_loc, mesh, kind="rbf", jitter=1e-6,
                    chunk=8192, cov_method="auto"):
    """LML with the covariance, its factor and the gradient's K^{-1}
    sharded block-cyclically (the module docstring); the same value on
    every rank.

    X_loc, y_loc: the rank's rows over ('dp', 'r'); n must divide over
    the (dp*r) x c grid. chunk: the largest block of the block-cyclic
    layout (the block is the largest divisor of n/(dp*r) and n/c at most
    chunk). Differentiable in params: every rank's backward() gives the
    full gradient.
    """
    trsm_ops.check_method(cov_method)
    world = mesh.group(AXES)
    params = tree_map(lambda t: collectives.grad_sync(t, world), params)
    grow = mesh.group(ROWS)
    with profiling.span("cugp.factorize", X_loc.device):
        X = collectives.all_gather(X_loc.detach(), grow)
        y = collectives.all_gather(y_loc.detach(), grow)
        n = X.shape[0]
        R, C = grow.size, mesh.group("c").size
        block = block_cyclic.block_size(n, R, C, chunk)
        grid = block_cyclic.Grid(mesh, n // block, block, rows=ROWS)
        K_loc, diag_add = _covariance_cyclic(params, X, grid, kind, jitter)
        diag = _diagonal(grid, X.device)
        with torch.no_grad():
            A = K_loc.detach()  # factored in place: K's buffer holds L
            if diag_add is not None:
                A[diag] += diag_add
            block_cyclic.factor_(A, grid)
            z = block_cyclic.tri_solve(A, grid, y)
            logdet_half = collectives.all_reduce(
                torch.sum(torch.log(A[diag])), grid.gall)
            lml = -0.5 * torch.dot(z, z) - logdet_half - 0.5 * n * LOG2PI
        if K_loc.requires_grad:
            with torch.no_grad():
                alpha = block_cyclic.tri_solve(A, grid, z, transpose=True)
            if diag_add is None:
                diag_add = K_loc.new_zeros(())
            lml = _DistLML.apply(K_loc, diag_add, lml,
                                 (A, grid, alpha, diag))
    return collectives.replicated_out(lml, world)

