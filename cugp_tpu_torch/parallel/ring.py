"""Ring covariance build, as ``cugp_tpu/parallel/ring.py``.

Sequence-parallel covariance construction: the N training points are the
"sequence"; X is row-sharded over a mesh axis and shards rotate around
the ring (``collectives.ring_shift``, JAX's ``ppermute``), so each rank
fills its (n_loc, N) row block of K one column block a step without
ever holding the whole of X. No N x N intermediate and no all-gather of
X.

One difference from the JAX package, on purpose: the ring carries the
RAW rows of X, and each rank scales what it receives by its own copy of
the hyperparameters (JAX rotates the per-factor scaled views). The
collectives then stay off the hyperparameters' gradient: a rank's block
depends on them only through local operations, so its gradient is local
and a sum over the ring (one all_reduce) gives the global one.

Every block goes through the covariance tile kernel
(``kernels.cross_covariance``, per factor for a composite kind, combined
elementwise); the rank's own block (global row = global column on its
diagonal) is ``kernels.train_covariance``, the same build with the
noise/jitter diagonal added. The JAX package evaluates composites with
its plain ``tile_eval``; the port's composite route is the kernel's.
"""

from __future__ import annotations

import torch

from cugp_tpu_torch.ops import kernels as kernel_ops
from cugp_tpu_torch.parallel import collectives


def ring_rows(X_loc, g):
    """Yield (source index, the raw rows it owns) around the ring of g,
    starting with this rank's own rows; X moves one step at a time."""
    x_rot = X_loc
    for s in range(g.size):
        yield (g.index - s) % g.size, x_rot
        if s + 1 < g.size:
            x_rot = collectives.ring_shift(x_rot.detach(), g)


def ring_train_covariance(params, X_loc, mesh, kind="rbf", jitter=1e-6,
                          axis="r"):
    """This rank's (n_loc, n) row block of K(X, X) + noise diag, built by
    ring rotation.

    X_loc: the rank's (n_loc, d) rows of X, sharded along `axis` (a name
    or a tuple of names, e.g. ("r", "c") rings over every rank of the
    grid row-major; ranks off the axis hold the same rows). kind may be
    any base family or a '+'/'*' composite of them.
    """
    kernel_ops.validate_kind(kind)
    g = mesh.group(axis)
    blocks = [None] * g.size
    for src, x_rot in ring_rows(X_loc, g):
        if src == g.index:
            blocks[src] = kernel_ops.train_covariance(params, X_loc,
                                                      kind=kind,
                                                      jitter=jitter)
        else:
            blocks[src] = kernel_ops.cross_covariance(params, X_loc, x_rot,
                                                      kind=kind)
    return torch.cat(blocks, dim=1)
