"""Device mesh over the ranks of a process group, as
``cugp_tpu/parallel/mesh.py``.

Axes:
  'dp' — data parallel: independent HMC chains / optimizer restarts
  'r', 'c' — 2D tensor-parallel grid for K/L (covariance, Cholesky)
The N (training-point) axis is the sequence-parallel axis: rows of X/y
are sharded over 'r'. One rank is one device (one GPU under ``torchrun
--nproc_per_node=G``, or a CPU process on gloo); ranks are laid out
row-major over ('dp', 'r', 'c'), as the JAX package reshapes
``devices[:n]`` to (dp, r, c).

Where JAX names an axis inside ``shard_map``, the port holds a process
group: ``Mesh.group(axes)`` is the group of the ranks that share every
coordinate outside ``axes`` (one axis, or a tuple such as ("r", "c") for
a ring over the whole grid). ``make_mesh`` creates every such group with
``dist.new_group``, in the same order on every rank, as torch requires;
a group over axes of size 1 is one rank and has no process group (its
collectives are the identity and make no call).

``SPECS`` and ``sharding`` say which rows and columns of a global array a
rank owns under each layout (JAX's PartitionSpec / NamedSharding):
``sharding(mesh, name).shard(A)`` is the rank's block of A and
``.gather(a_loc)`` reassembles A on every rank.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from cugp_tpu_torch.parallel import collectives

AXES = ("dp", "r", "c")


def _grid_factor(n):
    """Most-square (r, c) factorization of n (prefers r >= c)."""
    best = (n, 1)
    for c in range(1, int(math.isqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


def _as_axes(axes):
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {AXES}")
    return axes


class Mesh:
    """A ('dp', 'r', 'c') grid of ranks with a process group per set of
    axes. ``shape[axis]`` is the axis size, ``coords[axis]`` this rank's
    coordinate, ``group(axes)`` its group along those axes."""

    def __init__(self, dp, r, c, rank, groups):
        self.shape = {"dp": dp, "r": r, "c": c}
        self.rank = rank
        self.coords = dict(zip(AXES, (int(i) for i in
                                      np.unravel_index(rank, (dp, r, c)))))
        self._groups = groups  # canonical axes tuple -> collectives.Group

    def _canon(self, axes):
        return tuple(a for a in AXES if a in _as_axes(axes)
                     and self.shape[a] > 1)

    def group(self, axes):
        """The Group of this rank along `axes` (a name or a tuple)."""
        return self._groups[self._canon(axes)]

    def axis_size(self, axes):
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def axis_index(self, axes):
        """This rank's row-major index along `axes` (jax.lax.axis_index)."""
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def make_mesh(n_devices=None, dp=1):
    """Build a ('dp', 'r', 'c') mesh over the ranks of the default process
    group (one rank and no process group when none is initialized).

    dp: size of the data-parallel (chains) axis; the remaining n/dp ranks
    form the most-square (r, c) grid for the 2D K/L sharding. Every rank
    must call this, in the same order relative to its other group
    creations.
    """
    world, rank = collectives.world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: n_devices={n} must be the number of "
                         f"ranks ({world}); one rank is one device")
    if n % dp != 0:
        raise ValueError(f"dp={dp} must divide n_devices={n}")
    r, c = _grid_factor(n // dp)
    shape = {"dp": dp, "r": r, "c": c}
    coords = np.arange(n).reshape(dp, r, c)
    groups = {(): collectives.Group([rank], None)}
    for k in range(1, len(AXES) + 1):
        for axes in itertools.combinations(AXES, k):
            canon = tuple(a for a in axes if shape[a] > 1)
            if canon in groups:
                continue
            inner = [AXES.index(a) for a in canon]
            outer = [i for i in range(3) if i not in inner]
            # ranks sharing every coordinate outside `canon`, row-major
            # over `canon`: one group per setting of the outer coordinates
            arr = coords.transpose(outer + inner).reshape(
                -1, math.prod(shape[a] for a in canon))
            for ranks in arr.tolist():
                g = collectives.new_group(ranks, whole=len(ranks) == n)
                if rank in ranks:
                    groups[canon] = g
    return Mesh(dp, r, c, rank, groups)


def grid_shape(mesh):
    return mesh.shape["r"], mesh.shape["c"]


# Canonical layouts for the GP workload: one entry a dimension, an axis
# name, a tuple of names (sharded row-major over them) or None
# (replicated) — JAX's PartitionSpecs.
SPECS = {
    "X_rows": ("r", None),      # SP/CP: training points are the sequence
    "y_rows": ("r",),
    "K_2d": ("r", "c"),         # TP: dense K/L on the 2D grid
    "chains": ("dp",),          # DP: chain axis
    "replicated": (),
}


class Sharding:
    """Which block of a global array a rank owns under `spec` (a SPECS
    value or an explicit tuple), and the moves between the two."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def slices(self, shape):
        """The rank's block of a global array of `shape`, as slices."""
        out = []
        for dim, n in enumerate(shape):
            axes = self.spec[dim] if dim < len(self.spec) else None
            if axes is None:
                out.append(slice(None))
                continue
            parts = self.mesh.axis_size(axes)
            if n % parts:
                raise ValueError(f"dimension {dim} of size {n} is not "
                                 f"divisible by the {parts} ranks of {axes}")
            w = n // parts
            i = self.mesh.axis_index(axes)
            out.append(slice(i * w, (i + 1) * w))
        return tuple(out)

    def shard(self, A):
        """This rank's block of the global array A."""
        return A[self.slices(A.shape)]

    def gather(self, a_loc):
        """The global array on every rank from each rank's block
        (all_gather along each sharded dimension; differentiable)."""
        for dim, axes in enumerate(self.spec):
            if axes is not None:
                a_loc = collectives.all_gather(a_loc, self.mesh.group(axes),
                                               dim=dim)
        return a_loc


def sharding(mesh, name):
    return Sharding(mesh, SPECS[name])
