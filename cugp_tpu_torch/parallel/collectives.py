"""The distributed tier's collectives on ``torch.distributed``.

Each JAX collective of ``cugp_tpu/parallel/`` has one function here:
``ppermute`` is ``batch_isend_irecv`` (a ring of one is the identity and
makes no call), ``psum``/``pmean`` are ``all_reduce``, ``all_gather``
stays ``all_gather``, ``all_to_all`` is ``all_to_all_single``, and the
block-cyclic panel broadcasts are ``broadcast`` (with ``async_op`` for the
look-ahead). A ``Group`` is one process group of a mesh
(``mesh.Mesh.group``); a group of one rank has no process group and its
collectives return their input.

On the gradient's path every collective is a ``torch.autograd.Function``
whose backward is the adjoint collective: all_reduce <-> all_reduce,
all_gather <-> sum-reduce then slice, broadcast <-> reduce to the
source, ppermute <-> the inverse permutation, all_to_all <-> all_to_all.
The convention behind those adjoints: a tensor replicated over a group
carries on each rank a PART of its gradient (the parts sum to the
gradient), a sharded tensor carries its own. ``grad_sync`` (identity
forward, all_reduce backward) is where replicated inputs such as the
hyperparameters enter a distributed computation, and ``replicated_out``
(identity forward, backward divided by the group size) where a
replicated result leaves it; between the two, every rank may call
``backward()`` on the result and receives the full gradient. Every rank
must create the collectives in the same order: autograd then runs their
backward in the reverse order on every rank.

Gloo (torch 2.11, the H100 machine's; chip_smoke.py phase 12 probes
each collective) carries CUDA tensors for all_reduce, broadcast,
all_gather and all_to_all_single, but not for send/recv: a CUDA tensor
there crashes gloo's I/O thread. So a ring shift under gloo copies CUDA
tensors to the host, exchanges them there and copies them back: a
transport for several ranks that share one card, counted in ``STAGED``
(bytes by collective). The NCCL path never stages, and the computation
stays on the card either way. ``CALLS`` counts the calls each collective made
(the JAX tests read the compiled program's collectives; the port's read
these counts). In a recording profiler session each call also adds the
bytes it moves on this rank to the counter ``collective_bytes.<op>``
(``utils.profiling.count``): the buffer it fills here (a broadcast's or an
all_reduce's tensor, an all_gather's whole output, an all_to_all's
received chunks, a ring shift's received tensors); a group of one rank
moves nothing and adds 0.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from cugp_tpu_torch.utils import profiling

CALLS = collections.Counter()   # collective -> calls made
STAGED = collections.Counter()  # collective -> bytes staged through the host

# what gloo carries for CUDA tensors without a host copy
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                           "all_to_all"})


def reset_counts():
    CALLS.clear()
    STAGED.clear()


def world():
    """(world size, rank) of the default process group; (1, 0) when none
    is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Group:
    """The ranks (global, in group order) of one mesh group and their
    process group (None for one rank)."""

    def __init__(self, ranks, pg):
        self.ranks = list(ranks)
        self.pg = pg
        self.index = self.ranks.index(world()[1])
        self.backend = None if pg is None else dist.get_backend(pg)

    @property
    def size(self):
        return len(self.ranks)


def new_group(ranks, whole=False):
    """A Group over `ranks`; every rank of the world must call this for
    every group, in the same order. whole: the ranks are the world in
    order (the default group serves)."""
    if len(ranks) == 1:
        return Group(ranks, None) if world()[1] in ranks else None
    pg = dist.group.WORLD if whole else dist.new_group(ranks)
    return Group(ranks, pg) if world()[1] in ranks else None


def as_group(g):
    """A Group from a Group or a torch ProcessGroup. An axis name alone
    (JAX's psum_axis="dp") names nothing without its mesh."""
    if g is None or isinstance(g, Group):
        return g
    if isinstance(g, dist.ProcessGroup):
        return Group(dist.get_process_group_ranks(g), g)
    raise TypeError(f"expected a mesh Group (mesh.group(axis)) or a "
                    f"torch ProcessGroup, got {g!r}")


def _staged(op, g, t):
    return g.backend == "gloo" and t.is_cuda and op not in GLOO_CUDA_OPS


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _moved(op, *ts):
    """Count the bytes of ts as moved by collective `op` on this rank."""
    profiling.count("collective_bytes." + op, _nbytes(*ts))


# ---- the collectives themselves (no autograd) ----


def _all_reduce_(t, g):
    """Sum t over the group, in place."""
    CALLS["all_reduce"] += 1
    _moved("all_reduce", t)
    dist.all_reduce(t, group=g.pg)
    return t


def _all_gather(t, g, dim):
    CALLS["all_gather"] += 1
    src = t.movedim(dim, 0).contiguous()
    staged = _staged("all_gather", g, src)
    x = src.cpu() if staged else src
    outs = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(outs, x, group=g.pg)
    out = torch.cat(outs)
    _moved("all_gather", out)
    if staged:
        STAGED["all_gather"] += _nbytes(x, out)
        out = out.to(t.device)
    return out.movedim(0, dim)


def _all_to_all(t, g):
    """all_to_all_single on dim 0 in equal splits: the rank receives
    chunk `its index` of every peer's t, in peer order."""
    CALLS["all_to_all"] += 1
    src = t.contiguous()
    staged = _staged("all_to_all", g, src)
    x = src.cpu() if staged else src
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g.pg)
    _moved("all_to_all", out)
    if staged:
        STAGED["all_to_all"] += _nbytes(x, out)
        out = out.to(t.device)
    return out


def _shift(ts, g, shift):
    """Send each t to group index + shift and receive the same shapes from
    index - shift (one batch_isend_irecv for all of them)."""
    CALLS["ppermute"] += 1
    srcs = [t.contiguous() for t in ts]
    staged = _staged("ppermute", g, srcs[0])
    xs = [s.cpu() for s in srcs] if staged else srcs
    outs = [torch.empty_like(x) for x in xs]
    to = g.ranks[(g.index + shift) % g.size]
    frm = g.ranks[(g.index - shift) % g.size]
    ops = []
    for x, o in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x, to, group=g.pg))
        ops.append(dist.P2POp(dist.irecv, o, frm, group=g.pg))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _moved("ppermute", *outs)
    if staged:
        STAGED["ppermute"] += 2 * _nbytes(*xs)
        outs = [o.to(t.device) for o, t in zip(outs, ts)]
    return outs


def _broadcast(t, g, src, async_op=False):
    """Broadcast t (in place) from group index src; with async_op, returns
    the work to wait on."""
    CALLS["broadcast"] += 1
    _moved("broadcast", t)
    return dist.broadcast(t, src=g.ranks[src], group=g.pg,
                          async_op=async_op)


# ---- autograd Functions (backward = the adjoint collective) ----


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce_(x.clone(), g)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce_(gy.clone(), ctx.g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        s = _all_reduce_(gy.contiguous().clone(), ctx.g)
        return s.narrow(ctx.dim, ctx.g.index * ctx.n, ctx.n), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_to_all(x, g)

    @staticmethod
    def backward(ctx, gy):
        return _all_to_all(gy, ctx.g), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift):
        ctx.g, ctx.shift = g, shift
        return _shift([x], g, shift)[0]

    @staticmethod
    def backward(ctx, gy):
        return _shift([gy], ctx.g, -ctx.shift)[0], None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, src):
        ctx.g, ctx.src = g, src
        y = x.detach().clone().contiguous()
        _broadcast(y, g, src)
        return y

    @staticmethod
    def backward(ctx, gy):
        s = _all_reduce_(gy.contiguous().clone(), ctx.g)
        return (s if ctx.g.index == ctx.src else None), None, None


class _GradSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce_(gy.clone(), ctx.g), None


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return gy / ctx.size, None


def all_reduce(x, g):
    """Sum of x over the group, on every rank (psum)."""
    if g.size == 1:
        _moved("all_reduce")
        return x
    return _AllReduce.apply(x, g)


def all_gather(x, g, dim=0):
    """The ranks' x concatenated along dim in group order."""
    if g.size == 1:
        _moved("all_gather")
        return x
    return _AllGather.apply(x, g, dim)


def all_to_all(x, g):
    """Equal chunks of x along dim 0 exchanged: chunk j goes to group
    index j; the result holds chunk `index` of every rank, in order."""
    if g.size == 1:
        _moved("all_to_all")
        return x
    return _AllToAll.apply(x, g)


def ring_shift(x, g, shift=1):
    """ppermute by `shift` around the group's ring: send to index +
    shift, receive from index - shift."""
    if g.size == 1:
        _moved("ppermute")
        return x
    return _Shift.apply(x, g, shift)


def ring_shift_many(xs, g, shift=1):
    """ring_shift of several tensors in one batch of sends and receives
    (no gradient)."""
    if g.size == 1:
        _moved("ppermute")
        return list(xs)
    return _shift(xs, g, shift)


def broadcast(x, g, src):
    """x of group index src on every rank; x on the other ranks only
    gives the shape (its values are not read)."""
    if g.size == 1:
        _moved("broadcast")
        return x
    return _Broadcast.apply(x, g, src)


def broadcast_async(x, g, src):
    """Start broadcasting x in place from group index src (no gradient);
    returns the work to wait on, or None for one rank."""
    if g.size == 1:
        _moved("broadcast")
        return None
    return _broadcast(x, g, src, async_op=True)


def grad_sync(x, g):
    """x as it is; its gradient summed over the group (where replicated
    inputs enter a distributed computation)."""
    return x if g.size == 1 else _GradSync.apply(x, g)


def replicated_out(x, g):
    """x as it is; its gradient divided by the group size (where a result
    replicated over the group leaves a distributed computation)."""
    return x if g.size == 1 else _ReplicatedOut.apply(x, g.size)
