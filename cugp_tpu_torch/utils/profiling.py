"""Tracing and timing helpers, as ``cugp_tpu/utils/profiling.py``.

``trace(logdir)`` records the enclosed block with ``torch.profiler`` (the
host and, when a CUDA device is present, the device) and writes a
Chrome trace into ``logdir``; it takes the place of the JAX package's
xprof capture. ``timed`` is the median time of a call, by CUDA events on
a CUDA device and by the host clock on the CPU. The FLOP models are the
JAX package's (BASELINE.md's accounting). The fetch-barrier timers:
``_fetch_barrier`` reads one element of every tensor of an output,
``rtt_overhead`` is the host's round trip of one tiny device op and its
read, and ``timed_loop`` the seconds an iteration of a chain of calls
between two CUDA events.

Spans and counters inside the program. ``span(name)`` marks a layer's
work (``cugp.step``, ``cugp.request``, ``cugp.factorize``,
``cugp.chol_backward``, ``cugp.precond_build``, ``cugp.cg_solve``,
``cugp.grad_sweep``) and ``count(site)`` counts an event (``host_read.*``:
each read of a device value by the host, through ``read_bool`` and
``read_float``; ``lml_backward.*``: the LML backward a step took;
``collective_bytes.<op>``: the bytes a collective moved on this rank,
``parallel/collectives.py``). Both record only while a torch profiler session records
(``torch.autograd.profiler._is_profiler_enabled``, the flag torch sets
for every session, ``trace`` and the CLI's ``--profile`` among them);
otherwise they cost that one flag read and do nothing. A recording span
opens ``record_function(name)``, so it shows in the session's Chrome
trace beside the device's kernels; stamps its start and end with
``time.time_ns()``, the clock of that trace (kineto's
``baseTimeNanoseconds`` plus each event's ``ts``); and, on a CUDA
device, records a CUDA event at each end on the current stream, giving
its interval on the device's timeline (idle time inside it included),
resolved only when read. A span adds no host read. Each span record
holds its name, its host stamps, its device interval, its parent (the
innermost span open in the process when it began, on whatever thread:
autograd runs the backward on a thread of its own) and the operation it
belongs to (the step or request of its root span). The record lives in
memory and is the last session's: the first span or count that finds a
new session clears what an earlier one left. ``spans()``, ``span_ms``
and ``counts()`` read it.

Not ported: ``cost_analysis`` (XLA's estimate of a compiled program;
eager PyTorch compiles no program to ask).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir):
    """torch.profiler over the enclosed block (CPU activities, and CUDA
    ones when a card is present); the Chrome trace goes to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto). The
    profiler object is yielded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn, *args, warmup=1, iters=5):
    """Median seconds of fn(*args) after `warmup` calls: by CUDA events
    on the current stream when a card is present (the device's work is
    counted, not only the launch), else by the host clock."""
    on_card = torch.cuda.is_available()
    for _ in range(warmup):
        fn(*args)
    times = []
    if on_card:
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _fetch_barrier(out):
    """Wait for `out` by reading one element of each of its tensors (a
    tensor, or a nested tuple/list/dict of them) back to the host."""
    from cugp_tpu_torch.utils.params import tree_leaves

    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            float(leaf.reshape(-1)[0])


def rtt_overhead(iters=5, device=None):
    """Host seconds of one tiny device op and the read of its result
    (the dispatch and fetch round trip), averaged over `iters` after one
    warm-up; on `device` (the card when present, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.zeros((), device=device)
    _fetch_barrier(x + 1.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        _fetch_barrier(x + 1.0)
    return (time.perf_counter() - t0) / iters


def timed_loop(step_fn, init, iters=8, warmup=True):
    """Seconds an iteration of `iters` chained calls c = step_fn(c) from
    init (step_fn returns what it takes), after one warm-up call: between
    two CUDA events and one synchronize when init holds a CUDA tensor
    (device time, no host round trip in it), by the host clock and a
    fetch barrier otherwise."""
    from cugp_tpu_torch.utils.params import tree_leaves

    on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                  for t in tree_leaves(init))
    if warmup:
        _fetch_barrier(step_fn(init))
    c = init
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            c = step_fn(c)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        c = step_fn(c)
    _fetch_barrier(c)
    return (time.perf_counter() - t0) / iters


# ---- spans and counters: recorded only while a profiler session records

class SpanRecord:
    """One recorded span: ``name``; ``parent``, the SpanRecord of the
    innermost span open when it began (None at the top); ``op``, the id
    of the step or request its root span began (None outside one);
    ``t0_ns`` and ``t1_ns``, its host stamps by ``time.time_ns()``
    (t1_ns None while it is open)."""

    __slots__ = ("name", "parent", "op", "t0_ns", "t1_ns", "_events", "_ms")

    def __init__(self, name, parent, op, events):
        self.name, self.parent, self.op = name, parent, op
        self.t0_ns = self.t1_ns = None
        self._events, self._ms = events, None

    @property
    def ms(self):
        """Milliseconds between the span's two CUDA events, its interval on
        the device's timeline (waiting for the second); the host interval
        for a span without them."""
        if self._events is None:
            return (self.t1_ns - self.t0_ns) / 1e6
        if self._ms is None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
        return self._ms


class _Record:
    """The spans and counts of one profiler session; ``stale`` once a
    call has seen no session recording, so that the next session's first
    span or count clears it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stale = True
        self.spans, self.open, self.counts = [], [], {}
        self.ops = itertools.count()

    def clear(self):
        self.spans, self.open, self.counts = [], [], {}
        self.ops = itertools.count()
        self.stale = False


_RECORD = _Record()
_OFF = contextlib.nullcontext()


def _recording():
    """Whether a profiler session records now (one flag read); the first
    call under a new session clears the previous session's record."""
    if _autograd_profiler._is_profiler_enabled:
        if _RECORD.stale:
            with _RECORD.lock:
                if _RECORD.stale:
                    _RECORD.clear()
        return True
    _RECORD.stale = True
    return False


class _Span:
    def __init__(self, name, device, root):
        self.name, self.root = name, root
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        self.rf = _autograd_profiler.record_function(self.name)
        self.rf.__enter__()
        events = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if self.cuda
                  else None)
        rec = _RECORD
        with rec.lock:
            parent = rec.open[-1] if rec.open else None
            op = (next(rec.ops) if self.root
                  else parent.op if parent is not None else None)
            self.span = SpanRecord(self.name, parent, op, events)
            rec.spans.append(self.span)
            rec.open.append(self.span)
        self.span.t0_ns = time.time_ns()
        if events is not None:
            events[0].record()
        return self.span

    def __exit__(self, *exc):
        s = self.span
        if s._events is not None:
            s._events[1].record()
        s.t1_ns = time.time_ns()
        with _RECORD.lock:
            # another thread's spans may have opened since this one
            for i in range(len(_RECORD.open) - 1, -1, -1):
                if _RECORD.open[i] is s:
                    del _RECORD.open[i]
                    break
        self.rf.__exit__(*exc)
        return False


def span(name, device=None, root=False):
    """A context manager marking the enclosed work as span `name` of the
    recording profiler session; a no-op (one flag read) when none
    records. device: where the work runs (a CUDA device adds the two
    events of the device interval). root: the span begins an operation
    (a step or a request) and gives it a new id, which the spans opened
    inside it share."""
    if not _recording():
        return _OFF
    return _Span(name, device, root)


def count(site, k=1):
    """Add k to the counter `site` of the recording session (a no-op
    when none records)."""
    if _recording():
        with _RECORD.lock:
            _RECORD.counts[site] = _RECORD.counts.get(site, 0) + k


def read_bool(t, site):
    """bool(t): the host's read of a device value, counted as
    ``host_read.<site>``."""
    count("host_read." + site)
    return bool(t)


def read_float(t, site):
    """float(t), counted as ``read_bool`` counts."""
    count("host_read." + site)
    return float(t)


def spans():
    """The closed spans of the last session, in the order they began."""
    _recording()
    return [s for s in _RECORD.spans if s.t1_ns is not None]


def span_ms(name):
    """Summed milliseconds of the spans named `name` in the last
    session's record (each span's device interval on a CUDA device, its
    host interval otherwise); 0.0 when none of them ran, None when the
    record holds no span at all."""
    every = spans()
    if not every:
        return None
    return sum(s.ms for s in every if s.name == name)


def counts():
    """The last session's counters, by site."""
    _recording()
    return dict(_RECORD.counts)


# FLOP models (BASELINE.md): the accounting used by every benchmark
def chol_flops(n):
    return n**3 / 3.0


def cov_flops(n1, n2, d):
    return 2.0 * n1 * n2 * d


def trsm_flops(n, n_rhs):
    return float(n) * n * n_rhs


def gflops(flops, seconds):
    return flops / seconds / 1e9
