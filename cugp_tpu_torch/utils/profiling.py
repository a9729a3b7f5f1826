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

Not ported: ``cost_analysis`` (XLA's estimate of a compiled program;
eager PyTorch compiles no program to ask).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


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


# FLOP models (BASELINE.md): the accounting used by every benchmark
def chol_flops(n):
    return n**3 / 3.0


def cov_flops(n1, n2, d):
    return 2.0 * n1 * n2 * d


def trsm_flops(n, n_rhs):
    return float(n) * n * n_rhs


def gflops(flops, seconds):
    return flops / seconds / 1e9
