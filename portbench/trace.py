"""The traced window: ``torch.profiler`` over the whole measured window,
reduced to device busy time, device time by kernel, and idle gaps by
what the host was doing.

Busy time is the union of the intervals in which an operation (a
kernel, a copy or a set) ran on the device, clipped to the window, so
overlapping streams count once; the window is the span
``portbench.window`` that the harness opens around its loop. An idle
gap is a stretch of the window with nothing on the device; it is named
after the innermost host operation in progress when it began.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile

WINDOW_SPAN = "portbench.window"


# Chrome-trace categories of the device's operations and of the host's
# spans (a host span is mirrored on the device's timeline as a
# "gpu_user_annotation", which is no operation)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _events(prof):
    """[(name, start_us, end_us)] of the device's operations and of the
    host's spans, from the profiler's Chrome trace (written by kineto's
    own exporter into TMPDIR, read once, deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    dev, host = [], []
    for e in raw.get("traceEvents", raw if isinstance(raw, list) else []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        row = (e.get("name", "?"), float(e["ts"]), float(e["ts"]) + e["dur"])
        if cat in DEVICE_CATS:
            dev.append(row)
        elif cat in HOST_CATS:
            host.append(row)
    return dev, host


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top=10):
    """The window's device busy seconds, its length, device seconds by
    operation name and idle seconds by host activity."""
    dev, host = _events(prof)
    spans = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if not spans:
        return None
    w0, w1 = spans[0]
    by_op, clipped = {}, []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
            clipped.append((s, e))
    merged = _union(clipped)
    busy = sum(e - s for s, e in merged) * 1e-6
    # idle gaps: before the first operation, between them, after the last
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    inner = sorted((s, e, n) for n, s, e in host if n != WINDOW_SPAN
                   and not n.startswith("portbench."))
    # one sweep over the gaps in time order: `open_` holds the host spans
    # begun by the gap's start, keyed by their end; the one that ends
    # first among those still running is the innermost
    idle, open_, j = {}, [], 0
    for g0, g1 in gaps:
        while j < len(inner) and inner[j][0] <= g0:
            heapq.heappush(open_, (inner[j][1], inner[j][2]))
            j += 1
        while open_ and open_[0][0] < g0:
            heapq.heappop(open_)
        label = open_[0][1] if open_ else "host between operations"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    gaps_named = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "by_op": by_op, "device_ops": [[n[:200], v] for n, v in ops[:top]],
            "idle_gaps": [[n[:200], v] for n, v in gaps_named[:top]],
            "device_events": len(dev)}


@contextlib.contextmanager
def traced_window(enabled, sync, on_card=True):
    """The measured window, under the profiler when `enabled` (the host
    and, on a card, the device). Yields a holder whose ``prof`` is the
    finished profiler (None untraced)."""
    holder = type("Traced", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            sync()
    holder.prof = prof
