"""What the program recorded in the traced window: its spans and counters
(``cugp_tpu_torch.utils.profiling``). The program records them only while
a profiler session runs, which is the traced window alone (set-up runs
before it), and keeps them until the next session, so the readers find
the window's record after it has closed. A span's milliseconds are its
interval on the device's timeline (CUDA events; the host's clock on the
CPU). An untraced run, or a program without the spans, gives None."""

from __future__ import annotations


def _profiling(run):
    if run.trace is None:  # untraced: no session recorded
        return None
    try:
        from cugp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "span_ms") else None


def span_ms_per(run, name, per):
    """Milliseconds of the window's spans `name`, summed, over `per`."""
    prof = _profiling(run)
    if prof is None or not per:
        return None
    ms = prof.span_ms(name)
    return None if ms is None else ms / per


def span_ms_per_op(run, name):
    """The same per operation: a fit step, or a posterior request."""
    return span_ms_per(run, name, run.tally["ops"])


def host_reads_per_op(run):
    """The window's ``host_read.*`` counts, summed, per operation."""
    prof = _profiling(run)
    if prof is None or run.tally["ops"] <= 0 or not prof.spans():
        return None
    reads = sum(v for k, v in prof.counts().items()
                if k.startswith("host_read."))
    return reads / run.tally["ops"]
