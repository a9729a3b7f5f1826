"""Megabytes (10^6 bytes) the program's collectives move on the traced
rank a step: its ``collective_bytes.<op>`` counters (every broadcast,
all_reduce, all_gather, all_to_all and ring shift of
``parallel/collectives.py``, each the buffer it fills on the rank),
summed over the window's steps; None where the program keeps no such
counter."""

from portbench.spans import _profiling


def read(run):
    prof = _profiling(run)
    if prof is None or run.tally["ops"] <= 0:
        return None
    moved = [v for k, v in prof.counts().items()
             if k.startswith("collective_bytes.")]
    if not moved:
        return None
    return sum(moved) / 1e6 / run.tally["ops"]
