"""The TRSM kernel's share of its roofline, in %: the sum of
frozen.trsm_bound over the window's launches (their shapes recorded by
hooks.LaunchShapes) over the device time of the kernel's launches (the
diagonal-tile inversion included)."""

from portbench import frozen
from portbench.readers import device_seconds

PATTERN = r"\btrsm_\w*kernel"


def read(run):
    s = device_seconds(run, PATTERN)
    if s is None or not run.shapes or not run.shapes.trsm:
        return None
    bound_ms = sum(b * frozen.trsm_bound(n, k)[0]
                   for b, n, k in run.shapes.trsm)
    return 100.0 * bound_ms / (1e3 * s)
