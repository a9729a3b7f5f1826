"""The fused covariance matvec's share of its roofline, in %: the sum of
frozen.matvec_bound over the window's launches (their shapes recorded
by hooks.LaunchShapes) over the device time of the kernel's launches
(its pre-pass included)."""

from portbench import frozen
from portbench.readers import device_seconds

PATTERN = r"\bcov_matvec_\w+"


def read(run):
    s = device_seconds(run, PATTERN)
    if s is None or not run.shapes or not run.shapes.cov_matvec:
        return None
    bound_ms = sum(b * frozen.matvec_bound(n, d, r)[0]
                   for b, n, d, r in run.shapes.cov_matvec)
    return 100.0 * bound_ms / (1e3 * s)
