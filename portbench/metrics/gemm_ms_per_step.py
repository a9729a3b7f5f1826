"""Device milliseconds a fit step of the GEMM kernels (cuBLAS's, by a
name holding "gemm"; the traced run prints every kernel's name)."""

from portbench.readers import device_seconds

PATTERN = r"(?i)gemm"


def read(run):
    s = device_seconds(run, PATTERN)
    if s is None or run.tally["ops"] <= 0:
        return None
    return 1e3 * s / run.tally["ops"]
