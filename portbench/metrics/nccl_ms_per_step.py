"""Device milliseconds a step of NCCL's kernels on the traced rank (by a
name holding "nccl": the broadcasts, all-gathers and all-reduces of the
distributed tier), whether or not a GEMM ran beside them."""

from portbench.readers import device_seconds

PATTERN = r"(?i)nccl"


def read(run):
    s = device_seconds(run, PATTERN)
    if s is None or run.tally["ops"] <= 0:
        return None
    return 1e3 * s / run.tally["ops"]
