"""Shared blocking policy for the dense linear-algebra tier.

The same geometry as ``cugp_tpu/ops/blocking.py``: cholesky.py's recursion
calls trsm.py's recursion on matching sub-blocks, and both packages split
at the same points, so the recursions add the same partial sums in the
same order.
"""

from __future__ import annotations

# Size at or below which recursions stop and call the base-case kernel
# (the potrf and TRSM kernels take any n up to this).
BASE = 1024
# Recursion split sizes are rounded to multiples of this.
ALIGN = 256


def split_point(n):
    """Largest multiple of ALIGN close to n/2 (python int)."""
    half = n // 2
    m = (half // ALIGN) * ALIGN
    return max(m, ALIGN)
