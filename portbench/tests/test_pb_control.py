"""On the card, at the cells' own sizes: the control (the program with
its GEMMs in TF32, the precision below the configurations' fp32 with
TF32 off) fails at least one of a cell's numbers, and a sound run on a
fresh seed passes them all. Marked ``cuda``; skips without a card.

    python -m pytest portbench/tests/test_pb_control.py -q
"""

from __future__ import annotations

import pytest

from portbench import calibrate, compare, harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell, cuda_device):
    import cugp_tpu_torch  # noqa: F401  (TF32 off, as in a run)

    limits = compare.load_limits(cell)
    sound = calibrate.reading(cell, 2**31 + 501, "program")["numbers"]
    ok, _ = compare.verdict(sound, limits)
    assert ok, sound
    control = calibrate.reading(cell, 2**31 + 502, "tf32")["numbers"]
    ok, _ = compare.verdict(control, limits)
    assert not ok, control
