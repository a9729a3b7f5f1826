"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests -q``). Whether a card is present is decided inside the
``cuda_device`` fixture, never while a module is imported."""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes at which a whole run fits a CPU test
TINY = {"kin40k.fit": {"n_train": 300},
        "3droad.fit": {"n_train": 400},
        "kin40k.predict": {"n_train": 300}}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
