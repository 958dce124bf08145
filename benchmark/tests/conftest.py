"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the repo's
root. They run on the CPU at tiny sizes; tests marked ``chip`` need a CUDA card and
skip without one (decided in the ``card`` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The cells cut to a size the CPU runs in seconds: one block a stage, 64x128 crops,
# batch 2, eval at 64x128 and 80x160 into 128x256.
TINY = {"config": {"model": {"layers": [1, 1, 1, 1]}},
        "mix": {"hw": [64, 128], "batch": 2, "labels": {"stride": 8},
                "scales": [[64, 128], [80, 160]], "out_hw": [128, 256]}}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    import copy

    return copy.deepcopy(TINY)
