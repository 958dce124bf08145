"""The control: the reference in the program's place in the precision below the
configuration's (fp8 convolutions for the bf16 model, bf16 for the float32 loss) has
to fail one of each cell's numbers, and so has the half-batch fault of a train cell.
On the CPU at a tiny size; on the card (marked ``chip``) at the cell's own size."""

import pytest

from benchmark import compare, harness
from benchmark.tools import control

CELLS = [w["name"] for w in harness.spec()["workloads"]]


def _fails(reading: dict, limits: dict) -> bool:
    """Whether a reading fails one of the cell's limited numbers it holds."""
    held = {k: v for k, v in limits.items() if k in reading}
    assert held, (reading, limits)
    return not compare.judge(reading, held)[0]


def _check(name, seed, device, overrides=None):
    limits = harness.Run(name, 1, device).limits
    readings = control.control_readings(name, seed, device, overrides)
    controls = [r for r in readings if r["kind"].startswith("control")]
    merged = {k: v for r in controls for k, v in r.items()}
    assert _fails(merged, limits), merged  # the control fails one of the cell's numbers
    for r in readings:
        if r["kind"].startswith("fault"):
            assert _fails(r, limits), r


@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_are_not_correct(name, tiny):
    _check(name, 7, "cpu", tiny)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_the_control_and_the_faults_are_not_correct_on_the_card(name, seed, card):
    _check(name, seed, card)
