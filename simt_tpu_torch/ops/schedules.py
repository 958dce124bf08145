"""Learning-rate schedules (counterpart of ``simt_tpu/ops/schedules.py``)."""

from __future__ import annotations


def poly_lr(base_lr: float, step: int, max_steps: int, power: float = 0.9) -> float:
    """``base_lr * (1 - step/max_steps)**power`` (reference ``lr_poly``,
    trainV2_simt.py:174-175). ``step`` is the outer iteration, a host integer, so the
    result is a Python float and setting it never waits for the card. The 1x/10x group
    split (trainV2_simt.py:177-181) is applied by the optimizer groups in
    ``train/state.py``."""
    return base_lr * (1.0 - float(step) / float(max_steps)) ** power
