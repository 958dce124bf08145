"""Console lines in the reference run logs' format (counterpart of
``simt_tpu/utils/logging.py``), so a run diffs cleanly against the published logs."""

from __future__ import annotations

from typing import Mapping


def format_simt_line(i_iter: int, num_steps: int, m: Mapping) -> str:
    """The trainV2_simt.py:439-441 line; ``m`` maps metric names to numbers or 0-d
    tensors (reading a tensor waits for the card)."""
    return (
        "iter = {0:8d}/{1:8d}, loss_seg_p = {2:.3f} loss_seg_y = {3:.3f} "
        "Convex = {4:.3f} Volume = {5:.3f} Anchor = {6:.3f} Place_loss = {7:.3f}".format(
            i_iter, num_steps, float(m["loss_seg_p"]), float(m["loss_seg_y"]),
            float(m["convex"]), float(m["volume"]), float(m["anchor"]),
            float(m["place"]))
    )


def format_warmup_line(i_iter: int, num_steps: int, m: Mapping) -> str:
    """The trainV1_warmup.py:235-237 line; ``m`` as for ``format_simt_line``."""
    return "iter = {0:8d}/{1:8d}, loss_seg1 = {2:.3f} loss_seg2 = {3:.3f}".format(
        i_iter, num_steps, float(m["loss_seg1"]), float(m["loss_seg2"]))
