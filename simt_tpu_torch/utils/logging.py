"""Console lines in the reference run logs' format, a CSV metric sink and a step timer
(counterpart of ``simt_tpu/utils/logging.py``), so a run diffs cleanly against the
published logs."""

from __future__ import annotations

import csv
import os
import time
from typing import Mapping, Optional


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


class MetricWriter:
    """CSV metric sink: a ``step`` and a ``time`` column, then one column a metric in
    the order of the first row's mapping (the JAX package's columns). ``csv_path=None``
    writes nothing. ``write`` reads each value as a float, so a 0-d tensor on the card
    waits for it: call it on log steps only."""

    def __init__(self, csv_path: Optional[str] = None):
        self.csv_path = csv_path
        self._writer = None
        self._file = None

    def write(self, step: int, metrics: Mapping) -> None:
        if self.csv_path is None:
            return
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
            self._file = open(self.csv_path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=list(row))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = self._writer = None


class StepTimer:
    """Steps a second over a window on the host's clock. The steps return before the
    card has run them, so synchronize the card before reading ``rate()``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self, n: int = 1) -> None:
        self.count += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self.count = 0
