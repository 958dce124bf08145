"""Confusion-matrix / IoU metrics (counterpart of ``simt_tpu/ops/metrics.py``).

Reference: ``tools/compute_iou.py:9-22``. ``fast_hist`` runs on the tensor's device
with ``torch.bincount``; the IoU reductions run on the host in float64, as in the JAX
package.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def fast_hist(label: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int32 confusion matrix; rows = gt, cols = pred.

    Only pixels with ``0 <= label < num_classes`` count (compute_iou.py:9-11).
    """
    label = label.reshape(-1).to(torch.int64)
    pred = pred.reshape(-1).to(torch.int64)
    valid = (label >= 0) & (label < num_classes)
    idx = num_classes * label[valid] + pred[valid]
    hist = torch.bincount(idx, minlength=num_classes * num_classes)
    return hist.reshape(num_classes, num_classes).to(torch.int32)


def fast_hist_np(label: np.ndarray, pred: np.ndarray, num_classes: int) -> np.ndarray:
    """Host-side twin of :func:`fast_hist` on numpy arrays (compute_iou.py:9-11), for
    the offline tools."""
    k = (label >= 0) & (label < num_classes)
    return np.bincount(
        num_classes * label[k].astype(int) + pred[k], minlength=num_classes**2
    ).reshape(num_classes, num_classes)


def per_class_iu(hist) -> np.ndarray:
    """Per-class IoU = diag / (row + col - diag) (compute_iou.py:14-15). NaN for absent."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def mean_iou(hist) -> float:
    """mIoU in percent, rounded to 2dp exactly like evaluate_cityscapes.py:162."""
    return float(round(np.nanmean(per_class_iu(hist)) * 100, 2))


@functools.lru_cache(maxsize=8)
def _mapping_lut(mapping: tuple, size: int = 256) -> np.ndarray:
    lut = np.arange(size, dtype=np.int64)
    for src, dst in mapping:
        lut[src] = dst
    return lut


def label_mapping(label: np.ndarray, mapping: Sequence[Sequence[int]]) -> np.ndarray:
    """Remap label ids through ``mapping`` pairs (compute_iou.py:18-22).

    The reference loops over pairs writing into a copy based on the *original* values,
    so a lookup table is exact. Used for the Cityscapes 34-id -> 19-trainid map from
    ``info.json['label2train']``.
    """
    lut = _mapping_lut(tuple(tuple(int(v) for v in m) for m in mapping))
    return lut[label.astype(np.int64)]
