"""The 34x19 noise-rate confusion matrix between ground truth and pseudo labels
(counterpart of ``tools/compute_confusion_matrix.py``).

Rebuilds the intent of the reference's tools/compute_ConfusionMatrix.py, which is
broken as shipped (it imports modules that do not exist, :13-16, and reads an
info.json key 'label2train_1' that does not exist, :77): rows are the raw 34 Cityscapes
label ids (no remap, hence 34x19), columns the 19 pseudo train ids. The normalised rows
are the empirical noise-transition estimate the NTM learns.

  python -m simt_tpu_torch.tools.compute_confusion_matrix --gt-dir /data/label \\
      --pred-dir /data/pseudo --gt-list label.txt --pred-list train.txt --out cm.npy \\
      [--plot cm.png]

``--plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def hist_34x19(label: np.ndarray, pred: np.ndarray, n_gt: int = 34,
               n_pred: int = 19) -> np.ndarray:
    """Rectangular confusion (compute_ConfusionMatrix.py:54-56)."""
    k = (label >= 0) & (label < n_gt) & (pred >= 0) & (pred < n_pred)
    return np.bincount(
        n_pred * label[k].astype(int) + pred[k], minlength=n_gt * n_pred
    ).reshape(n_gt, n_pred)


def compute_confusion(gt_dir: str, pred_dir: str, gt_names, pred_names, n_gt: int = 34,
                      n_pred: int = 19) -> np.ndarray:
    from PIL import Image

    cm = np.zeros((n_gt, n_pred), np.float64)
    for gt_name, pred_name in zip(gt_names, pred_names):
        gt = np.asarray(Image.open(os.path.join(gt_dir, gt_name)))
        pred = np.asarray(Image.open(os.path.join(pred_dir, os.path.basename(pred_name))))
        if gt.size != pred.size:
            print(f"Skipping: gt {gt.shape} vs pred {pred.shape} ({gt_name})")
            continue
        cm += hist_34x19(gt.flatten(), pred.flatten(), n_gt, n_pred)
    return cm


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description="34x19 gt vs pseudo-label confusion")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--pred-dir", required=True)
    p.add_argument("--gt-list", required=True)
    p.add_argument("--pred-list", required=True)
    p.add_argument("--out", required=True, help="output .npy path (34x19 counts)")
    p.add_argument("--plot", default=None, help="optional heat-map PNG (row-normalised)")
    args = p.parse_args(argv)

    with open(args.gt_list) as f:
        gt_names = [line.strip() for line in f if line.strip()]
    with open(args.pred_list) as f:
        pred_names = [line.strip() for line in f if line.strip()]
    cm = compute_confusion(args.gt_dir, args.pred_dir, gt_names, pred_names)
    np.save(args.out, cm)
    print("saved", args.out, "total pixels", int(cm.sum()))
    if args.plot:
        from ..utils import plot_ntm

        rows = cm / np.maximum(cm.sum(1, keepdims=True), 1)
        plot_ntm(rows, args.plot, title="GT(34) vs pseudo(19) noise rates")
        print("plotted", args.plot)
    return cm


if __name__ == "__main__":
    main()
