"""Offline mIoU between saved prediction PNGs and ground truth (counterpart of
``tools/compute_iou.py``; reference tools/compute_iou.py:25-72: the same list handling,
remap, progress lines and output format).

  python -m simt_tpu_torch.tools.compute_iou <gt_dir> <pred_dir> [--devkit-dir DIR]

The devkit directory holds ``info.json``, ``label.txt`` (gt names) and ``val.txt``
(prediction names); the default is the port's own copy of the reference's.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..data.lists import ASSETS_DIR, load_info
from ..ops.metrics import fast_hist_np, label_mapping, per_class_iu


def compute_miou(gt_dir: str, pred_dir: str, devkit_dir: str) -> np.ndarray:
    """Per-class IoU over the devkit's lists; prints the reference's lines."""
    from PIL import Image

    info = load_info(os.path.join(devkit_dir, "info.json"))
    num_classes = int(info["classes"])
    names = info["label"]
    mapping = np.asarray(info["label2train"], np.int64)
    hist = np.zeros((num_classes, num_classes))

    with open(os.path.join(devkit_dir, "label.txt")) as f:
        gt_imgs = [os.path.join(gt_dir, x.strip()) for x in f if x.strip()]
    with open(os.path.join(devkit_dir, "val.txt")) as f:
        pred_imgs = [os.path.join(pred_dir, x.strip().split("/")[-1]) for x in f if x.strip()]

    for ind in range(len(gt_imgs)):
        pred = np.array(Image.open(pred_imgs[ind]))
        label = label_mapping(np.array(Image.open(gt_imgs[ind])), mapping)
        if label.size != pred.size:
            print(f"Skipping: len(gt) = {label.size:d}, len(pred) = {pred.size:d}, "
                  f"{gt_imgs[ind]}, {pred_imgs[ind]}")
            continue
        hist += fast_hist_np(label.flatten(), pred.flatten(), num_classes)
        if ind > 0 and ind % 10 == 0:
            print("{:d} / {:d}: {:0.2f}".format(
                ind, len(gt_imgs), 100 * np.mean(per_class_iu(hist))))

    ious = per_class_iu(hist)
    for i in range(num_classes):
        print("===>" + names[i] + ":\t" + str(round(ious[i] * 100, 2)))
    print("===> mIoU: " + str(round(np.nanmean(ious) * 100, 2)))
    return ious


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description="offline mIoU of prediction PNGs")
    p.add_argument("gt_dir", help="directory of Cityscapes val gt label images")
    p.add_argument("pred_dir", help="directory of prediction PNGs")
    p.add_argument("--devkit-dir", default=os.path.join(ASSETS_DIR, "cityscapes_list"))
    args = p.parse_args(argv)
    return compute_miou(args.gt_dir, args.pred_dir, args.devkit_dir)


if __name__ == "__main__":
    main()
