"""The class-frequency prior from pseudo-label PNGs (counterpart of
``tools/compute_class_distribution.py``; reference tools/compute_ClassDistribution.py:
52-93): the per-class pixel histogram over the train pseudo-labels, normalised to sum
1, saved as the ``sig_NTM`` prior.

  python -m simt_tpu_torch.tools.compute_class_distribution --pred-dir /data/pseudo_bapa \\
      --list dataset_list.txt --out ClassDist_bapa.npy
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def class_histogram(pred: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-class pixel counts over valid (0..n-1) ids (compute_ClassDistribution.py:52-54)."""
    k = (pred >= 0) & (pred < num_classes)
    return np.bincount(pred[k].astype(int), minlength=num_classes)


def compute_class_distribution(pred_dir: str, names, num_classes: int = 19) -> np.ndarray:
    from PIL import Image

    counts = np.zeros(num_classes, np.float64)
    for name in names:
        pred = np.asarray(Image.open(os.path.join(pred_dir, os.path.basename(name))))
        counts += class_histogram(pred.flatten(), num_classes)
    # Normalisation with the reference's epsilon (compute_ClassDistribution.py:92).
    return counts / (counts.sum() + 10e-10)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description="class-frequency prior of pseudo labels")
    p.add_argument("--pred-dir", required=True, help="directory of trainid pseudo PNGs")
    p.add_argument("--list", required=True, help="name list (one image path per line)")
    p.add_argument("--out", required=True, help="output .npy path")
    p.add_argument("--num-classes", type=int, default=19)
    args = p.parse_args(argv)

    with open(args.list) as f:
        names = [line.strip() for line in f if line.strip()]
    dist = compute_class_distribution(args.pred_dir, names, args.num_classes)
    np.save(args.out, dist.astype(np.float32))
    print("saved", args.out, dist)
    return dist


if __name__ == "__main__":
    main()
