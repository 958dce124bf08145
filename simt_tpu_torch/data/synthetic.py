"""Synthetic Cityscapes-layout fixture (counterpart of ``simt_tpu/data/synthetic.py``).

Writes the same files as the JAX package's ``make_cityscapes_fixture`` for the same
arguments and seed: the random draws are made in the same order from the same numpy
generator. The train-id -> label-id inversion is a lookup table instead of
``np.vectorize``, which keeps full-size (2048x1024) fixtures quick to write.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def make_cityscapes_fixture(
    root: str,
    *,
    n_train: int = 4,
    n_val: int = 2,
    image_wh: Tuple[int, int] = (64, 32),
    num_classes: int = 19,
    seed: int = 0,
) -> dict:
    """Create a miniature Cityscapes tree:

      <root>/train/<city>/*_leftImg8bit.png     training images
      <root>/pseudo/*_leftImg8bit.png           pseudo-label trainid PNGs
      <root>/val/<city>/*_leftImg8bit.png       val images
      <root>/label/<city>/*_gtFine_labelIds.png val gt in *labelId* (0..33) encoding
      <root>/lists/pseudo.lst, val.txt

    Returns a paths dict. Val gt uses raw label ids so the eval path exercises the
    info.json label2train remap exactly like evaluate_cityscapes.py:140-144.
    """
    from PIL import Image

    from .lists import load_info

    rng = np.random.default_rng(seed)
    w, h = image_wh
    info = load_info()
    # For each train id of info.json, the first label id that maps to it (a table over
    # every uint8 id, so that any num_classes works, as the JAX fixture's dict does).
    train2label = np.zeros(256, np.uint8)
    seen = set()
    for src, dst in info["label2train"]:
        if dst != 255 and dst not in seen:
            seen.add(dst)
            train2label[dst] = src

    paths = {
        "root": root,
        "pseudo_lst": os.path.join(root, "lists", "pseudo.lst"),
        "val_txt": os.path.join(root, "lists", "val.txt"),
        "gt_dir": os.path.join(root, "label"),
    }
    for sub in ["train/city", "pseudo", "val/city", "label/city", "lists"]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    rows = []
    for i in range(n_train):
        name = f"city_{i:06d}_000019_leftImg8bit.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lab = rng.integers(0, num_classes, size=(h, w)).astype(np.uint8)
        lab[rng.random((h, w)) < 0.1] = 255  # ignore pixels
        Image.fromarray(img).save(os.path.join(root, "train/city", name))
        Image.fromarray(lab, mode="L").save(os.path.join(root, "pseudo", name))
        rows.append(f"train/city/{name}\tpseudo/{name}")
    with open(paths["pseudo_lst"], "w") as f:
        f.write("\n".join(rows) + "\n")

    val_names = []
    for i in range(n_val):
        name = f"city_{i:06d}_000123_leftImg8bit.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        train_ids = rng.integers(0, num_classes, size=(h, w))
        label_ids = train2label[train_ids]
        Image.fromarray(img).save(os.path.join(root, "val/city", name))
        gt_name = name.split("leftImg8bit")[0] + "gtFine_labelIds.png"
        Image.fromarray(label_ids, mode="L").save(
            os.path.join(root, "label", "city", gt_name)
        )
        val_names.append(f"city/{name}")
    with open(paths["val_txt"], "w") as f:
        f.write("\n".join(val_names) + "\n")

    return paths


def synthetic_batch(
    batch_size: int = 1,
    hw: Tuple[int, int] = (512, 1024),
    num_classes: int = 19,
    seed: int = 0,
) -> dict:
    """In-memory training batch with the training loop's layout, no files: ``image``
    (B, H, W, 3) float32 mean-subtracted BGR, ``label`` (B, H, W) int32 with 10% of the
    pixels 255. The same numpy draws as the JAX package's ``synthetic_batch``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    image = rng.normal(0, 60, size=(batch_size, h, w, 3)).astype(np.float32)
    label = rng.integers(0, num_classes, size=(batch_size, h, w)).astype(np.int32)
    label[rng.random((batch_size, h, w)) < 0.1] = 255
    return {"image": image, "label": label}
