"""List-file parsing and dataset assets (counterpart of ``simt_tpu/data/lists.py``).

The port keeps its own copy of the reference's list files under ``assets/``
(``dataset/cityscapes_list``: ``info.json``, ``val.txt``, ``train.txt``, ``label.txt``
and the six ``pseudo_*.lst`` pseudo-label lists; ``dataset/gta5_list/train.txt``),
parsed as the Dataset constructors parse them (dataset/cityscapes_dataset.py:31,76;
dataset/gta5_dataset.py:23).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")

# GTA5 label id -> Cityscapes train id (dataset/gta5_dataset.py:28-30).
GTA5_ID_TO_TRAINID: Dict[int, int] = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10,
    24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def read_name_list(list_path: str) -> List[str]:
    """Plain one-name-per-line list (cityscapes_dataset.py:31)."""
    with open(list_path) as f:
        return [line.strip() for line in f if line.strip()]


def read_pair_list(list_path: str) -> List[Tuple[str, str]]:
    """Tab/space separated ``image_path label_path`` rows (cityscapes_dataset.py:76);
    raises ValueError on a row that does not have two columns."""
    pairs = []
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"{list_path}: expected 2 columns, got {parts!r}")
            pairs.append((parts[0], parts[1]))
    return pairs


def load_info(path: Optional[str] = None) -> dict:
    """Cityscapes devkit info.json: class names, 34->19 label2train map, palette
    (used at tools/evaluate_cityscapes.py:111-115)."""
    path = path or os.path.join(ASSETS_DIR, "cityscapes_list", "info.json")
    with open(path) as f:
        return json.load(f)
