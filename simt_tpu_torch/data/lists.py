"""List-file parsing and dataset assets (counterpart of ``simt_tpu/data/lists.py``).

The port keeps its own copy of the two assets evaluation reads,
``assets/cityscapes_list/info.json`` and ``val.txt`` (the reference's
``dataset/cityscapes_list``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")


def read_name_list(list_path: str) -> List[str]:
    """Plain one-name-per-line list (cityscapes_dataset.py:31)."""
    with open(list_path) as f:
        return [line.strip() for line in f if line.strip()]


def load_info(path: Optional[str] = None) -> dict:
    """Cityscapes devkit info.json: class names, 34->19 label2train map, palette
    (used at tools/evaluate_cityscapes.py:111-115)."""
    path = path or os.path.join(ASSETS_DIR, "cityscapes_list", "info.json")
    with open(path) as f:
        return json.load(f)
