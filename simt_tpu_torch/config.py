"""Constants of the evaluation protocol (counterpart of ``simt_tpu/config.py``).

Only what the eval slice reads is here; the training dataclasses come with the
training slice.
"""

from __future__ import annotations

import os
from typing import Tuple

# BGR mean, matching IMG_MEAN in the reference trainers (trainV2_simt.py:34).
IMG_MEAN_BGR: Tuple[float, float, float] = (104.00698793, 116.66876762, 122.67891434)

NUM_CLASSES = 19  # known classes (trainV2_simt.py:50)
OPEN_CLASSES = 15  # open-set placeholder classes (sh_simt.sh:17)

# Two input scales as (w, h) and the label resolution as (h, w)
# (evaluate_cityscapes.py:103-108).
EVAL_SCALES: Tuple[Tuple[int, int], ...] = ((1024, 512), (1280, 640))
EVAL_OUT_HW: Tuple[int, int] = (1024, 2048)

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "data", "assets")
