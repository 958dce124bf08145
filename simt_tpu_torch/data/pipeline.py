"""Host input pipeline for evaluation (counterpart of ``simt_tpu/data/pipeline.py``).

Eval subset only: decode -> PIL bicubic resize -> BGR as **uint8** on the host
(``load_image_bgr_u8``), the float cast and mean subtraction on the device
(``normalize_image``), batched in order by a thread-pool ``Loader`` with no shuffle and
no repeat. PIL's resize returns uint8 before the reference converts to float
(cityscapes_dataset.py:100,105,117-118), so host and device together compute the
reference's values.

Layout: images are NHWC uint8, as in the JAX package.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from . import lists


def load_image_bgr_u8(path: str, crop_wh: Tuple[int, int]) -> np.ndarray:
    """Decode + bicubic resize to (w, h) + BGR, HWC uint8 (cityscapes_dataset.py:100,105)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(crop_wh, Image.BICUBIC)
    return np.ascontiguousarray(np.asarray(img, np.uint8)[:, :, ::-1])


def normalize_image(image: torch.Tensor, mean_bgr: Sequence[float]) -> torch.Tensor:
    """Device half of the pipeline: uint8 BGR -> float32 mean-subtracted
    (cityscapes_dataset.py:117-118). float32 inputs pass through unchanged."""
    if image.dtype == torch.uint8:
        mean = torch.tensor(mean_bgr, dtype=torch.float32, device=image.device)
        return image.to(torch.float32) - mean
    return image


@dataclass
class Sample:
    image_path: str
    name: str


class SegDataset:
    """Image-only Cityscapes val list (cityscapesDataSet, cityscapes_dataset.py:21-63)."""

    def __init__(self, samples: List[Sample], crop_wh: Tuple[int, int]):
        self.samples = samples
        self.crop_wh = crop_wh

    @classmethod
    def cityscapes_eval(cls, root: str, list_path: str, crop_wh, split: str = "val"):
        samples = [
            Sample(image_path=os.path.join(root, split, name), name=name)
            for name in lists.read_name_list(list_path)
        ]
        return cls(samples, crop_wh)

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, index: int) -> Dict:
        s = self.samples[index]
        return {"image": load_image_bgr_u8(s.image_path, self.crop_wh), "name": s.name}


class Loader:
    """In-order batch iterator with a thread pool decoding two batches ahead.

    One pass over the dataset, no shuffle; the last batch may be short. Pillow releases
    the interpreter lock for much of its decode and resize, so threads overlap them.
    """

    prefetch = 2  # batches decoding ahead of the consumer

    def __init__(self, dataset: SegDataset, batch_size: int, *, num_workers: int = 4):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        starts = iter(range(0, n, self.batch_size))
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:

            def submit() -> None:
                start = next(starts, None)
                if start is not None:
                    idx = range(start, min(start + self.batch_size, n))
                    pending.append([pool.submit(self.dataset.get, i) for i in idx])

            try:
                for _ in range(self.prefetch):
                    submit()
                while pending:
                    futures = pending.popleft()
                    submit()
                    items = [f.result() for f in futures]
                    yield {
                        "image": np.stack([it["image"] for it in items]),
                        "name": [it["name"] for it in items],
                    }
            finally:
                for futures in pending:
                    for f in futures:
                        f.cancel()
