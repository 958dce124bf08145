"""Teacher-posterior cache (counterpart of ``simt_tpu/train/teacher_cache.py``): skip the
frozen teacher's forward on images it has seen.

The reference recomputes the frozen teacher every iteration (trainV2_simt.py:351-353)
though its weights never change: over a 40k-step run each of the 2,975 training images
is inferred ~13 times. The teacher runs in eval mode, so its stride-8 softmax is a pure
function of (image, mirror flag). The cache keeps it on the host, rounded to float16 on
the first visit (~0.64 MB an entry at 512x1024 crops in float32, half that stored), and
hands it to the step as ``teacher_prob8``; the SimT step then skips the teacher.

Rounding to float16 (at most 5e-4 on a probability) can flip a threshold decision on a
near tie, so the cache is off by default (``SimTConfig.cache_teacher``). An image's
first visit sees the rounded values too, so every epoch sees the same posterior.

On a spatial axis (``mesh``) every rank of a spatial group sees its data block whole;
the teacher runs H-sharded on the rank's rows and the cache stores the gathered
posterior, which the loop then cuts into rows with the rest of the batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import torch
from torch import nn

from ..config import IMG_MEAN_BGR
from ..data.pipeline import normalize_image
from ..parallel.mesh import Mesh, row_block, spatial_rows

CAPACITY_ENTRIES = 8192  # entries kept; a miss past them is computed, not stored


class TeacherCache:
    """Posteriors of ``teacher`` (a model already on its device, in eval mode) keyed on
    ``(name, mirror)``, at most ``CAPACITY_ENTRIES`` of them, stored as
    ``store_dtype`` on the host. ``hits`` and ``misses`` count images. ``mesh``: this
    rank's mesh, whose spatial axis (if above 1) H-shards the teacher."""

    def __init__(self, teacher: nn.Module, *, store_dtype: torch.dtype = torch.float16,
                 mean_bgr: Optional[Sequence[float]] = None, mesh: Optional[Mesh] = None):
        self.teacher = teacher
        self.mesh = mesh
        self.mean_bgr = IMG_MEAN_BGR if mean_bgr is None else tuple(mean_bgr)
        self.store_dtype = store_dtype
        self._cache: Dict[tuple, torch.Tensor] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._cache)

    @torch.no_grad()
    def forward(self, image) -> torch.Tensor:
        """The teacher's stride-8 softmax of head 2, (B, h8, w8, C) float32 on the
        teacher's device, from a (B, H, W, 3) image batch, as the SimT step computes it."""
        dev = next(self.teacher.parameters()).device
        x = normalize_image(torch.as_tensor(image, device=dev), self.mean_bgr)
        height = x.shape[1]
        if self.mesh is not None and self.mesh.spatial > 1:
            lo, hi = row_block(height, self.mesh.spatial_index, self.mesh.spatial)
            x = x[:, lo:hi]
        with spatial_rows(self.mesh, height):
            _, teach2 = self.teacher(x.permute(0, 3, 1, 2))
        return torch.softmax(teach2.float(), dim=1).permute(0, 2, 3, 1)

    def attach(self, batch: Dict) -> Dict:
        """``batch`` with ``teacher_prob8`` on its image's device, the misses computed
        and cached. Without ``name`` in the batch the posterior is computed and not
        cached. ``name`` and ``mirror`` are dropped from the result."""
        names = batch.get("name")
        arrays = {k: v for k, v in batch.items() if k not in ("name", "mirror")}
        if names is None:
            return {**arrays, "teacher_prob8": self.forward(batch["image"])}
        mirrors = batch.get("mirror", [False] * len(names))
        keys = [(n, bool(m)) for n, m in zip(names, mirrors)]
        missing = [i for i, k in enumerate(keys) if k not in self._cache]
        if missing:
            # Rounded through the storage dtype at once, so that the first visit sees
            # what every later one will.
            stored = self.forward(batch["image"]).to(self.store_dtype).cpu()
            for i in missing:
                self.misses += 1
                if len(self._cache) < CAPACITY_ENTRIES:
                    self._cache[keys[i]] = stored[i].clone()
            rows = [stored[i] if i in missing else self._cache[k]
                    for i, k in enumerate(keys)]
            self.hits += len(keys) - len(missing)
        else:
            rows = [self._cache[k] for k in keys]
            self.hits += len(keys)
        out = torch.stack(rows).float()
        image = batch["image"]
        dev = image.device if isinstance(image, torch.Tensor) else torch.device("cpu")
        if dev.type == "cuda":  # from pinned memory, ahead of the step's work
            out = out.pin_memory().to(dev, non_blocking=True)
        return {**arrays, "teacher_prob8": out}

    def wrap(self, batch_iter: Iterator[Dict]) -> Iterator[Dict]:
        for batch in batch_iter:
            yield self.attach(batch)
