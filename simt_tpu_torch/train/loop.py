"""Training data feed (counterpart of ``simt_tpu/train/loop.py``).

``build_loader`` only, for now: the ``train()`` loop, with its evaluation, checkpoints
and resume, comes with the next slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import torch

from ..data import pipeline as pipeline_lib
from ..data.pipeline import Loader, SegDataset, device_prefetch
from ..device import resolve_device


def build_loader(cfg, root: Optional[str] = None, list_path: Optional[str] = None,
                 source: Optional[str] = None, batch_size: Optional[int] = None,
                 process_shard: Optional[Tuple[int, int]] = None,
                 device: Union[str, torch.device] = "cuda") -> Iterator[Dict]:
    """The shuffled, epoch-free training batches of ``cfg`` (a ``TrainConfig``) on
    ``device``: ``device_prefetch`` over a ``Loader`` of the ``source`` dataset
    (``cfg.data.source`` unless given), seeded with ``cfg.random_seed``.

    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU runs only when
    asked for. Sets the pipeline's ``USE_NATIVE`` from ``cfg.data.use_native_preproc``.
    The JAX function's ``sharding=`` waits for the parallel slice.
    """
    factory = {
        "cityscapes_pseudo": SegDataset.cityscapes_pseudo,  # the trained configuration
        # The source domain (gta5_dataset.py): the reference imports it in both
        # trainers but never instantiates it.
        "gta5": SegDataset.gta5,
    }[source or cfg.data.source]
    dev = resolve_device(device)
    pipeline_lib.USE_NATIVE = cfg.data.use_native_preproc
    ds = factory(root or cfg.data.root, list_path or cfg.data.list_path,
                 crop_wh=cfg.data.crop_size, mean_bgr=cfg.data.mean_bgr,
                 mirror=cfg.data.mirror, cache_dir=cfg.data.crop_cache_dir)
    loader = Loader(ds, batch_size or cfg.data.batch_size, shuffle=True,
                    seed=cfg.random_seed, num_workers=cfg.data.num_workers,
                    prefetch=cfg.data.prefetch, process_workers=cfg.data.process_workers,
                    process_shard=process_shard)
    return device_prefetch(iter(loader), size=cfg.data.prefetch, device=dev)
