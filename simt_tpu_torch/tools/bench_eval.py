"""Two-scale evaluation throughput (counterpart of the JAX package's
``tools/bench_eval.py``; ``python -m simt_tpu_torch.tools.bench --eval``).

    python -m simt_tpu_torch.tools.bench_eval [--device cuda|cpu]

The whole per-image eval path on one resident input: the open-set DeepLabv2-ResNet-101
(seeded random weights, bf16 autocast, ``channels_last``) forward at 512x1024 and
640x1280, then the fused upsample + argmax + histogram kernel (B1) into the running
(19, 19) histogram at 1024x2048, with uint8 gt as ``evaluate`` hands it. One warm-up
image, then 20 timed, ended by reading the histogram on the host. Prints one JSON line;
on stderr, the profiler's device ms per image and the card's busy share. Baseline: the
reference's 500 val images x 2 scales in ~550-750 s on its GPU, 1.3-1.8 img/s, of which
1.55 is the midpoint.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..eval.evaluate import make_eval_fn
from ..models import ResNetMulti, init_weights
from . import bench
from .bench import RESNET101, device_report, dtypes, line
from .timing import sync

BASELINE_IMG_PER_SEC = 1.55


def run(*, hw: Tuple[int, int] = (512, 1024), layers: Sequence[int] = RESNET101,
        warm: int = 1, steps: int = 20, device="cuda") -> dict:
    """Eval img/s at input ``hw`` and 1.25x it, into a histogram at 2x it."""
    dev = resolve_device(device)
    _, dtype = dtypes(dev)
    model = init_weights(ResNetMulti(19, 15, True, layers=layers, dtype=dtype),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    h, w = hw
    out_hw = (2 * h, 2 * w)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32)).to(dev)
    x640 = torch.from_numpy(rng.randn(1, h * 5 // 4, w * 5 // 4, 3).astype(np.float32)
                            ).to(dev)
    gt = torch.from_numpy(rng.randint(0, 19, (1, *out_hw)).astype(np.uint8)).to(dev)
    _, predict_hist, _ = make_eval_fn(model, 19, "simt", out_hw)
    hist = torch.zeros((19, 19), dtype=torch.int32, device=dev)

    def image(_state, _batch):
        return predict_hist(x, x640, gt, out=hist)

    for _ in range(warm):
        image(None, None)
    hist.cpu()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        image(None, None)
    total = int(hist.cpu().sum())  # the host read waits for every image
    sync(dev)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    if total != (warm + steps) * out_hw[0] * out_hw[1]:
        raise RuntimeError(f"eval histogram counts {total} pixels, want "
                           f"{(warm + steps) * out_hw[0] * out_hw[1]}")
    device_report(image, None, [None], wall_ms, dev, what="image")
    return line(f"eval_images_per_sec_two_scale_{out_hw[0]}x{out_hw[1]}", 1e3 / wall_ms,
                "img/s", BASELINE_IMG_PER_SEC, digits=2)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """``python -m simt_tpu_torch.tools.bench --eval [--device ...]``."""
    return bench.main(["--eval", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
