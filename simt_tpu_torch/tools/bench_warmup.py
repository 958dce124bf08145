"""Warmup-stage train-step throughput (counterpart of the JAX package's
``tools/bench_warmup.py``; ``python -m simt_tpu_torch.tools.bench --warmup``).

    python -m simt_tpu_torch.tools.bench_warmup [--device cuda|cpu]

The closed-set DeepLabv2-ResNet-101 (seeded random weights, bf16 autocast) trained by
the warmup step on one resident synthetic 512x1024 batch: 3 warm-up steps, 20 timed.
Prints one JSON line; on stderr, the profiler's device ms per step and the card's busy
share. The reference shipped no warmup-stage log, so the SimT stage's 1.29 steps/s
stands in as the denominator: the warmup step does strictly less work (no teacher, no
NTM losses), so ``vs_baseline`` is an upper bound, and the line says so.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import torch

from ..config import ModelConfig, TrainConfig
from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..models import ResNetMulti, init_weights
from ..train import create_warmup_state, make_warmup_step
from . import bench
from .bench import (BASELINE_STEPS_PER_SEC, RESNET101, TRAIN_HW, device_report, dtypes,
                    line)
from .timing import timed_steps


def run(*, hw: Tuple[int, int] = TRAIN_HW, layers: Sequence[int] = RESNET101,
        warm: int = 3, steps: int = 20, device="cuda") -> dict:
    """Warmup steps/s on one resident synthetic batch of ``hw``."""
    dev = resolve_device(device)
    compute, dtype = dtypes(dev)
    cfg = TrainConfig(model=ModelConfig(num_classes=19, compute_dtype=compute))
    model = init_weights(ResNetMulti(19, 0, False, layers=layers, dtype=dtype),
                         torch.Generator().manual_seed(0))
    state = create_warmup_state(model, cfg, dev)
    step = make_warmup_step(cfg)
    raw = synthetic_batch(batch_size=1, hw=hw, num_classes=19, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    wall_ms = timed_steps(step, state, lambda: batch, warm, steps, dev, "loss_seg2")
    device_report(step, state, [batch], wall_ms, dev)
    return line(f"warmup_train_steps_per_sec_bs1_{hw[0]}x{hw[1]}", 1e3 / wall_ms,
                "steps/s", BASELINE_STEPS_PER_SEC, digits=2,
                baseline_is_simt_stage_proxy=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """``python -m simt_tpu_torch.tools.bench --warmup [--device ...]``."""
    return bench.main(["--warmup", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
