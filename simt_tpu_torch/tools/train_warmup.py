"""Warmup-stage training CLI (counterpart of ``tools/train_warmup.py``; reference
tools/trainV1_warmup.py + sh_warmup.sh:17).

  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --device cpu \\
      --num-classes 5 --input-size-target 64,32 --compute-dtype float32

Builds the closed-set DeepLabv2-ResNet-101 (seeded random weights, or a ``.pth`` given
by ``--restore-from`` loaded by key intersection), the warmup state, and runs
``--num-steps-stop`` steps on in-memory synthetic batches (made before the first step),
printing one metric line per step in the reference's format. The preset defaults to
``warmup_bapa`` (NUM_STEPS_STOP 150 000, trainV1_warmup.py:52). The dataset loader,
evaluation in the loop, checkpoints and resume come with the data/loop slice; until
then ``--synthetic`` is required. The adversarial warmup (``--adversarial`` of the JAX
CLI) comes with the auxiliary models.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from .. import config as config_lib
from ..device import resolve_device
from ..models import deeplab_multi, init_weights
from ..models.from_jax import load_matching, load_pth
from ..train import create_warmup_state, make_warmup_step
from ..utils import format_warmup_line
from .train_simt import synthetic_batches


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Warmup stage trainer (PyTorch + CUDA)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--preset", default="warmup_bapa", help="named preset: warmup_bapa")
    p.add_argument("--synthetic", action="store_true",
                   help="train on in-memory synthetic batches")
    p.add_argument("--num-steps-stop", type=int, default=None)
    p.add_argument("--iter-size", type=int, default=None,
                   help="sub-batches per optimizer step (ITER_SIZE, trainV1_warmup.py)")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--input-size-target", default=None,
                   help="'W,H' crop size (reference format, e.g. '1024,512')")
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--restore-from", default=None, help="initial .pth state_dict")
    return p


def build_config(args) -> config_lib.TrainConfig:
    if args.preset not in config_lib.WARMUP_PRESETS:
        raise ValueError(f"preset {args.preset!r} is not a warmup preset")
    cfg = config_lib.preset(args.preset)
    optim, model, data = cfg.optim, cfg.model, cfg.data
    if args.iter_size is not None:
        optim = dataclasses.replace(optim, iter_size=args.iter_size)
    for flag in ("num_classes", "compute_dtype"):
        if getattr(args, flag) is not None:
            model = dataclasses.replace(model, **{flag: getattr(args, flag)})
    if args.input_size_target is not None:
        w, h = map(int, args.input_size_target.split(","))
        data = dataclasses.replace(data, crop_size=(w, h))
    kw = {}
    for flag in ("num_steps_stop", "restore_from"):
        if getattr(args, flag) is not None:
            kw[flag] = getattr(args, flag)
    return cfg.replace(model=model, data=data, optim=optim, **kw)


def build_model(cfg):
    """Full-depth closed-set DeepLabv2-ResNet-101 (trainV1_warmup.py) with the seeded
    reference init, or the ``restore_from`` .pth loaded by key intersection."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    model = deeplab_multi(cfg.model.num_classes, 0, openset=False, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(cfg.random_seed))
    if cfg.restore_from:
        rep = load_matching(model, load_pth(cfg.restore_from))
        print(f"model: loaded {len(rep['loaded'])} tensors from {cfg.restore_from} "
              f"(missing {len(rep['missing'])}, skipped {len(rep['skipped'])})")
    return model


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        parser.error("the dataset loader comes with the data/loop slice; use --synthetic")
    cfg = build_config(args)
    print("Leanring_rate: ", cfg.optim.learning_rate)
    print("restore_from: ", cfg.restore_from)
    state = create_warmup_state(build_model(cfg), cfg, device)
    step = make_warmup_step(cfg)
    n = cfg.num_steps_stop
    batches = synthetic_batches(cfg, n, device)
    print("Start: " + time.asctime(time.localtime(time.time())))
    t0 = time.perf_counter()
    metrics = {}
    for i in range(n):
        metrics = step(state, batches[i % len(batches)])
        print(format_warmup_line(i, cfg.num_steps, metrics))  # reads the card each step
    seconds = time.perf_counter() - t0
    print(f"done: {n} steps in {seconds:.3f} s, {n / seconds:.3f} steps/s")
    return {"steps_per_sec": n / seconds, "metrics": metrics, "state": state}


if __name__ == "__main__":
    main()
