"""SimT-stage training CLI (counterpart of ``tools/train_simt.py``; reference
tools/trainV2_simt.py + sh_simt.sh:17).

  python -m simt_tpu_torch.tools.train_simt --synthetic --num-steps-stop 3
  python -m simt_tpu_torch.tools.train_simt --synthetic --num-steps-stop 3 --device cpu \\
      --num-classes 5 --open-classes 3 --input-size-target 64,32 --compute-dtype float32

Builds the open-set DeepLabv2-ResNet-101 student and the closed-set teacher (seeded
random weights, or one warmup ``.pth`` given by ``--restore-from`` loaded into both by
key intersection, trainV2_simt.py:252-267), the SimT state, and runs
``--num-steps-stop`` steps on in-memory synthetic batches (``data.synthetic_batch``,
made before the first step), printing the reference's start-up lines and one metric
line per step. As in the JAX CLI's synthetic mode the class prior is uniform. The
dataset loader, evaluation in the loop, checkpoints and resume come with the data/loop
slice; until then ``--synthetic`` is required.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config as config_lib
from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..models import deeplab_multi, init_weights
from ..models.from_jax import load_matching, load_pth
from ..train import create_simt_state, make_simt_step
from ..utils import format_simt_line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SimT stage trainer (PyTorch + CUDA)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--preset", default=None,
                   help="named preset: simt_bapa_lr25, simt_bapa_lr6, simt_sfda")
    p.add_argument("--synthetic", action="store_true",
                   help="train on in-memory synthetic batches")
    p.add_argument("--num-steps-stop", type=int, default=None)
    p.add_argument("--iter-size", type=int, default=None,
                   help="sub-batches per optimizer step (ITER_SIZE, trainV2_simt.py:85)")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--open-classes", type=int, default=None)
    p.add_argument("--input-size-target", default=None,
                   help="'W,H' crop size (reference format, e.g. '1024,512')")
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--restore-from", default=None, help="warmup .pth state_dict")
    return p


def build_config(args) -> config_lib.TrainConfig:
    if args.preset in config_lib.WARMUP_PRESETS:
        raise ValueError(f"preset {args.preset!r} is a warmup preset")
    cfg = config_lib.preset(args.preset) if args.preset else config_lib.TrainConfig()
    optim, model, data = cfg.optim, cfg.model, cfg.data
    if args.iter_size is not None:
        optim = dataclasses.replace(optim, iter_size=args.iter_size)
    for flag in ("num_classes", "open_classes", "compute_dtype"):
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


def build_models(cfg):
    """Full-depth (student, teacher) with seeded reference init, or the
    ``restore_from`` .pth loaded into both by key intersection
    (trainV2_simt.py:252-267)."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    c, o = cfg.model.num_classes, cfg.model.open_classes
    student = deeplab_multi(c, o, openset=True, dtype=dtype)
    teacher = deeplab_multi(c, 0, openset=False, dtype=dtype)
    init_weights(student, torch.Generator().manual_seed(cfg.random_seed))
    init_weights(teacher, torch.Generator().manual_seed(cfg.random_seed + 1))
    if cfg.restore_from:
        sd = load_pth(cfg.restore_from)
        for name, net in (("student", student), ("teacher", teacher)):
            rep = load_matching(net, sd)
            print(f"{name}: loaded {len(rep['loaded'])} tensors from {cfg.restore_from} "
                  f"(missing {len(rep['missing'])}, skipped {len(rep['skipped'])})")
    return student, teacher


def synthetic_batches(cfg, n: int, device: torch.device) -> List[dict]:
    """``n`` optimizer steps' worth of synthetic batches on ``device`` (at most four
    distinct ones, reused in turn), made before training starts."""
    w, h = cfg.data.crop_size
    iter_size = cfg.optim.iter_size
    out = []
    for i in range(min(n, 4)):
        subs = [synthetic_batch(cfg.data.batch_size, (h, w), cfg.model.num_classes,
                                seed=cfg.random_seed + i * iter_size + j)
                for j in range(iter_size)]
        batch = subs[0] if iter_size == 1 else {
            k: np.stack([s[k] for s in subs]) for k in subs[0]}
        out.append({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    return out


def print_startup(cfg) -> None:
    """The reference's start-up lines (tools/train_simt.py:42-51 of the JAX CLI)."""
    print("Leanring_rate: ", cfg.optim.learning_rate)
    print("Leanring_rate_T: ", cfg.optim.learning_rate_t)
    print("Open-set class: ", cfg.model.open_classes)
    print("Threshold_high: ", cfg.simt.threshold_high)
    print("Threshold_low: ", cfg.simt.threshold_low)
    print("lambda_Place: ", cfg.simt.lambda_place)
    print("lambda_Convex: ", cfg.simt.lambda_convex)
    print("lambda_Volume: ", cfg.simt.lambda_volume)
    print("lambda_Anchor: ", cfg.simt.lambda_anchor)
    print("restore_from: ", cfg.restore_from)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        parser.error("the dataset loader comes with the data/loop slice; use --synthetic")
    cfg = build_config(args)
    with tempfile.TemporaryDirectory(prefix="simt_torch_train_") as tmp:
        cd_path = os.path.join(tmp, "class_dist.npy")
        c = cfg.model.num_classes
        np.save(cd_path, (np.ones(c) / c).astype(np.float32))
        cfg = cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=cd_path))
        print_startup(cfg)
        student, teacher = build_models(cfg)
        state = create_simt_state(student, teacher, cfg,
                                  torch.Generator().manual_seed(cfg.random_seed + 2),
                                  device)
    step = make_simt_step(cfg)
    n = cfg.num_steps_stop
    batches = synthetic_batches(cfg, n, device)
    print("Start: " + time.asctime(time.localtime(time.time())))
    t0 = time.perf_counter()
    metrics = {}
    for i in range(n):
        metrics = step(state, batches[i % len(batches)])
        print(format_simt_line(i, cfg.num_steps, metrics))  # reads the card each step
    seconds = time.perf_counter() - t0
    print(f"done: {n} steps in {seconds:.3f} s, {n / seconds:.3f} steps/s")
    return {"steps_per_sec": n / seconds, "metrics": metrics, "state": state}


if __name__ == "__main__":
    main()
