"""Warmup-stage training CLI (counterpart of ``tools/train_warmup.py``; reference
tools/trainV1_warmup.py + sh_warmup.sh:17).

  python -m simt_tpu_torch.tools.train_warmup --data-dir-target /data/Cityscapes \\
      --gt-dir /data/Cityscapes/label \\
      --val-list simt_tpu_torch/data/assets/cityscapes_list/val.txt --snapshot-dir snaps
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --save-pred-every 2
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --device cpu \\
      --num-classes 5 --input-size-target 64,32 --compute-dtype float32

Runs ``train/loop.py::train`` on the warmup stage (the closed-set DeepLabv2-ResNet-101,
``--restore-from`` loaded after the reference's ``k[6:]``): the same loop, evaluation
and snapshots as ``train_simt``, with the single-scale warmup evaluation. The preset
defaults to ``warmup_bapa`` (NUM_STEPS_STOP 150 000, trainV1_warmup.py:52). The JAX
CLI's ``--adversarial`` comes with ROADMAP A-5.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from .. import config as config_lib
from ..train.loop import train
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Warmup stage trainer (PyTorch + CUDA)")
    common.add_common_args(p)
    p.set_defaults(preset="warmup_bapa")
    p.add_argument("--adversarial", action="store_true",
                   help="the FCDiscriminator output-space loss (comes with ROADMAP A-5)")
    return p


def build_config(args) -> config_lib.TrainConfig:
    if args.preset not in config_lib.WARMUP_PRESETS:
        raise ValueError(f"preset {args.preset!r} is not a warmup preset")
    if getattr(args, "adversarial", False):
        raise ValueError("--adversarial comes with ROADMAP A-5; the port does not have it "
                         "yet")
    return common.build_config(args, stage="warmup")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``train()``'s summary."""
    args = build_parser().parse_args(argv)
    device = common.apply_device(args)
    cfg = build_config(args)
    with tempfile.TemporaryDirectory(prefix="simt_torch_synth_") as tmp:
        paths = None
        if args.synthetic:
            cfg, paths = common.setup_synthetic(
                cfg, tmp, cfg.data.crop_size if args.input_size_target else (128, 64),
                snapshot_dir=args.snapshot_dir or "")
        print("Leanring_rate: ", cfg.optim.learning_rate)
        print("restore_from: ", cfg.restore_from)
        summary = train(cfg, eval_fn=common.build_eval_fn(cfg, args, paths, "warmup",
                                                          device),
                        csv_path=args.csv, resume=args.resume, profile_dir=args.profile_dir,
                        device=device)
    print(f"done: {summary['steps_per_sec']:.3f} steps/s, best mIoU {summary['best_miou']}")
    return summary


if __name__ == "__main__":
    main()
