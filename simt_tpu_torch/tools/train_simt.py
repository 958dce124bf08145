"""SimT-stage training CLI (counterpart of ``tools/train_simt.py``; reference
tools/trainV2_simt.py + sh_simt.sh:17).

Real data, on the card:
  python -m simt_tpu_torch.tools.train_simt --preset simt_bapa_lr25 \\
      --data-dir-target /data/Cityscapes --gt-dir /data/Cityscapes/label \\
      --val-list simt_tpu_torch/data/assets/cityscapes_list/val.txt \\
      --restore-from warmup.pth --snapshot-dir snapshots [--resume]

On N ranks, one process each (global batch N x --batch-size; rank 0 at host:port):
  python -m simt_tpu_torch.tools.train_simt ... --coordinator host:port \
      --num-processes N --process-id i --mesh-data N
and with each image's rows split over S of them (D x S = N; global batch D x
--batch-size):
  python -m simt_tpu_torch.tools.train_simt ... --coordinator host:port \
      --num-processes N --process-id i --mesh-data D --mesh-spatial S

On a generated fixture (8 train and 2 val images in a temporary directory):
  python -m simt_tpu_torch.tools.train_simt --synthetic --num-steps-stop 3 --save-pred-every 2
  python -m simt_tpu_torch.tools.train_simt --synthetic --num-steps-stop 3 --device cpu \\
      --num-classes 5 --open-classes 3 --input-size-target 64,32 --compute-dtype float32

Runs ``train/loop.py::train`` on the SimT stage: batches from ``build_loader`` over the
list file's PNGs, the two-scale evaluation every ``--save-pred-every`` steps when a val
set is named (under ``--synthetic`` the fixture's, at the crop's scale and 5/4 of it),
the best-mIoU snapshot kept and the previous one deleted, a last snapshot at
``--num-steps-stop``. ``--synthetic`` runs with a uniform class prior and writes
snapshots only where ``--snapshot-dir`` is given.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config as config_lib
from ..data.synthetic import synthetic_batch
from ..train.loop import build_models, train  # noqa: F401  (bench_loss_fused reads it here)
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SimT stage trainer (PyTorch + CUDA)")
    common.add_common_args(p)
    return p


def build_config(args) -> config_lib.TrainConfig:
    if args.preset in config_lib.WARMUP_PRESETS:
        raise ValueError(f"preset {args.preset!r} is a warmup preset")
    return common.build_config(args, stage="simt")


def synthetic_batches(cfg, n: int, device: torch.device) -> List[dict]:
    """``n`` optimizer steps' worth of in-memory synthetic batches on ``device`` (at
    most four distinct ones, reused in turn), made before training starts; the
    resident batches of the benchmarks."""
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
            cfg = common.uniform_class_dist(cfg, tmp)
        print_startup(cfg)
        summary = train(cfg, eval_fn=common.build_eval_fn(cfg, args, paths, "simt", device),
                        csv_path=args.csv, resume=args.resume, profile_dir=args.profile_dir,
                        plot_ntm_every=args.plot_ntm_every, plot_ntm_dir=args.plot_ntm_dir,
                        device=device)
    print(f"done: {summary['steps_per_sec']:.3f} steps/s, best mIoU {summary['best_miou']}")
    return summary


if __name__ == "__main__":
    main()
