"""Standalone evaluation CLI (counterpart of ``tools/test.py``; reference tools/test.py:
228-243): build the model of ``--model`` (DeepLabv2 multi-head by default; Res_Deeplab,
DeepLab-VGG or DeepLabv3) for ``--mode``'s stage, load a checkpoint, run the evaluation
protocol once.

  python -m simt_tpu_torch.tools.test --restore-from ckpt.pth \\
      --data-dir-target /data/Cityscapes --gt-dir /data/Cityscapes/label \\
      --val-list simt_tpu_torch/data/assets/cityscapes_list/val.txt
  python -m simt_tpu_torch.tools.test --synthetic               # on the card
  python -m simt_tpu_torch.tools.test --synthetic --device cpu  # on the CPU
  python -m simt_tpu_torch.tools.test --synthetic --model deeplabv3 --batch-size 4

Takes the trainers' flags (``tools/common.py``). ``--synthetic`` writes a small fixture
(two 128x64 val images) to a temporary directory and evaluates at scales 128x64 /
160x80 into 64x128; the model keeps its full width and depth and, without
``--restore-from``, seeded random weights. ``--save-dir`` writes the prediction PNGs.

Over N ranks (one process each: ``--coordinator host:port --num-processes N
--process-id i``) the images are split across the ranks and their histograms summed;
``--mesh-spatial S`` (with ``--mesh-data N/S``) splits each image's eval head by output
rows over S ranks, each running the whole forward (``evaluate(mesh=)``).
"""

from __future__ import annotations

import argparse
import datetime
import tempfile
import time
from typing import Optional, Sequence

from ..eval import evaluate
from ..train.checkpoint import load_warmstart
from ..train.loop import build_mesh, build_models
from . import common


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description="SimT evaluation (PyTorch + CUDA)")
    common.add_common_args(parser)
    parser.add_argument("--mode", choices=["simt", "warmup"], default="simt")
    parser.add_argument("--save-dir", type=str, default=None,
                        help="optionally dump prediction PNGs here")
    args = parser.parse_args(argv)
    device = common.apply_device(args)
    cfg = common.build_config(args, stage=args.mode)
    mesh = build_mesh(cfg, device) if cfg.mesh.data_axis * cfg.mesh.spatial_axis > 1 else None

    with tempfile.TemporaryDirectory(prefix="simt_torch_synth_") as tmp:
        paths = None
        if args.synthetic:
            cfg, paths = common.setup_synthetic(cfg, tmp)
        model, _ = build_models(cfg)
        if cfg.restore_from:
            report = load_warmstart(model, cfg.restore_from)
            print(f"loaded {len(report['loaded'])} tensors from {cfg.restore_from} "
                  f"(missing {len(report['missing'])}, skipped {len(report['skipped'])}, "
                  f"unused {len(report['unused'])})")
        val_list = paths["val_txt"] if paths else args.val_list
        gt_dir = paths["gt_dir"] if paths else args.gt_dir
        if not (val_list and gt_dir):
            parser.error("--val-list and --gt-dir are required (or use --synthetic)")
        print(datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
        miou = evaluate(model, data_root=paths["root"] if paths else cfg.data.root,
                        val_list=val_list, gt_dir=gt_dir, mode=args.mode,
                        process_workers=cfg.data.process_workers,
                        batch_size=cfg.data.batch_size, save_dir=args.save_dir,
                        device=device, mesh=mesh,
                        **(common.scaled_protocol(cfg) if paths else {}))
    print("Finish Evaluation: " + time.asctime(time.localtime(time.time())))
    return miou


if __name__ == "__main__":
    main()
