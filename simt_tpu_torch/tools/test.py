"""Standalone evaluation CLI (counterpart of ``tools/test.py``; reference tools/test.py:
228-243): build the open-set DeepLabv2-ResNet-101, load a checkpoint, run the simt
evaluation protocol once.

  python -m simt_tpu_torch.tools.test --restore-from ckpt.pth \\
      --data-dir-target /data/Cityscapes --val-list val.txt --gt-dir /data/Cityscapes/label
  python -m simt_tpu_torch.tools.test --synthetic               # on the card
  python -m simt_tpu_torch.tools.test --synthetic --device cpu  # on the CPU

``--synthetic`` writes a small fixture (two 128x64 val images) to a temporary directory
and evaluates at scales 128x64 / 160x80 into 64x128; the model keeps its full width and
depth and, without ``--restore-from``, seeded random weights.
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from ..config import NUM_CLASSES, OPEN_CLASSES
from ..data.lists import ASSETS_DIR
from ..device import resolve_device
from ..eval import evaluate
from ..models import deeplab_multi, init_weights
from ..models.from_jax import load_matching, load_pth

SEED = 1234  # RANDOM_SEED of the reference trainers (trainV2_simt.py:55)


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description="SimT evaluation (PyTorch + CUDA)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--mode", choices=["simt", "warmup"], default="simt")
    parser.add_argument("--restore-from", default="", help="reference .pth state_dict")
    parser.add_argument("--data-dir-target", default="", help="Cityscapes root")
    parser.add_argument("--val-list", default=os.path.join(ASSETS_DIR, "cityscapes_list",
                                                           "val.txt"))
    parser.add_argument("--gt-dir", default=None,
                        help="directory of *_gtFine_labelIds.png val ground truth")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--save-dir", default=None, help="optionally dump prediction PNGs")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on a generated fixture in a temporary directory")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    model = deeplab_multi(NUM_CLASSES, OPEN_CLASSES, openset=args.mode == "simt")
    init_weights(model, torch.Generator().manual_seed(SEED))
    if args.restore_from:
        report = load_matching(model, load_pth(args.restore_from))
        print(f"loaded {len(report['loaded'])} tensors from {args.restore_from} "
              f"(missing {len(report['missing'])}, skipped {len(report['skipped'])}, "
              f"unused {len(report['unused'])})")

    with tempfile.TemporaryDirectory(prefix="simt_torch_synth_") as tmp:
        kw = {}
        if args.synthetic:
            from ..data.synthetic import make_cityscapes_fixture

            w, h = 128, 64
            paths = make_cityscapes_fixture(tmp, n_train=0, n_val=2, image_wh=(w, h))
            root, val_list, gt_dir = paths["root"], paths["val_txt"], paths["gt_dir"]
            kw = dict(scales=((w, h), (w * 5 // 4, h * 5 // 4)), out_hw=(h, w))
        else:
            root, val_list, gt_dir = args.data_dir_target, args.val_list, args.gt_dir
            if not (root and gt_dir):
                parser.error("--data-dir-target and --gt-dir are required "
                             "(or use --synthetic)")
        print(datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
        miou = evaluate(model, data_root=root, val_list=val_list, gt_dir=gt_dir,
                        mode=args.mode, batch_size=args.batch_size,
                        save_dir=args.save_dir, device=device, **kw)
    print("Finish Evaluation: " + time.asctime(time.localtime(time.time())))
    return miou


if __name__ == "__main__":
    main()
