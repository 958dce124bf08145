"""Export a port snapshot or checkpoint to the reference's state_dict layout
(counterpart of ``tools/export_torch.py``).

Reads either a full-state snapshot directory of ``train()`` (``--snapshot-dir``, its
newest snapshot) or a ``.pth`` / ``.npz`` model file (``--restore-from``, loaded by key
intersection into the seeded model), and writes the student's weights as a
torch-loadable ``.pth`` (or ``.npz`` when the output path ends in .npz) whose keys are
the reference's ``state_dict`` names (model/deeplab_multi.py). The keys and values are
what the JAX tool writes for the same weights: the BatchNorm step counters
(``num_batches_tracked``), which the JAX model has not, are left out.

  python -m simt_tpu_torch.tools.export_torch --stage simt --snapshot-dir snapshots/ \\
      --out model.pth
  python -m simt_tpu_torch.tools.export_torch --stage warmup --restore-from warmup.pth \\
      --out back.npz --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..train import checkpoint as ckpt_lib
from ..train.loop import build_models
from ..train.simt import create_simt_state
from ..train.warmup import create_warmup_state
from . import common


def export_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's weights and BatchNorm statistics by reference key, as numpy arrays
    on the host (``simt_tpu/models/import_torch.py::export_state_dict``'s output for
    the same weights)."""
    return {k: v.detach().cpu().contiguous().numpy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    parser = argparse.ArgumentParser(description="export to the reference's state_dict")
    common.add_common_args(parser)
    parser.add_argument("--stage", choices=["warmup", "simt"], default="simt")
    parser.add_argument("--out", type=str, required=True,
                        help="output path (.pth for torch, .npz for numpy)")
    args = parser.parse_args(argv)
    device = common.apply_device(args)
    cfg = common.build_config(args, stage=args.stage)

    student, teacher = build_models(cfg)
    if cfg.restore_from:
        ckpt_lib.load_warmstart(student, cfg.restore_from)
    if cfg.snapshot_dir and ckpt_lib.latest_step(cfg.snapshot_dir) is not None:
        # A full-state snapshot: build the state it was written from, restore, take
        # the student.
        if cfg.stage == "simt":
            state = create_simt_state(student, teacher, cfg,
                                      torch.Generator().manual_seed(cfg.random_seed + 2),
                                      device)
        else:
            state = create_warmup_state(student, cfg, device)
        ckpt_lib.restore(state, cfg.snapshot_dir)
        print(f"exporting snapshot step {state.step} from {cfg.snapshot_dir}")
    elif not cfg.restore_from:
        parser.error("need --snapshot-dir with snapshots or --restore-from")

    sd = export_state_dict(student)
    if args.out.endswith(".npz"):
        np.savez(args.out, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, args.out)
    print(f"wrote {len(sd)} tensors -> {args.out}")
    return sd


if __name__ == "__main__":
    main()
