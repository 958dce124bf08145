"""Warmup-stage training CLI (counterpart of ``tools/train_warmup.py``; reference
tools/trainV1_warmup.py + sh_warmup.sh:17).

  python -m simt_tpu_torch.tools.train_warmup --data-dir-target /data/Cityscapes \\
      --gt-dir /data/Cityscapes/label \\
      --val-list simt_tpu_torch/data/assets/cityscapes_list/val.txt --snapshot-dir snaps
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --save-pred-every 2
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --device cpu \\
      --num-classes 5 --input-size-target 64,32 --compute-dtype float32
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --adversarial
  python -m simt_tpu_torch.tools.train_warmup --synthetic --num-steps-stop 3 --model deeplabv3

Runs ``train/loop.py::train`` on the warmup stage (the closed-set model of ``--model``,
DeepLabv2-ResNet-101 by default, ``--restore-from`` loaded after the reference's
``k[6:]``): the same loop, evaluation and snapshots as ``train_simt``, with the
single-scale warmup evaluation. The preset defaults to ``warmup_bapa`` (NUM_STEPS_STOP
150 000, trainV1_warmup.py:52). ``--adversarial`` runs the JAX CLI's adversarial loop
instead (``train/adversarial.py``: the model with an ``FCDiscriminator``; a loss line
every ``--log-every`` steps, no evaluation and no snapshots). As in the JAX tool, that
loop runs outside ``train()`` and takes no mesh: it refuses ``--num-processes`` above 1.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from .. import config as config_lib
from ..models import FCDiscriminator, init_weights
from ..train.adversarial import create_discriminator_state, make_adversarial_warmup_step
from ..train.checkpoint import load_warmstart
from ..train.loop import build_loader, build_models, train
from ..train.warmup import create_warmup_state
from ..utils import StepTimer, format_warmup_line
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Warmup stage trainer (PyTorch + CUDA)")
    common.add_common_args(p)
    p.set_defaults(preset="warmup_bapa")
    p.add_argument("--adversarial", action="store_true",
                   help="train with the FCDiscriminator output-space loss (an extension; "
                        "the reference ships the discriminator unused)")
    return p


def build_config(args) -> config_lib.TrainConfig:
    if args.preset not in config_lib.WARMUP_PRESETS:
        raise ValueError(f"preset {args.preset!r} is not a warmup preset")
    return common.build_config(args, stage="warmup")


def run_adversarial(cfg, device: torch.device) -> dict:
    """The JAX CLI's adversarial loop (tools/train_warmup.py:14-49): the model and an
    ``FCDiscriminator`` (seeded from ``random_seed + 1``) trained ``num_steps_stop``
    steps on ``build_loader``'s batches, a loss line every ``log_every`` steps. Returns
    ``state``, ``d_state``, ``steps_per_sec`` (the card synchronized first) and
    ``final_metrics``."""
    model, _ = build_models(cfg)
    if cfg.restore_from:
        load_warmstart(model, cfg.restore_from, strip_prefix=6)
    state = create_warmup_state(model, cfg, device)
    dtype = torch.float32 if cfg.model.compute_dtype == "float32" else torch.bfloat16
    disc = init_weights(FCDiscriminator(cfg.model.num_classes, dtype=dtype),
                        torch.Generator().manual_seed(cfg.random_seed + 1))
    d_state = create_discriminator_state(disc, device)
    step = make_adversarial_warmup_step(cfg)
    batch_iter = build_loader(cfg, device=device)
    metrics = {}
    try:
        timer = StepTimer()
        for i_iter in range(cfg.num_steps_stop):
            batch = next(batch_iter)
            metrics = step(state, d_state, {k: batch[k] for k in ("image", "label")})
            timer.tick()
            if i_iter % cfg.log_every == 0:
                print(f"{format_warmup_line(i_iter, cfg.num_steps, metrics)} "
                      f"loss_adv = {float(metrics['loss_adv']):.3f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps_per_sec = timer.rate()
    finally:
        batch_iter.close()
    print("done (adversarial warmup)")
    return {"state": state, "d_state": d_state, "steps_per_sec": steps_per_sec,
            "final_metrics": {k: float(v) for k, v in metrics.items()}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``train()``'s summary (``run_adversarial``'s with ``--adversarial``)."""
    args = build_parser().parse_args(argv)
    if args.adversarial and (args.num_processes or 1) > 1:
        raise ValueError("--adversarial runs in a single process (no mesh, as in the JAX "
                         "tool); drop --num-processes")
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
        if args.adversarial:
            return run_adversarial(cfg, device)
        summary = train(cfg, eval_fn=common.build_eval_fn(cfg, args, paths, "warmup",
                                                          device),
                        csv_path=args.csv, resume=args.resume, profile_dir=args.profile_dir,
                        device=device)
    print(f"done: {summary['steps_per_sec']:.3f} steps/s, best mIoU {summary['best_miou']}")
    return summary


if __name__ == "__main__":
    main()
