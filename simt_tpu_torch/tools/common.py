"""Shared CLI plumbing of the port's tools (counterpart of ``tools/common.py``): the
flags of every trainer and of the eval CLI, the config they build, the synthetic
fixture and the in-loop evaluation.

Every flag of the JAX tools is accepted, ``--device`` in place of ``--platform``. The
flags of later ports raise when set, naming the ROADMAP item that brings them:
``--mesh-data``, ``--mesh-spatial``, ``--coordinator``, ``--num-processes`` and
``--process-id`` (A-4); ``--model`` other than ``deeplab_multi`` and
``--cache-teacher`` (A-5).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import config as config_lib
from ..device import resolve_device

# (flag attribute, ROADMAP item) of the flags whose ports come later.
LATER = (("mesh_data", "A-4"), ("mesh_spatial", "A-4"), ("coordinator", "A-4"),
         ("num_processes", "A-4"), ("process_id", "A-4"), ("cache_teacher", "A-5"))


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", type=str, default=None,
                        help="named preset: warmup_bapa, simt_bapa_lr25, simt_bapa_lr6, simt_sfda")
    parser.add_argument("--data-dir-target", type=str, default="",
                        help="Cityscapes root (images resolved against it)")
    parser.add_argument("--data-list-target", type=str, default=None,
                        help=".lst file with image\\tpseudo-label rows")
    parser.add_argument("--source-domain", type=str, default=None,
                        choices=["cityscapes_pseudo", "gta5"],
                        help="training source: cityscapes pseudo-label pairs (the "
                             "reference's trained config) or GTA5 name lists with id "
                             "remap (trainV1_warmup.py:83-85)")
    parser.add_argument("--gt-dir", type=str, default=None,
                        help="directory of *_gtFine_labelIds.png val ground truth")
    parser.add_argument("--val-list", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--iter-size", type=int, default=None,
                        help="accumulate gradients over N sub-batches per optimizer "
                             "step (reference ITER_SIZE, trainV2_simt.py:85-86)")
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="data-parallel degree (comes with ROADMAP A-4)")
    parser.add_argument("--mesh-spatial", type=int, default=None,
                        help="spatial degree (comes with ROADMAP A-4)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host coordinator host:port (comes with ROADMAP A-4)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-host process count (comes with ROADMAP A-4)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's index (comes with ROADMAP A-4)")
    parser.add_argument("--input-size-target", type=str, default=None,
                        help="'W,H' crop size (reference format, e.g. '1024,512')")
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--learning-rate-T", type=float, default=None)
    parser.add_argument("--num-classes", type=int, default=None)
    parser.add_argument("--open-classes", type=int, default=None)
    parser.add_argument("--num-steps", type=int, default=None)
    parser.add_argument("--num-steps-stop", type=int, default=None)
    parser.add_argument("--save-pred-every", type=int, default=None)
    parser.add_argument("--log-every", type=int, default=None,
                        help="print a loss line and write a CSV row every N steps "
                             "(default 100, trainV2_simt.py:438)")
    parser.add_argument("--random-seed", type=int, default=None)
    parser.add_argument("--random-mirror", action="store_true")
    parser.add_argument("--restore-from", type=str, default=None,
                        help=".pth/.npz warm-start checkpoint")
    parser.add_argument("--snapshot-dir", type=str, default=None)
    parser.add_argument("--Threshold-high", type=float, default=None)
    parser.add_argument("--Threshold-low", type=float, default=None)
    parser.add_argument("--lambda-Place", type=float, default=None)
    parser.add_argument("--lambda-Convex", type=float, default=None)
    parser.add_argument("--lambda-Volume", type=float, default=None)
    parser.add_argument("--lambda-Anchor", type=float, default=None)
    parser.add_argument("--class-dist", type=str, default=None,
                        help="prior name (bapa/sfdaseg/...) or .npy path")
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=["bfloat16", "float32"])
    parser.add_argument("--model", type=str, default=None,
                        choices=["deeplab_multi", "deeplab_single", "deeplab_vgg",
                                 "deeplabv3"],
                        help="model arch (evaluate_cityscapes.py:38); the port builds "
                             "deeplab_multi, the others come with ROADMAP A-5")
    parser.add_argument("--debug-nans", action="store_true",
                        help="autograd anomaly detection with NaN checks")
    parser.add_argument("--plot-ntm-every", type=int, default=0,
                        help="dump NTM heat-maps every N iters (reference plot_NTM, "
                             "trainV2_simt.py:187-200; needs matplotlib)")
    parser.add_argument("--plot-ntm-dir", type=str, default="ntm_vis")
    parser.add_argument("--crop-cache-dir", type=str, default=None,
                        help="on-disk decoded-crop cache dir (epochs after the first "
                             "decode no PNG; data/pipeline.py CropCache)")
    parser.add_argument("--cache-teacher", action="store_true",
                        help="cache the frozen teacher's posterior (comes with ROADMAP A-5)")
    parser.add_argument("--synthetic", action="store_true",
                        help="run on a generated small dataset in a temporary directory")
    parser.add_argument("--csv", type=str, default=None, help="metric CSV output path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace (trace.json) here")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest snapshot in --snapshot-dir "
                             "(full optimizer/step state; impossible in the reference)")


def apply_device(args) -> torch.device:
    """The device the CLI runs on (raises for 'cuda' without a card), before anything
    is built. ``--debug-nans`` turns on autograd's anomaly detection with NaN checks
    (the counterpart of ``jax_debug_nans``)."""
    dev = resolve_device(args.device)
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    return dev


def _refuse_later(args) -> None:
    for flag, item in LATER:
        if getattr(args, flag, None):
            raise ValueError(f"--{flag.replace('_', '-')} comes with ROADMAP {item}; "
                             "the port does not have it yet")


def build_config(args, stage: str) -> config_lib.TrainConfig:
    """The ``TrainConfig`` of ``stage`` from the preset (or the defaults) and the flags;
    raises for a flag of a later ROADMAP item."""
    _refuse_later(args)
    cfg = config_lib.preset(args.preset) if args.preset else config_lib.TrainConfig()
    cfg = cfg.replace(stage=stage)

    optim = cfg.optim
    for cli, field in [("learning_rate", "learning_rate"),
                       ("learning_rate_T", "learning_rate_t"),
                       ("num_steps", "num_steps"), ("iter_size", "iter_size")]:
        if getattr(args, cli) is not None:
            optim = dataclasses.replace(optim, **{field: getattr(args, cli)})

    simt = cfg.simt
    for cli, field in [
        ("Threshold_high", "threshold_high"), ("Threshold_low", "threshold_low"),
        ("lambda_Place", "lambda_place"), ("lambda_Convex", "lambda_convex"),
        ("lambda_Volume", "lambda_volume"), ("lambda_Anchor", "lambda_anchor"),
        ("class_dist", "class_dist"),
    ]:
        if getattr(args, cli) is not None:
            simt = dataclasses.replace(simt, **{field: getattr(args, cli)})

    model = dataclasses.asdict(cfg.model)
    for cli, field in [("num_classes", "num_classes"), ("open_classes", "open_classes"),
                       ("compute_dtype", "compute_dtype"), ("model", "arch")]:
        if getattr(args, cli) is not None:
            model[field] = getattr(args, cli)
    model["openset"] = stage == "simt"
    model = config_lib.ModelConfig(**model)  # raises for another arch (ROADMAP A-5)

    data = cfg.data
    if args.data_dir_target:
        data = dataclasses.replace(data, root=args.data_dir_target)
    if args.data_list_target is not None:
        data = dataclasses.replace(data, list_path=args.data_list_target)
    if args.batch_size is not None:
        data = dataclasses.replace(data, batch_size=args.batch_size)
    if args.input_size_target is not None:
        w, h = map(int, args.input_size_target.split(","))
        data = dataclasses.replace(data, crop_size=(w, h))
    if args.random_mirror:
        data = dataclasses.replace(data, mirror=True)
    if args.crop_cache_dir:
        data = dataclasses.replace(data, crop_cache_dir=args.crop_cache_dir)
    if args.source_domain:
        data = dataclasses.replace(data, source=args.source_domain)

    kw = {}
    for cli in ("num_steps", "num_steps_stop", "save_pred_every", "log_every",
                "random_seed", "restore_from", "snapshot_dir"):
        if getattr(args, cli) is not None:
            kw[cli] = getattr(args, cli)
    return cfg.replace(model=model, data=data, optim=optim, simt=simt, **kw)


def setup_synthetic(cfg, tmp_root: str, image_wh: Tuple[int, int] = (128, 64),
                    snapshot_dir: str = "") -> Tuple[config_lib.TrainConfig, dict]:
    """Write a fixture (8 train and 2 val images at ``image_wh``) under ``tmp_root`` and
    point the config at it, with crops of ``image_wh``. Returns (cfg, paths).

    As in the JAX tool, snapshots are off unless ``snapshot_dir`` names a directory.
    Unlike it, ``restore_from`` stays, so a warm start can be tried on the fixture, and
    the pseudo-labels are drawn from the model's classes (19 in the JAX tool, whatever
    ``--num-classes`` says)."""
    from ..data.synthetic import make_cityscapes_fixture

    paths = make_cityscapes_fixture(tmp_root, n_train=8, n_val=2, image_wh=image_wh,
                                    num_classes=cfg.model.num_classes)
    data = dataclasses.replace(cfg.data, root=paths["root"], list_path=paths["pseudo_lst"],
                               crop_size=tuple(image_wh),
                               batch_size=max(1, cfg.data.batch_size))
    return cfg.replace(data=data, snapshot_dir=snapshot_dir), paths


def uniform_class_dist(cfg, tmp_root: str) -> config_lib.TrainConfig:
    """``cfg`` with a uniform class prior written under ``tmp_root`` (the synthetic
    runs' prior, as in the JAX tool)."""
    c = cfg.model.num_classes
    path = os.path.join(tmp_root, "class_dist.npy")
    np.save(path, (np.ones(c) / c).astype(np.float32))
    return cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=path))


def scaled_protocol(cfg) -> dict:
    """The synthetic runs' eval protocol: scales of the crop and 5/4 of it, scored at
    the crop's size (the fixture's gt is at the image size, which is the crop's)."""
    w, h = cfg.data.crop_size
    return dict(scales=((w, h), (w * 5 // 4, h * 5 // 4)), out_hw=(h, w))


def build_eval_fn(cfg, args, paths: Optional[dict], mode: str,
                  device: torch.device) -> Optional[Callable[[torch.nn.Module], float]]:
    """``eval_fn(model) -> mIoU`` for ``train()``: the two-scale protocol over
    ``--val-list`` / ``--gt-dir`` (the fixture's under ``--synthetic``, at
    ``scaled_protocol``), or None when no val set is named."""
    from ..eval import evaluate

    val_list = paths["val_txt"] if paths else args.val_list
    gt_dir = paths["gt_dir"] if paths else args.gt_dir
    if not (gt_dir and val_list):
        return None
    eval_kw = scaled_protocol(cfg) if paths else {}
    root = paths["root"] if paths else cfg.data.root

    def eval_fn(model):
        return evaluate(model, data_root=root, val_list=val_list, gt_dir=gt_dir,
                        mode=mode, process_workers=cfg.data.process_workers,
                        batch_size=cfg.data.batch_size, device=device, **eval_kw)

    return eval_fn
