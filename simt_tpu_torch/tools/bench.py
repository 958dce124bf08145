"""Benchmark entry of the port (counterpart of the JAX package's ``bench.py``): the SimT
train step's throughput against the reference's rate.

    python -m simt_tpu_torch.tools.bench              SimT steps/s on one resident batch
    python -m simt_tpu_torch.tools.bench --pipeline   the same step fed from PNGs on disk:
        a 12-image fixture at Cityscapes' native 2048x1024 -> ``build_loader`` (process
        workers, native preprocessing, ``device_prefetch``) -> the step
    python -m simt_tpu_torch.tools.bench --pipeline --crop-cache
        the same with the decoded-crop cache: epoch 1 fills it, the timed steps decode no
        PNG
    python -m simt_tpu_torch.tools.bench --pipeline --cache-teacher
        the same with the teacher-posterior cache (``train/teacher_cache.py``): the
        warm-up steps fill it, the timed steps skip the teacher's forward on hits
    python -m simt_tpu_torch.tools.bench --eval       two-scale eval img/s (bench_eval.py)
    python -m simt_tpu_torch.tools.bench --warmup     warmup steps/s (bench_warmup.py)

Options: ``--batch-size N`` (the resident mode's batch, default 1) and ``--device
cuda|cpu`` (default ``cuda``, which raises without a card). Every mode prints exactly one
JSON line on stdout, ``{"metric", "value", "unit", "vs_baseline"}``, under the JAX
bench's metric names. Before it, on stderr: the profiler's device ms per step (or image),
the card's busy share (device ms over wall ms) and, for ``--pipeline``, the loader's own
host ms per item, measured alone. Everything else the run prints goes to stderr too.

Baselines are the reference's own GPU logs, not TPU numbers: 1.29 steps/s for the SimT
stage (bs 1, 1024x512, ``logs/BAPA_SimT_lr25.out`` timestamps; the warmup mode uses it
as a proxy) and 1.55 img/s for the eval (500 val images x 2 scales in 550-750 s).

The step counts are the JAX bench's: resident 3 warm-up + 20 timed steps; ``--pipeline``
3 warm-up steps (14 with ``--crop-cache`` or ``--cache-teacher``, so that epoch 1 fills
the cache) + 50 timed.
The run functions take the geometry and the step counts (the JAX bench's by default), so
a test can run each mode on the CPU at a tiny size; on the CPU the convolutions run in
float32 and no device time is measured.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch

from ..config import ModelConfig, SimTConfig, TrainConfig
from ..data.synthetic import make_cityscapes_fixture, synthetic_batch
from ..device import resolve_device
from ..models import ResNetMulti, init_weights
from ..train import build_loader, create_simt_state, make_simt_step
from ..train.teacher_cache import TeacherCache
from .timing import profile_steps, timed_steps

BASELINE_STEPS_PER_SEC = 1.29
RESNET101 = (3, 4, 23, 3)
TRAIN_HW = (512, 1024)  # the reference's training crop (INPUT_SIZE_TARGET '1024,512')
FIXTURE_WH = (2048, 1024)  # Cityscapes' native resolution
FIXTURE_IMAGES = 12
LOADER_ITEMS = 24  # items the loader is timed over alone, after its first batch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def dtypes(dev: torch.device) -> Tuple[str, torch.dtype]:
    """(``ModelConfig.compute_dtype``, the model's dtype): bf16 autocast on the card, as
    the JAX bench; float32 on the CPU."""
    return ("bfloat16", torch.bfloat16) if dev.type == "cuda" else ("float32", torch.float32)


def simt_setup(dev: torch.device, *, layers: Sequence[int] = RESNET101):
    """The JAX bench's ``_setup``: the SimT config (19 + 15 classes, default optimizer
    and SimT settings), an open-set student and a closed-set teacher with seeded random
    weights, the state and the step."""
    compute, dtype = dtypes(dev)
    cfg = TrainConfig(model=ModelConfig(num_classes=19, open_classes=15,
                                        compute_dtype=compute), simt=SimTConfig())
    student = init_weights(ResNetMulti(19, 15, True, layers=layers, dtype=dtype),
                           torch.Generator().manual_seed(0))
    teacher = init_weights(ResNetMulti(19, 0, False, layers=layers, dtype=dtype),
                           torch.Generator().manual_seed(1))
    state = create_simt_state(student, teacher, cfg, torch.Generator().manual_seed(2), dev)
    return cfg, state, make_simt_step(cfg)


def device_report(step, state, batches, wall_ms: float, dev: torch.device,
                  what: str = "step") -> Optional[float]:
    """Prints the profiler's device ms per ``what`` and the busy share (device ms over
    ``wall_ms``) on stderr; returns the device ms (None on the CPU: not measured)."""
    if dev.type != "cuda":
        log(f"device ms per {what}: not measured (CPU run); wall {wall_ms:.3f} ms")
        return None
    device_ms = profile_steps(step, state, batches, print_fn=log)
    log(f"device ms per {what} (profiler): {device_ms:.3f}; wall ms per {what}: "
        f"{wall_ms:.3f}; busy share {device_ms / wall_ms:.3f}; "
        f"{torch.cuda.get_device_name(dev)}")
    return device_ms


def line(metric: str, value: float, unit: str, baseline: float, digits: int = 3,
         **extra) -> dict:
    return {"metric": metric, "value": round(value, digits), "unit": unit,
            "vs_baseline": round(value / baseline, 2), **extra}


def resident(batch_size: int = 1, *, hw: Tuple[int, int] = TRAIN_HW,
             layers: Sequence[int] = RESNET101, warm: int = 3, steps: int = 20,
             device="cuda") -> dict:
    """SimT steps/s on one synthetic batch resident on the device (the JAX bench's
    ``main``)."""
    dev = resolve_device(device)
    cfg, state, step = simt_setup(dev, layers=layers)
    raw = synthetic_batch(batch_size=batch_size, hw=hw, num_classes=19, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    wall_ms = timed_steps(step, state, lambda: batch, warm, steps, dev, "loss")
    device_report(step, state, [batch], wall_ms, dev)
    return line(f"simt_train_steps_per_sec_bs{batch_size}_{hw[0]}x{hw[1]}",
                1e3 / wall_ms, "steps/s", BASELINE_STEPS_PER_SEC)


def loader_ms_per_item(cfg, items: int = LOADER_ITEMS) -> Tuple[float, float]:
    """The loader of ``cfg`` alone, with nothing consuming its batches (``build_loader``
    on the CPU, where ``device_prefetch`` only wraps the arrays): (seconds to its first
    batch, worker start-up included; host ms per item over the next ``items``)."""
    n = max(1, items // cfg.data.batch_size)
    t0 = time.perf_counter()
    it = build_loader(cfg, device="cpu")
    try:
        next(it)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        per_item = (time.perf_counter() - t0) / (n * cfg.data.batch_size) * 1e3
    finally:
        it.close()
    return first, per_item


def pipeline_config(cfg, root: str, list_path: str, hw: Tuple[int, int],
                    crop_cache_dir: str = ""):
    """``cfg`` reading the fixture at ``root``: crops of ``hw`` from its pseudo list,
    the rest of ``DataConfig``'s defaults (process workers, native preprocessing)."""
    return cfg.replace(data=dataclasses.replace(
        cfg.data, root=root, list_path=list_path, crop_size=(hw[1], hw[0]),
        crop_cache_dir=crop_cache_dir))


def pipeline(crop_cache: bool = False, *, cache_teacher: bool = False,
             image_wh: Tuple[int, int] = FIXTURE_WH,
             hw: Tuple[int, int] = TRAIN_HW, n_images: int = FIXTURE_IMAGES,
             layers: Sequence[int] = RESNET101, warm: Optional[int] = None,
             steps: int = 50, loader_items: int = LOADER_ITEMS, device="cuda") -> dict:
    """SimT steps/s fed from PNGs on disk (the JAX bench's ``main_pipeline``): a fixture of
    ``n_images`` at ``image_wh``, ``build_loader`` with the config's defaults (wrapped by
    a ``TeacherCache`` with ``cache_teacher``), ``warm`` steps (3, or ``n_images + 2``
    with either cache, as the JAX bench), then ``steps`` timed. Epoch 1 fills the crop
    cache; the teacher cache is keyed on (name, mirror), two keys an image with random
    mirroring, so some of its misses fall inside the timed steps. Afterwards the loader
    alone: its start-up and host ms per item."""
    dev = resolve_device(device)
    cfg, state, step = simt_setup(dev, layers=layers)
    if warm is None:
        warm = n_images + 2 if crop_cache or cache_teacher else 3
    root = tempfile.mkdtemp(prefix="simt_torch_bench_fixture_")
    try:
        t0 = time.perf_counter()
        paths = make_cityscapes_fixture(root, n_train=n_images, n_val=0,
                                        image_wh=image_wh, seed=0)
        log(f"fixture: {n_images} images at {image_wh[0]}x{image_wh[1]} in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = pipeline_config(cfg, root, paths["pseudo_lst"], hw,
                              os.path.join(root, "crop_cache") if crop_cache else "")
        batches = build_loader(cfg, device=dev)
        try:
            feed = batches
            if cache_teacher:
                cache = TeacherCache(state.teacher, mean_bgr=cfg.data.mean_bgr)
                feed = cache.wrap(batches)
            wall_ms = timed_steps(step, state, lambda: next(feed), warm, steps, dev,
                                  "loss")
            profiled = [next(feed) for _ in range(3)]
        finally:
            batches.close()
        if cache_teacher:
            log(f"teacher cache: {cache.hits} hits, {cache.misses} misses, "
                f"{len(cache)} entries")
        device_report(step, state, profiled, wall_ms, dev)
        first, per_item = loader_ms_per_item(cfg, loader_items)
        log(f"loader alone ({cfg.data.num_workers} "
            f"{'process' if cfg.data.process_workers else 'thread'} workers, "
            f"{'native' if cfg.data.use_native_preproc else 'PIL'}, crop cache "
            f"{'on' if crop_cache else 'off'}): first batch {first:.3f} s, "
            f"{per_item:.3f} host ms per item")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return line(f"simt_train_steps_per_sec_bs1_{hw[0]}x{hw[1]}_with_input_pipeline"
                + ("_crop_cache" if crop_cache else "")
                + ("_teacher_cache" if cache_teacher else ""),
                1e3 / wall_ms, "steps/s", BASELINE_STEPS_PER_SEC)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SimT benchmark entry (PyTorch + CUDA)")
    p.add_argument("--pipeline", action="store_true",
                   help="feed the step from PNGs on disk through build_loader")
    p.add_argument("--crop-cache", action="store_true",
                   help="with --pipeline: the decoded-crop cache on")
    p.add_argument("--cache-teacher", action="store_true",
                   help="with --pipeline: the teacher-posterior cache "
                        "(train/teacher_cache.py)")
    p.add_argument("--eval", action="store_true", help="two-scale eval img/s")
    p.add_argument("--warmup", action="store_true", help="warmup-stage steps/s")
    p.add_argument("--batch-size", type=int, default=1,
                   help="the resident mode's batch size")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def run(args, **kw) -> dict:
    """The mode ``args`` names; ``kw`` (geometry, step counts) goes to its function."""
    if args.cache_teacher and not args.pipeline:
        raise SystemExit("--cache-teacher goes with --pipeline: the cache is keyed on the "
                         "loader's image names")
    if args.eval:
        from . import bench_eval

        return bench_eval.run(device=args.device, **kw)
    if args.warmup:
        from . import bench_warmup

        return bench_warmup.run(device=args.device, **kw)
    if args.pipeline:
        return pipeline(args.crop_cache, cache_teacher=args.cache_teacher,
                        device=args.device, **kw)
    return resident(args.batch_size, device=args.device, **kw)


def main(argv: Optional[Sequence[str]] = None, **kw) -> dict:
    """Runs one mode (``kw``: its geometry and step counts, the JAX bench's by default);
    its JSON line is the only line on stdout."""
    args = build_parser().parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args, **kw)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
