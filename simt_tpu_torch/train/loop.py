"""The training loop (counterpart of ``simt_tpu/train/loop.py``): config -> models ->
data -> step -> eval and snapshots.

Mirrors the reference's main() flow for both stages (tools/trainV1_warmup.py:156-256,
tools/trainV2_simt.py:232-464): poly-LR'd steps, loss lines every ``log_every``, the
full val evaluation every ``save_pred_every`` with best-mIoU snapshot keep/delete, and
the early stop at ``num_steps_stop``. Unlike the reference, snapshots carry the
optimizer and step state, so runs resume.

The steps never wait for the card; the loop reads it on log steps only (the line and
the CSV row), at an evaluation and a snapshot, and once at the end. The JAX package's
device mesh (``cfg.mesh``, per-process loader shards) comes with ROADMAP A-4 and its
teacher cache with A-5.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from ..data import pipeline as pipeline_lib
from ..data.pipeline import Loader, SegDataset, device_prefetch
from ..device import resolve_device
from ..models import ntm as ntm_lib
from ..models.resnet_multi import deeplab_multi, init_weights
from ..utils import MetricWriter, StepTimer, format_simt_line, format_warmup_line
from . import checkpoint as ckpt_lib
from .simt import create_simt_state, make_simt_step
from .warmup import create_warmup_state, make_warmup_step

# What a step reads of a batch (the JAX step's keys; the port's steps compute the
# teacher's posterior themselves and ignore ``teacher_prob8``).
STEP_KEYS = ("image", "label", "teacher_prob8")


def build_models(cfg) -> Tuple[nn.Module, Optional[nn.Module]]:
    """(student, teacher) of ``cfg.stage``, on the CPU with the reference's init: in the
    SimT stage the open-set student (seeded with ``cfg.random_seed``) and the
    closed-set teacher (``random_seed + 1``); in the warmup stage the closed-set model
    (``random_seed``) and None."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    c = cfg.model.num_classes
    seed = cfg.random_seed
    if cfg.stage == "simt":
        student = deeplab_multi(c, cfg.model.open_classes, openset=True, dtype=dtype)
        teacher = deeplab_multi(c, 0, openset=False, dtype=dtype)
        init_weights(student, torch.Generator().manual_seed(seed))
        init_weights(teacher, torch.Generator().manual_seed(seed + 1))
        return student, teacher
    if cfg.stage != "warmup":
        raise ValueError(f"stage must be 'simt' or 'warmup', got {cfg.stage!r}")
    model = deeplab_multi(c, 0, openset=False, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model, None


def build_loader(cfg, root: Optional[str] = None, list_path: Optional[str] = None,
                 source: Optional[str] = None, batch_size: Optional[int] = None,
                 process_shard: Optional[Tuple[int, int]] = None,
                 device: Union[str, torch.device] = "cuda") -> Iterator[Dict]:
    """The shuffled, epoch-free training batches of ``cfg`` (a ``TrainConfig``) on
    ``device``: ``device_prefetch`` over a ``Loader`` of the ``source`` dataset
    (``cfg.data.source`` unless given), seeded with ``cfg.random_seed``.

    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU runs only when
    asked for. Sets the pipeline's ``USE_NATIVE`` from ``cfg.data.use_native_preproc``.
    The JAX function's ``sharding=`` waits for ROADMAP A-4.
    """
    factory = {
        "cityscapes_pseudo": SegDataset.cityscapes_pseudo,  # the trained configuration
        # The source domain (gta5_dataset.py): the reference imports it in both
        # trainers but never instantiates it.
        "gta5": SegDataset.gta5,
    }[source or cfg.data.source]
    dev = resolve_device(device)
    pipeline_lib.USE_NATIVE = cfg.data.use_native_preproc
    ds = factory(root or cfg.data.root, list_path or cfg.data.list_path,
                 crop_wh=cfg.data.crop_size, mean_bgr=cfg.data.mean_bgr,
                 mirror=cfg.data.mirror, cache_dir=cfg.data.crop_cache_dir)
    loader = Loader(ds, batch_size or cfg.data.batch_size, shuffle=True,
                    seed=cfg.random_seed, num_workers=cfg.data.num_workers,
                    prefetch=cfg.data.prefetch, process_workers=cfg.data.process_workers,
                    process_shard=process_shard)
    return device_prefetch(iter(loader), size=cfg.data.prefetch, device=dev)


def _next_batch(batch_iter: Iterator[Dict], iter_size: int, dev: torch.device) -> Dict:
    """One optimizer step's batch: the step's keys of one loader batch, or of
    ``iter_size`` of them stacked on the card on a leading axis
    (trainV2_simt.py:345)."""
    if iter_size == 1:
        return {k: v for k, v in next(batch_iter).items() if k in STEP_KEYS}
    subs = [next(batch_iter) for _ in range(iter_size)]
    return {k: torch.stack([torch.as_tensor(s[k], device=dev) for s in subs])
            for k in subs[0] if k in STEP_KEYS}


def _plot_ntm(state, cfg, i_iter: int, plot_ntm_dir: str) -> None:
    """The NTM heat-maps (reference plot_NTM, trainV2_simt.py:187-200, whose call is
    commented out at :443-445; opt-in here)."""
    from ..utils import plot_ntm

    c, o = cfg.model.num_classes, cfg.model.open_classes
    with torch.no_grad():
        for tag, ntm in (("NTM1", state.t1), ("NTM2", state.t2)):
            t = ntm_lib.ntm_forward(ntm.param, state.class_dist, c, o)
            plot_ntm(t, os.path.join(plot_ntm_dir, f"{tag}_{i_iter}.png"),
                     title=f"{tag}_{i_iter}")


def _profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def train(
    cfg,
    *,
    batch_iter: Optional[Iterator[Dict]] = None,
    eval_fn: Optional[Callable[[nn.Module], float]] = None,
    print_fn: Callable[[str], None] = print,
    csv_path: Optional[str] = None,
    max_steps: Optional[int] = None,
    resume: bool = False,
    profile_dir: Optional[str] = None,
    plot_ntm_every: int = 0,
    plot_ntm_dir: str = "ntm_vis",
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Run one stage (``cfg.stage``) on ``device`` from step 0, or with ``resume`` from
    the newest snapshot of ``cfg.snapshot_dir``, to ``min(num_steps_stop, max_steps)``.

    ``batch_iter`` yields loader batches (``build_loader(cfg)`` when None, restarted
    from ``cfg.random_seed`` on resume as in the JAX package). ``eval_fn(model) ->
    mIoU`` runs at every ``save_pred_every``-th step but the first; the student is put
    back in train mode after it. A better mIoU saves a snapshot and deletes the
    previous best; the last step saves one. ``profile_dir`` records a
    ``torch.profiler`` trace (CPU and, on a card, CUDA activity) over the loop into
    ``<profile_dir>/trace.json``.

    Returns the JAX package's summary (``state``, ``best_miou``, ``best_step``,
    ``steps_per_sec``, ``final_metrics``, ``student``) and ``eval_seconds``, the host
    seconds of each evaluation. ``steps_per_sec`` synchronizes the card first and
    counts the loop alone, evaluations and snapshots inside it included.
    """
    dev = resolve_device(device)
    if cfg.simt.cache_teacher:
        raise ValueError("cache_teacher (the JAX package's teacher cache) comes with "
                         "ROADMAP A-5")
    print_fn("Start: " + time.asctime(time.localtime(time.time())))
    student, teacher = build_models(cfg)
    if cfg.stage == "simt":
        if cfg.restore_from:
            # Both student and teacher start from the warmup checkpoint by key
            # intersection (trainV2_simt.py:250-267).
            report = ckpt_lib.load_warmstart(student, cfg.restore_from)
            ckpt_lib.load_warmstart(teacher, cfg.restore_from)
        state = create_simt_state(student, teacher, cfg,
                                  torch.Generator().manual_seed(cfg.random_seed + 2), dev)
        step_fn, fmt = make_simt_step(cfg), format_simt_line
    else:
        if cfg.restore_from:
            # The warmup flavour drops the first 6 characters of every key
            # (trainV1_warmup.py:177).
            report = ckpt_lib.load_warmstart(student, cfg.restore_from, strip_prefix=6)
        state = create_warmup_state(student, cfg, dev)
        step_fn, fmt = make_warmup_step(cfg), format_warmup_line
    if cfg.restore_from:
        print_fn(f"warm-start: loaded {len(report['loaded'])} tensors from "
                 f"{cfg.restore_from} (missing {len(report['missing'])}, skipped "
                 f"{len(report['skipped'])})")

    if resume and cfg.snapshot_dir and ckpt_lib.latest_step(cfg.snapshot_dir) is not None:
        # Full resume (weights, optimizer states, step): impossible in the reference,
        # whose checkpoints carry only the model state_dict.
        ckpt_lib.restore(state, cfg.snapshot_dir)
        print_fn(f"resumed from step {state.step}")

    writer = MetricWriter(csv_path)
    best_miou, best_step = 0.0, 0
    stop_at = min(cfg.num_steps_stop, max_steps or cfg.num_steps_stop)
    metrics: Dict[str, torch.Tensor] = {}
    eval_seconds = []
    with contextlib.ExitStack() as stack:
        if batch_iter is None:
            batch_iter = build_loader(cfg, device=dev)
            stack.callback(batch_iter.close)  # stops the loader's workers
        stack.callback(writer.close)
        prof = stack.enter_context(_profiler(dev)) if profile_dir else None
        timer = StepTimer()
        for i_iter in range(state.step, stop_at):
            metrics = step_fn(state, _next_batch(batch_iter, cfg.optim.iter_size, dev))
            timer.tick()

            if i_iter % cfg.log_every == 0:
                print_fn(fmt(i_iter, cfg.num_steps, metrics))
                writer.write(i_iter, metrics)

            if plot_ntm_every and cfg.stage == "simt" and i_iter % plot_ntm_every == 0:
                _plot_ntm(state, cfg, i_iter, plot_ntm_dir)

            if eval_fn is not None and i_iter % cfg.save_pred_every == 0 and i_iter != 0:
                print_fn(datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                         + "  Begin evaluation on iter {0:8d}/{1:8d}  ".format(
                             i_iter, cfg.num_steps))
                t0 = time.perf_counter()
                miou = eval_fn(state.model)
                eval_seconds.append(time.perf_counter() - t0)
                state.model.train()  # evaluate() leaves it in eval mode
                print_fn("Finish Evaluation: " + time.asctime(time.localtime(time.time())))
                if miou > best_miou:
                    if best_step and cfg.snapshot_dir:
                        ckpt_lib.delete(cfg.snapshot_dir, best_step)
                    print_fn(f"Saving model with mIoU:  {miou}")
                    if cfg.snapshot_dir:
                        ckpt_lib.save(state, cfg.snapshot_dir, i_iter)
                    best_miou, best_step = miou, i_iter
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps_per_sec = timer.rate()
    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    if cfg.snapshot_dir:
        ckpt_lib.save(state, cfg.snapshot_dir, stop_at)
    return {
        "state": state,
        "best_miou": best_miou,
        "best_step": best_step,
        "steps_per_sec": steps_per_sec,
        "final_metrics": {k: float(v) for k, v in metrics.items()},
        "student": state.model,
        "eval_seconds": eval_seconds,
    }
