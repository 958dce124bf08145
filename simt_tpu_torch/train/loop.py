"""The training loop (counterpart of ``simt_tpu/train/loop.py``): config -> models ->
data -> step -> eval and snapshots.

Mirrors the reference's main() flow for both stages (tools/trainV1_warmup.py:156-256,
tools/trainV2_simt.py:232-464): poly-LR'd steps, loss lines every ``log_every``, the
full val evaluation every ``save_pred_every`` with best-mIoU snapshot keep/delete, and
the early stop at ``num_steps_stop``. Unlike the reference, snapshots carry the
optimizer and step state, so runs resume.

The steps never wait for the card; the loop reads it on log steps only (the line and
the CSV row), at an evaluation and a snapshot, and once at the end.

Over several ranks (``cfg.mesh``, one process each in an initialised process group;
``parallel/mesh.py``) every rank runs this loop on its own device: the state is
replicated from rank 0, each rank's loader decodes its data index's block of every
global batch (``process_shard``) and, on a spatial axis, the rank keeps its rows of it
(``shard_rows``), the steps reduce across the ranks, the evaluation is sharded over
them (every rank reads the same mIoU and takes the same keep/delete branch), and rank
0 alone writes the CSV, the snapshots and deletes the previous best while the others
wait for its saves.
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
from ..models.deeplab_single import res_deeplab
from ..models.deeplab_vgg import deeplab_vgg
from ..models.deeplabv3 import deeplabv3
from ..models.resnet_multi import deeplab_multi, init_weights
from ..parallel.mesh import (Mesh, barrier, make_mesh, replicate_state, shard_rows,
                             world_size)
from ..utils import MetricWriter, StepTimer, format_simt_line, format_warmup_line
from . import checkpoint as ckpt_lib
from .simt import create_simt_state, make_simt_step
from .teacher_cache import TeacherCache
from .warmup import create_warmup_state, make_warmup_step

# What a step reads of a batch (``teacher_prob8``: the teacher cache's posterior).
STEP_KEYS = ("image", "label", "teacher_prob8")


def build_models(cfg) -> Tuple[nn.Module, Optional[nn.Module]]:
    """(student, teacher), dispatched on ``cfg.model.arch``, on the CPU with the
    reference's init seeded from ``cfg.random_seed``.

    ``deeplab_multi``: in the SimT stage the open-set student (``random_seed``) and the
    closed-set teacher (``random_seed + 1``); in the warmup stage the closed-set model
    and None. The other families (the reference's alternate eval models,
    evaluate_cityscapes.py:12-14) return (model, None) in either stage: Res_Deeplab
    (``deeplab_single``), DeepLab-VGG and DeepLabv3 (open-set per
    ``cfg.model.openset``)."""
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    c = cfg.model.num_classes
    eff = cfg.model.aspp_effective_branches
    seed = cfg.random_seed
    if cfg.stage not in ("simt", "warmup"):
        raise ValueError(f"stage must be 'simt' or 'warmup', got {cfg.stage!r}")
    arch = cfg.model.arch
    if arch == "deeplab_multi" and cfg.stage == "simt":
        student = deeplab_multi(c, cfg.model.open_classes, openset=True, dtype=dtype,
                                aspp_effective_branches=eff)
        teacher = deeplab_multi(c, 0, openset=False, dtype=dtype,
                                aspp_effective_branches=eff)
        init_weights(student, torch.Generator().manual_seed(seed))
        init_weights(teacher, torch.Generator().manual_seed(seed + 1))
        return student, teacher
    if arch == "deeplab_multi":
        model = deeplab_multi(c, 0, openset=False, dtype=dtype, aspp_effective_branches=eff)
    elif arch == "deeplab_single":
        model = res_deeplab(c, dtype=dtype)
    elif arch == "deeplab_vgg":
        model = deeplab_vgg(c, dtype=dtype)
    elif arch == "deeplabv3":
        model = deeplabv3(c, cfg.model.open_classes, openset=cfg.model.openset,
                          dtype=dtype)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model, None


def build_mesh(cfg, device: Union[str, torch.device] = "cuda") -> Optional[Mesh]:
    """The (data, spatial) mesh of ``cfg.mesh`` over the process group's ranks, or None
    for a single process at 1 x 1 (the reference's only mode). ``data_axis *
    spatial_axis`` must equal the world size: one process is one rank, so a single
    process asked for more raises (``make_mesh``)."""
    if world_size() == 1 and cfg.mesh.data_axis * cfg.mesh.spatial_axis == 1:
        return None
    return make_mesh(cfg.mesh.data_axis, cfg.mesh.spatial_axis, device=device)


def build_loader(cfg, root: Optional[str] = None, list_path: Optional[str] = None,
                 source: Optional[str] = None, batch_size: Optional[int] = None,
                 process_shard: Optional[Tuple[int, int]] = None,
                 device: Union[str, torch.device] = "cuda") -> Iterator[Dict]:
    """The shuffled, epoch-free training batches of ``cfg`` (a ``TrainConfig``) on
    ``device``: ``device_prefetch`` over a ``Loader`` of the ``source`` dataset
    (``cfg.data.source`` unless given), seeded with ``cfg.random_seed``.

    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU runs only when
    asked for. Sets the pipeline's ``USE_NATIVE`` from ``cfg.data.use_native_preproc``.
    ``process_shard=(index, count)`` decodes block ``index`` of every ``count *
    batch_size`` global batch (a rank's share; the JAX function's ``sharding=`` places
    the same block on the rank's devices, here ``device``).
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


def _loader_shard(cfg, mesh: Optional[Mesh]) -> Dict:
    """``build_loader``'s batch size and ``process_shard`` for this rank: the global
    batch is ``batch_size * data_axis`` (``DataConfig.batch_size`` is per data shard)
    and every rank of a spatial group decodes its data index's block of it (one rank a
    process: the rank then keeps its rows, ``shard_rows``)."""
    if mesh is None:
        return {}
    return {"batch_size": cfg.data.batch_size,
            "process_shard": (mesh.data_index, mesh.data)}


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

    Over several ranks (``cfg.mesh``; the module docstring) every rank calls it, with
    ``device`` naming the device type (a CUDA rank runs on the current device); an
    injected ``batch_iter`` yields this rank's block of each global batch, and the
    in-loop ``eval_fn`` must give every rank the same mIoU (``evaluate`` shards over
    the ranks and sums their histograms). On a spatial axis above 1 an injected
    ``batch_iter`` yields this rank's data block whole, and the loop keeps the rank's
    rows; every arch trains there.
    """
    dev = resolve_device(device)
    mesh = build_mesh(cfg, dev)
    if mesh is not None:
        dev = mesh.device
    is_rank0 = mesh is None or mesh.rank == 0
    if cfg.stage == "simt" and cfg.model.arch != "deeplab_multi":
        # The reference's SimT stage drives DeeplabMulti only (trainV2_simt.py:250);
        # the warmup stage trains every arch (the JAX package's refusal and message).
        raise ValueError(
            f"simt-stage training requires arch 'deeplab_multi' (got "
            f"{cfg.model.arch!r}); the reference trains only DeeplabMulti in the "
            "SimT stage (trainV2_simt.py:250)")
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
        step_fn, fmt = make_simt_step(cfg, mesh), format_simt_line
    else:
        if cfg.restore_from:
            # The warmup flavour drops the first 6 characters of every key
            # (trainV1_warmup.py:177).
            report = ckpt_lib.load_warmstart(student, cfg.restore_from, strip_prefix=6)
        state = create_warmup_state(student, cfg, dev)
        step_fn, fmt = make_warmup_step(cfg, mesh), format_warmup_line
    if cfg.restore_from:
        print_fn(f"warm-start: loaded {len(report['loaded'])} tensors from "
                 f"{cfg.restore_from} (missing {len(report['missing'])}, skipped "
                 f"{len(report['skipped'])})")

    if resume and cfg.snapshot_dir and ckpt_lib.latest_step(cfg.snapshot_dir) is not None:
        # Full resume (weights, optimizer states, step): impossible in the reference,
        # whose checkpoints carry only the model state_dict.
        ckpt_lib.restore(state, cfg.snapshot_dir)
        print_fn(f"resumed from step {state.step}")
    if mesh is not None:
        replicate_state(state, mesh)
        print_fn(f"mesh: data={mesh.data} spatial={mesh.spatial} over {mesh.world} "
                 "devices")

    def save(step: int) -> None:
        """Rank 0 writes the snapshot (hidden directory, then a rename); the other
        ranks wait until it is there."""
        if is_rank0:
            ckpt_lib.save(state, cfg.snapshot_dir, step)
        if mesh is not None:
            barrier(mesh)

    # The CSV, snapshot deletion and the NTM plots are rank 0's alone.
    writer = MetricWriter(csv_path if is_rank0 else None)
    best_miou, best_step = 0.0, 0
    stop_at = min(cfg.num_steps_stop, max_steps or cfg.num_steps_stop)
    metrics: Dict[str, torch.Tensor] = {}
    eval_seconds = []
    with contextlib.ExitStack() as stack:
        if batch_iter is None:
            batch_iter = build_loader(cfg, device=dev, **_loader_shard(cfg, mesh))
            stack.callback(batch_iter.close)  # stops the loader's workers
        if cfg.stage == "simt" and cfg.simt.cache_teacher:
            batch_iter = TeacherCache(state.teacher, mean_bgr=cfg.data.mean_bgr,
                                      mesh=mesh).wrap(batch_iter)
            print_fn("teacher cache enabled (float16 posteriors, skips teacher forward)")
        if mesh is not None and mesh.spatial > 1:
            batch_iter = (shard_rows(b, mesh) for b in batch_iter)
        stack.callback(writer.close)
        prof = stack.enter_context(_profiler(dev)) if profile_dir else None
        timer = StepTimer()
        for i_iter in range(state.step, stop_at):
            metrics = step_fn(state, _next_batch(batch_iter, cfg.optim.iter_size, dev))
            timer.tick()

            if i_iter % cfg.log_every == 0:
                print_fn(fmt(i_iter, cfg.num_steps, metrics))
                writer.write(i_iter, metrics)

            if (plot_ntm_every and cfg.stage == "simt" and i_iter % plot_ntm_every == 0
                    and is_rank0):
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
                if miou > best_miou:  # every rank reads the same mIoU
                    if best_step and cfg.snapshot_dir and is_rank0:
                        ckpt_lib.delete(cfg.snapshot_dir, best_step)
                    print_fn(f"Saving model with mIoU:  {miou}")
                    if cfg.snapshot_dir:
                        save(i_iter)
                    best_miou, best_step = miou, i_iter
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps_per_sec = timer.rate()
    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    if cfg.snapshot_dir:
        save(stop_at)
    return {
        "state": state,
        "best_miou": best_miou,
        "best_step": best_step,
        "steps_per_sec": steps_per_sec,
        "final_metrics": {k: float(v) for k, v in metrics.items()},
        "student": state.model,
        "eval_seconds": eval_seconds,
    }
