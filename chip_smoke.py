#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (simt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build: compile every CUDA source of the package with nvcc for sm_90a, in parallel;
  2. kernels vs plain, on the card: the eval head (B1) at the eval path's shapes
     (65x129 + 81x161 logits, 19 classes, -> 1024x2048; batch 1 and 2; warmup's 1x1
     zero operand; iid gt and 64x64 regions aligned to the warps and shifted off them)
     and edge cases, each with uint8 and int32 gt, run twice, with out= into a running
     histogram and (at 1024x2048) as 4 row blocks, all equal bit for bit to the
     kernel's own arithmetic (``bench_eval_fused.kernel_arithmetic``), and one case
     through ``multiscale_argmax_hist_spatial`` on a one-rank NCCL group; the trunk's
     dilated 3x3 conv
     (B4 forward and input gradient, B5 weight gradient) at the four trunk geometries
     of a 512x1024 input in bf16 at batch 1 and 2, at those of the eval path's 640x1280
     input at batch 1, in float32 at a small one, and on edge cases (3 -> 5
     channels on 13x10, padding wider than a 3x5 image, channel counts off the tiles),
     each run twice and bitwise equal, printing the kernel variant each case took; one
     B4 forward, dx and B5 at layer3 under the profiler, which must show one package
     kernel each (and the weight permute's copy);
     the fused train-mode bottleneck (B6 forward, B7 backward) at the four trunk
     identity-block geometries and on edge cases (an odd 9x13 image, dilation 4 on a
     3x5 image, 36/9 channels off the vector width), each run twice and bitwise equal,
     every trunk geometry on the wgmma kernels and the off-vector case on the first
     port's; one fused forward + backward at layer3 under the profiler, which must show
     no kernel but the package's own (and fills);
  3. small-input checks, float32 on the card against the CPU: the whole evaluation,
     three whole SimT steps at the golden geometry (C5+O3, layers (1,1,1,1), 32x64,
     inner_w_steps 3) and three warmup steps at the same geometry (closed set);
  4. main paths, each with every launch count zeroed just before and read just after
     (each count must equal the path's own, 0 for a kernel it does not run; every B4/B5
     launch must be of the wgmma variant):
     the two-scale ``evaluate(device="cuda")`` of a full-width open-set
     DeepLabv2-ResNet-101 over 4 synthetic 2048x1024 images (every head call with uint8
     gt into the one running histogram), then timed again with process workers (its
     histogram against the threads'); the SimT train step of
     ``tools/train_simt.py`` (full-width student and teacher with seeded random
     weights, batch 1, 512x1024 synthetic batches, bf16 autocast); the warmup train
     step of ``tools/train_warmup.py`` (full-width closed-set model, the same inputs).
     Each train path: 2 warm-up steps, then 5 timed steps with CUDA-event times of
     their parts, then 3 profiled steps for the device busy share, then the same step
     with every conv2 on cuDNN (a yardstick the port never calls) timed in turns
     against it; and three full-width warmup steps against conv2 on the plain taps;
     the host input pipeline: a 12-image 2048x1024 fixture, the native preprocessing
     against PIL bit for bit on this machine (2048x1024 -> 1024x512, images and labels),
     ``device_prefetch`` under a consumer slower than the loader (order, content, no
     second copy), then the full-width SimT step fed by ``build_loader`` (4 process
     workers, native preprocessing, ``device_prefetch``), the crop cache off and then
     on: 3 (14 with the cache) warm-up steps, 10 timed with every launch count zeroed
     before and held after to the resident path's per step, 3 profiled steps, the same
     step on those 3 batches with the loader stopped; the first 3 batches that reached
     the step of each run against PIL's decode for the same seed;
     the loader alone, host ms per item, processes and threads, native and PIL;
     the benchmark path of ``tools/bench_fused_bottleneck.py`` at layer3 (the fused
     block against the composed module, 10 calls a chain), and the same module with
     conv2 on cuDNN;
  5. times: per-scale forward (and with conv2 on cuDNN), each kernel against its
     plain version, its bound and, where one exists, a library call computing the
     same function; B1 on the iid, regions and shifted gt maps as the eval path calls
     it and with int32 gt, by the wrapper's time (CUDA events) and its kernel's device
     time (profiler), with every device operation of a call (one, or the run fails;
     ``tools/bench_eval_fused.py``'s timing); B4/B5 at the four trunk geometries by the wrappers' time (CUDA
     events, ``ms``) and their kernels' device time
     (profiler, ``kernel_ms``), cuDNN by the same two clocks, with the tiles, splits
     and waves chosen and the host cost a call (``tools/bench_conv3x3.py``'s timing);
     B6/B7 at the four trunk geometries by the same two clocks with their launches a
     call (7 and 12, or the run fails) and, at layer3, each launch's device time in
     launch order (``tools/bench_fused_bottleneck.py``'s ``time_bneck``);
  6. the loss core's forward and backward (B2/B3) against their plain versions at the
     train path's shapes (xcat 1x65x129x68 -> 512x1024, C 19 + O 15; batch 1, 2 and 16)
     on four label maps (iid per pixel, constant over 16x16 cells on a grid aligned to
     the warps and on one shifted off it, and the inputs one full-width SimT step hands
     the core), at batch 4 of the eval's 1024x2048, with all labels ignored, every pixel
     unknown, a 37x301 output from 6x39 logits and a planted anchor tie across blocks
     and images, each run twice and bitwise equal; then their times on the four maps
     with every device operation of a call (``tools/bench_loss_fused.py``'s timing: one
     each, or the run fails);
  7. the train loop, last (its profiler session and worker processes come after
     every kernel timing): ``train/loop.py::train`` through its entry points, on the
     pipeline fixture's 12 train images and 2 of the eval fixture's val images, with
     every launch count zeroed before and held after each run: the SimT CLI
     (``tools/train_simt.main``, 4 steps from ``build_loader``, the two-scale
     evaluation at step 2, the best and last snapshots, a CSV row a step; B1 1 and B4
     66 an image evaluated, B2/B3/B4/B5 1/1/92/26 a step); a run resumed on the card
     from its step-2 snapshot against the uninterrupted run (losses and parameters
     within 1e-3 relative), the best-snapshot keep/delete sequence, a snapshot's save
     and restore seconds and bytes and its crossing card -> CPU -> card bit for bit;
     the warmup CLI (3 steps, one single-scale evaluation, its snapshots);
     ``python -m simt_tpu_torch.tools.train_simt --profile-dir`` over 2 steps in a
     process of its own, whose trace must name the loss and conv3x3 kernels.

Output, last three lines: {"kernels": [...]}; the card's name and power limit from
nvidia-smi; {"ok": true, "device": {...}}. float32 convolutions and matmuls run without
TF32 (both allow_tf32 flags are set False); the main paths' convolutions run under bf16
autocast.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Tuple
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simt_tpu_torch.config import (ModelConfig, OptimConfig, SimTConfig,  # noqa: E402
                                   TrainConfig)
from simt_tpu_torch.data import device_prefetch, pipeline  # noqa: E402
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch  # noqa: E402
from simt_tpu_torch.eval import evaluate  # noqa: E402
from simt_tpu_torch.models import ResNetMulti, deeplab_multi, init_weights  # noqa: E402
from simt_tpu_torch.models import layers  # noqa: E402
from simt_tpu_torch.ops.bottleneck import fused_bottleneck  # noqa: E402
from simt_tpu_torch.ops.kernels import _build  # noqa: E402
from simt_tpu_torch.ops.kernels import bottleneck, conv3x3, eval_fused, loss_fused  # noqa: E402
from simt_tpu_torch.tools import (bench, bench_fused_bottleneck, train_simt,  # noqa: E402
                                  train_warmup)
from simt_tpu_torch.tools.bench_fused_bottleneck import (BNECK, bneck_calls,  # noqa: E402
                                                         bneck_inputs, time_bneck)
from simt_tpu_torch.tools.bench_conv3x3 import (KERNEL_WORD,  # noqa: E402
                                                checked_launches, conv_calls, cuda_ms,
                                                profile_kernels, profile_steps,
                                                time_conv, time_launches)
from simt_tpu_torch.tools.bench_eval_fused import KERNEL_WORD as HEAD_WORD  # noqa: E402
from simt_tpu_torch.tools.bench_eval_fused import bound as head_bound  # noqa: E402
from simt_tpu_torch.tools.bench_eval_fused import (head_calls, head_inputs,  # noqa: E402
                                                   kernel_arithmetic)
from simt_tpu_torch.tools.bench_loss_fused import (LABEL_MAPS, loss_calls,  # noqa: E402
                                                   loss_inputs, make_maps, step_inputs,
                                                   time_loss)
from simt_tpu_torch.train import (build_loader, checkpoint, create_simt_state,  # noqa: E402
                                  create_warmup_state, loop, make_simt_step,
                                  make_warmup_step)
from simt_tpu_torch.utils import format_simt_line, format_warmup_line  # noqa: E402

eval_module = importlib.import_module("simt_tpu_torch.eval.evaluate")
SEED = 0
C = 19
OUT_HW = (1024, 2048)
LOGIT_HW = ((65, 129), (81, 161))  # stride-8 maps of the 512x1024 and 640x1280 inputs
N_IMAGES = 4
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, bf16 dense tensor-core flop/s.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    for b in built.values():
        print(f"build {b.name}: {b.seconds:.2f} s -> {os.path.relpath(b.path)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {line.strip()}")
    print(f"build total: {time.perf_counter() - t0:.2f} s")


# B1 against its plain version: equal totals, and L1 at most 2e-5 of the pixels (at
# least 2): a near-tie argmax flip moves two counts, and the plain version's matmuls
# round the upsample otherwise than the kernel's fma. Against the kernel's own
# arithmetic (bench_eval_fused.kernel_arithmetic, float32 fma emulated exactly): equal
# bit for bit, as every rerun, every gt width, out= and the row blocks' sum must be.
def phase_kernel_vs_plain(rng: np.random.Generator) -> dict:
    """eval_fused against its plain version and its own arithmetic; returns the worst
    errors seen.

    The main path's shapes on the iid, regions and shifted gt maps (batch 1 and 2;
    warmup's 1x1 zero operand), then edge cases off that path: ragged row and column
    counts, another class count, a single output pixel, and more than 48 KB of shared
    memory (the opt-in launch attribute). Each case with uint8 and int32 gt, twice each,
    and with out= into a running histogram; the main-shape cases also as 4 row blocks of
    256 rows; one case through multiscale_argmax_hist_spatial on a one-rank NCCL group.
    """
    worst = {"max_abs_err": 0, "l1_err": 0, "match": True, "exact": True}
    cases = {"batch1": dict(batch=1), "batch2": dict(batch=2),
             "warmup_zero_1x1": dict(batch=1, hw_b=(1, 1), zero_b=True),
             "edge_ragged_c5": dict(batch=2, hw_a=(7, 13), hw_b=(3, 4), out_hw=(37, 301),
                                    c=5),
             "edge_single_pixel": dict(batch=1, hw_a=(4, 6), hw_b=(1, 1), out_hw=(1, 1)),
             "edge_smem_over_48k": dict(batch=1, hw_a=(9, 400), hw_b=(11, 300),
                                        out_hw=(64, 1000)),
             "regions": dict(batch=1, gt="regions"), "shifted": dict(batch=1, gt="shifted"),
             "regions_batch2": dict(batch=2, gt="regions"),
             "edge_nan_inf": dict(batch=2, hw_a=(7, 13), hw_b=(3, 4), out_hw=(37, 301))}
    # The gt-map cases draw from a generator of their own, so the phases after this one
    # draw from ``rng`` what they drew before those cases were added.
    maps_rng = np.random.default_rng(SEED + 1)
    for name, kw in cases.items():
        la, lb, gt = head_inputs(maps_rng if "gt" in kw or name == "edge_nan_inf" else rng,
                                 **kw)
        if name == "edge_nan_inf":  # NaN, inf and values whose sums overflow
            bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e38], device="cuda")
            for x in (la, lb):
                hit = torch.rand(x.shape, generator=torch.Generator("cuda").manual_seed(SEED),
                                 device="cuda") < 0.02
                x[hit] = bad[torch.arange(int(hit.sum()), device="cuda") % 4]
        out_hw, c = kw.get("out_hw", OUT_HW), kw.get("c", C)
        hw = dict(out_hw=out_hw, num_classes=c)
        exact = kernel_arithmetic(la, lb, gt, **hw)
        want = eval_fused.multiscale_argmax_hist_reference(la, lb, gt, **hw)
        runs = {}
        for dt in (torch.int32, torch.uint8):
            g = gt.to(dt)
            runs[str(dt)[6:]] = [eval_fused.multiscale_argmax_hist(la, lb, g, **hw)
                                 for _ in range(2)]
        running = torch.arange(c * c, dtype=torch.int32, device="cuda").reshape(c, c) * 977
        acc = eval_fused.multiscale_argmax_hist(la, lb, gt.to(torch.uint8), out=running.clone(),
                                                **hw)
        checks = {f"{k} run {i}": torch.equal(h, exact) for k, hs in runs.items()
                  for i, h in enumerate(hs)}
        checks["out="] = torch.equal(acc, running + exact)
        if out_hw == OUT_HW:
            rows = OUT_HW[0] // 4
            parts = [eval_fused.multiscale_argmax_hist(la, lb, gt.to(torch.uint8),
                                                       row_range=(i * rows, rows), **hw)
                     for i in range(4)]
            checks["4 row blocks"] = torch.equal(sum(parts), exact)
        if name == "batch1":
            checks["spatial, one NCCL rank"] = torch.equal(spatial_one_rank(la, lb, gt),
                                                           exact)
        torch.cuda.synchronize()
        got, want = runs["int32"][0].cpu().long(), want.cpu().long()
        counted = int(((gt >= 0) & (gt < c)).sum())
        l1 = int((got - want).abs().sum())
        mx = int((got - want).abs().max())
        limit = max(2.0, 2e-5 * out_hw[0] * out_hw[1] * kw["batch"])
        ok = int(got.sum()) == int(want.sum()) == counted and l1 <= limit
        if name == "edge_nan_inf":
            # The plain version's matmuls spread a NaN or inf over every output the dense
            # row touches (0 * inf), so only the totals compare; the kernel's own
            # arithmetic, held bit for bit below, is the reference here.
            ok = int(got.sum()) == int(want.sum()) == counted
        same = all(checks.values())
        print(f"eval_fused vs plain [{name}]: total {int(got.sum())}/{int(want.sum())} "
              f"(counted {counted}), L1 {l1} (limit {limit:.0f}), max abs {mx}: "
              f"{'ok' if ok else 'MISMATCH'}; equal to its own arithmetic bit for bit: "
              + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in checks.items()))
        if name != "edge_nan_inf":
            worst["max_abs_err"] = max(worst["max_abs_err"], mx)
            worst["l1_err"] = max(worst["l1_err"], l1)
        worst["match"] = worst["match"] and ok
        worst["exact"] = worst["exact"] and same
    if not worst["match"]:
        fail("eval_fused kernel disagrees with its plain version")
    if not worst["exact"]:
        fail("eval_fused kernel differs from its own arithmetic, between reruns, gt "
             "widths, out= or row blocks")
    return worst


def spatial_one_rank(la, lb, gt) -> torch.Tensor:
    """multiscale_argmax_hist_spatial through a one-rank NCCL group on this card."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        hist = eval_fused.multiscale_argmax_hist_spatial(la, lb, gt, out_hw=OUT_HW,
                                                         num_classes=C)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return hist


def phase_small_reference(tmp: str) -> None:
    """The whole evaluation on the card vs the same weights on the CPU (float32)."""
    paths = make_cityscapes_fixture(os.path.join(tmp, "small"), n_train=0, n_val=3,
                                    image_wh=(64, 32), seed=SEED)
    kw = dict(data_root=paths["root"], val_list=paths["val_txt"], gt_dir=paths["gt_dir"],
              scales=((32, 16), (40, 20)), out_hw=(32, 64), return_hist=True,
              print_fn=lambda s: None)
    model = init_weights(ResNetMulti(C, 3, True, layers=(1, 1, 1, 1), dtype=torch.float32),
                         torch.Generator().manual_seed(SEED))
    _, want = evaluate(model, device="cpu", **kw)
    _, got = evaluate(model, device="cuda", **kw)
    l1 = float(np.abs(got - want).sum())
    ok = got.sum() == want.sum() == 3 * 32 * 64 and l1 <= 0.01 * want.sum()
    print(f"small-input evaluate cuda vs cpu: totals {got.sum():.0f}/{want.sum():.0f}, "
          f"L1 {l1:.0f} (limit 1%): {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("evaluate on the card disagrees with the CPU on the small input")


def phase_main_path(tmp: str, model: torch.nn.Module):
    t0 = time.perf_counter()
    paths = make_cityscapes_fixture(os.path.join(tmp, "full"), n_train=0, n_val=N_IMAGES,
                                    image_wh=(OUT_HW[1], OUT_HW[0]), seed=SEED)
    print(f"fixture: {N_IMAGES} val images at {OUT_HW[1]}x{OUT_HW[0]} in "
          f"{time.perf_counter() - t0:.1f} s")
    kw = dict(data_root=paths["root"], val_list=paths["val_txt"], gt_dir=paths["gt_dir"],
              mode="simt", return_hist=True, device="cuda", print_fn=lambda s: None)
    evaluate(model, **kw)  # warm-up: cuDNN plans, allocator
    lines, heads, first = [], [], []
    head = eval_module.multiscale_argmax_hist

    def record(a, b, gt, **hkw):  # what evaluate hands the head, checked below
        heads.append((gt.dtype, hkw.get("out"), hkw.get("row_range")))
        if not first:
            first.append((a.clone(), b.clone(), gt.clone(), hkw))
        return head(a, b, gt, **hkw)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(eval_module, "multiscale_argmax_hist", record):
        miou, hist = evaluate(model, **dict(kw, print_fn=lines.append))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variants = read_counts(), read_variants()
    print(lines[-1])
    print(f"main path: evaluate(simt, two scales, {OUT_HW[0]}x{OUT_HW[1]}) over "
          f"{N_IMAGES} images: {seconds:.3f} s, {N_IMAGES / seconds:.3f} img/s, "
          f"mIoU {miou}")
    # One B1 a image; two scales a image, one B4 forward for each of the 33 bottlenecks.
    check_counts("eval", launches, {"multiscale_argmax_hist": N_IMAGES,
                                    "conv3x3_fwd": 2 * N_CONV2 * N_IMAGES})
    check_wgmma("eval", variants)
    # One device operation an image for the head: every call adds into the one running
    # histogram (no fill, no add) with uint8 gt, and that call, replayed on the first
    # image's inputs under the profiler, is its kernel alone.
    outs = {id(out) for _, out, _ in heads}
    a, b, gt, hkw = first[0]
    scratch = torch.zeros_like(hkw["out"])
    seq = checked_launches(lambda: head(a, b, gt, **dict(hkw, out=scratch)), 5)["seq"]
    print(f"eval head calls: {len(heads)}, gt {sorted({str(d) for d, _, _ in heads})}, "
          f"into {len(outs)} running histogram(s); device operations of one call: "
          f"{[n for n, _ in seq]}")
    if (len(heads) != N_IMAGES or len(outs) != 1 or any(o is None for _, o, _ in heads)
            or any(d != torch.uint8 or r is not None for d, _, r in heads)):
        fail(f"eval head: {heads} (want {N_IMAGES} uint8 calls into one running histogram)")
    if len(seq) != 1 or HEAD_WORD not in seq[0][0]:
        fail(f"eval head: device operations of one call {seq}, want its kernel alone")
    if hist.sum() != N_IMAGES * OUT_HW[0] * OUT_HW[1] or not math.isfinite(miou):
        fail(f"main path histogram total {hist.sum()} or mIoU {miou} is wrong")
    # The same evaluation with process workers (two loaders of 4, spawned in the call).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist_p = evaluate(model, **dict(kw, process_workers=True))
    torch.cuda.synchronize()
    seconds_p = time.perf_counter() - t0
    l1 = float(np.abs(hist_p - hist).sum())
    print(f"main path, process workers: evaluate(simt) over {N_IMAGES} images: "
          f"{seconds_p:.3f} s, {N_IMAGES / seconds_p:.3f} img/s, starting 8 worker "
          f"processes included (threads: {seconds:.3f} s, {N_IMAGES / seconds:.3f} img/s); "
          f"histogram L1 against the threads' {l1:.0f} (limit 1% of "
          f"{N_IMAGES * OUT_HW[0] * OUT_HW[1]})")
    if hist_p.sum() != hist.sum() or l1 > 0.01 * hist.sum():
        fail(f"eval with process workers disagrees with threads: L1 {l1}")
    return launches, seconds, variants


def phase_forward_times(model: torch.nn.Module) -> list:
    gen = torch.Generator().manual_seed(SEED)
    times = []
    for (h8, w8), (w, h) in zip(LOGIT_HW, ((1024, 512), (1280, 640))):
        x = (torch.randn(1, 3, h, w, generator=gen) * 50).cuda()
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            x1, x2 = model(x)
            ms = cuda_ms(lambda: model(x), iters=10)
            with conv2_through(cudnn_conv2):
                cudnn_ms = cuda_ms(lambda: model(x), iters=10)
        for out in (x1, x2):
            if out.shape != (1, C + 15, h8, w8) or not torch.isfinite(out).all():
                fail(f"forward at {w}x{h}: shape {tuple(out.shape)} or non-finite values")
        print(f"forward {w}x{h} (bf16 autocast, channels_last): {ms:.3f} ms (conv2 "
              f"through cuDNN instead, yardstick: {cudnn_ms:.3f} ms)")
        times.append(ms)
    return times


def phase_kernel_times(launches: dict, worst: dict) -> dict:
    """B1 on the iid, regions and shifted gt maps (``bench_eval_fused.head_inputs`` from
    SEED), as the eval path calls it (uint8 gt, ``out=`` the running histogram) and with
    int32 gt, timed by ``bench_conv3x3.time_launches``: ``ms`` the wrapper back to back
    (CUDA events), ``kernel_ms`` its kernel (profiler, held to the events' device time),
    every device operation of one call (one, its kernel, or the run fails), host us. The
    bound from ``work()`` with each map's counted pixels and gt width; the plain version
    and one library chain (interpolate, argmax, bincount) on iid."""
    maps = {m: head_inputs(np.random.default_rng(SEED), gt=m)
            for m in ("iid", "regions", "shifted")}
    by_gt = {}
    for m, (la, lb, gt) in maps.items():
        by_gt[m] = time_launches(head_calls(eval_fused, la, lb, gt), HEAD_WORD)
        for form, r in by_gt[m].items():
            r.update(head_bound(gt, gt.to(getattr(torch, form)).element_size()))
            print(f"multiscale_argmax_hist [{m}, {form} gt, out=]: wrapper {r['ms']:.4f} ms, "
                  f"kernel {r['kernel_ms']:.4f} ms, {r['device_ops']} device operation(s) a "
                  "call: " + "; ".join(f"{n} {ms:.4f}" for n, ms in r["per_launch"])
                  + f"; host {r['host_us']:.1f} us; bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}; events {r['busy_ms']:.4f} ms, {r['readings']} profiler "
                  f"reading(s), kernel ms by {r['kernel_ms_by']}")
            if r["launches"] != 1 or r["device_ops"] != 1:
                fail(f"multiscale_argmax_hist [{m}, {form}]: {r['device_ops']} device "
                     f"operations a call ({r['launches']} of its kernel), want its kernel "
                     "alone")
    la, lb, gt = maps["iid"]
    plain_ms = cuda_ms(lambda: eval_fused.multiscale_argmax_hist_reference(
        la, lb, gt, out_hw=OUT_HW, num_classes=C), iters=20)
    la_nchw = la.permute(0, 3, 1, 2).contiguous()
    lb_nchw = lb.permute(0, 3, 1, 2).contiguous()

    def library():
        up = F.interpolate(la_nchw, size=OUT_HW, mode="bilinear", align_corners=True)
        up = up + F.interpolate(lb_nchw, size=OUT_HW, mode="bilinear", align_corners=True)
        pred = up.argmax(1).reshape(-1)
        g = gt.reshape(-1)
        k = (g >= 0) & (g < C)
        return torch.bincount(C * g[k] + pred[k], minlength=C * C)

    library_ms = cuda_ms(library, iters=20)
    main = by_gt["iid"]["uint8"]
    keys = ("ms", "kernel_ms", "kernel_ms_by", "busy_ms", "device_ops", "host_us",
            "bound_ms", "counted")
    return {
        "name": "multiscale_argmax_hist", "route": "cuda",
        "source": "simt_tpu_torch/csrc/eval_fused.cu",
        "replaces": "simt_tpu/ops/pallas/eval_fused.py:35",
        "launches": launches["multiscale_argmax_hist"],
        "max_abs_err": worst["max_abs_err"], "l1_err": worst["l1_err"],
        "match": worst["match"], "exact": worst["exact"],
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "kernel_ms_by": main["kernel_ms_by"], "device_ops": main["device_ops"],
        "host_us": main["host_us"], "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": library_ms,
        "bytes": main["bytes"], "ops": main["ops"],
        "by_gt": {m: {form: {k: r[k] for k in keys} for form, r in t.items()}
                  for m, t in by_gt.items()},
        "shape": "la 1x65x129x19 f32, lb 1x81x161x19 f32, gt 1x1024x2048 u8 -> 19x19 i32 "
                 "(accumulated in place)",
    }


# ---------------------------------------------------------------------------------
# The SimT train path: loss core kernels B2/B3, the small-step check, the main path
# ---------------------------------------------------------------------------------

O = 15
TRAIN_HW = (512, 1024)
TRAIN_LOGIT_HW = (65, 129)  # stride-8 map of a 512x1024 crop
TIMED_STEPS = 5
# Tolerances of the loss core against its plain version. Counts, anchor indices, anchor
# maxima and presence must be equal: the plain version computes every upsampled logit,
# softmax denominator, reciprocal and picked posterior with the kernel's operations in
# its order. The sums differ in summation order only (float32 over up to 1M pixels):
# 1e-5 relative. dT sums the same terms in another order (per warp, label group by label
# group, then the warps, blocks and block groups in a fixed order, where the plain
# version adds pixel by pixel): 1e-4 of max|dT|. dxcat: 1e-5 of max|dxcat|. Every
# output of both kernels must be bitwise equal across two runs.
TOL_SUMS, TOL_DT, TOL_DX = 1e-5, 1e-4, 1e-5


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def phase_loss_kernels_vs_plain(rng: np.random.Generator) -> dict:
    """B2/B3 against loss_core_fwd_reference / loss_core_bwd_reference on the card: the
    main path's shapes on the iid, regions, shifted and step label maps
    (``bench_loss_fused``'s inputs; the step's own sums cotangent), batches 2 and 16,
    batch 4 at 1024x2048 (more than one wave of bands; one block an SM) and edge cases;
    each kernel run twice and bitwise equal."""
    h8, w8 = TRAIN_LOGIT_HW
    hh, ww = TRAIN_HW
    cases = {"batch1": dict(batch=1), "regions": dict(batch=1, labels="regions"),
             "shifted": dict(batch=1, labels="shifted"),
             "step": dict(batch=1, step=True), "batch2": dict(batch=2),
             "batch16": dict(batch=16),
             "batch4_1024x2048": dict(batch=4, h8=129, w8=257, hh=1024, ww=2048),
             "all_ignored": dict(batch=1, labels=255),
             "all_unknown": dict(batch=1, conf=C),
             "edge_37x301_from_6x39": dict(batch=2, h8=6, w8=39, hh=37, ww=301),
             "anchor_tie_across_blocks": dict(batch=2, tie=True)}
    worst = {"match": True, "cases": {}}
    for name, kw in cases.items():
        shape = dict(batch=kw["batch"], h8=kw.get("h8", h8), w8=kw.get("w8", w8),
                     hh=kw.get("hh", hh), ww=kw.get("ww", ww))
        if kw.get("step"):
            xcat, label, conf, t1, t2, g = step_inputs(SEED)
        else:
            labels = kw.get("labels")
            xcat, label, conf, t1, t2 = loss_inputs(
                rng, **shape, labels=labels if isinstance(labels, str) else "iid")
            g = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).cuda()
        if isinstance(kw.get("labels"), int):
            label.fill_(kw["labels"])
        if "conf" in kw:
            conf.fill_(kw["conf"])
        want_idx = None
        if kw.get("tie"):
            # One value, larger than any other logit, at three pixels that land on the
            # output grid exactly: image 0 row H-1 column 0, image 0's last pixel and
            # image 1's first pixel (head 1, channel 3), in different row blocks and
            # images. The first in global batch-major order is image 0's row H-1.
            for bi, i, j in ((0, -1, 0), (0, -1, -1), (1, 0, 0)):
                xcat[bi, i, j, 3] = 40.0
            want_idx = (shape["hh"] - 1) * shape["ww"]
        kwc = dict(num_classes=C, threshold_high=0.8)
        got, again = (loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kwc)
                      for _ in range(2))
        want = loss_fused.loss_core_fwd_reference(xcat, label, conf, t1, t2, **kwc)
        dgot, dagain = (loss_fused.loss_core_bwd(g, xcat, label, conf, t1, t2, **kwc)
                        for _ in range(2))
        dwant = loss_fused.loss_core_bwd_reference(g, xcat, label, conf, t1, t2, **kwc)
        torch.cuda.synchronize()
        sums, sums_ref = got[0], want[0]
        err = {
            "sums_rel": float(((sums - sums_ref).abs()
                               / sums_ref.abs().clamp(min=1e-30)).max()),
            "sums_max_abs": float((sums - sums_ref).abs().max()),
            "dt1_rel": _rel(dgot[1], dwant[1]), "dt2_rel": _rel(dgot[2], dwant[2]),
            "dx_rel": _rel(dgot[0], dwant[0]),
            "dx_max_abs": float((dgot[0] - dwant[0]).abs().max()),
        }
        exact = (torch.equal(sums[:, 1::2], sums_ref[:, 1::2])
                 and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                 and torch.equal(got[3], want[3]))
        rerun = (all(torch.equal(a, b) for a, b in zip(got, again))
                 and all(torch.equal(a, b) for a, b in zip(dgot, dagain)))
        ok = (exact and rerun and err["sums_rel"] <= TOL_SUMS and err["dt1_rel"] <= TOL_DT
              and err["dt2_rel"] <= TOL_DT and err["dx_rel"] <= TOL_DX
              and bool(torch.isfinite(dgot[0]).all()))
        if want_idx is not None:
            ok = ok and int(got[2][0, 3]) == want_idx and float(got[1][0, 3]) == 40.0
        print(f"loss_core vs plain [{name}] {shape}: counts/anchor/presence "
              f"{'equal' if exact else 'DIFFER'}, sums rel {err['sums_rel']:.3e}, "
              f"dT1 {err['dt1_rel']:.3e}, dT2 {err['dt2_rel']:.3e}, dxcat "
              f"{err['dx_rel']:.3e} of max; reruns {'bitwise equal' if rerun else 'DIFFER'}"
              f": {'ok' if ok else 'MISMATCH'}")
        worst["cases"][name] = err
        worst["match"] = worst["match"] and ok
    if not worst["match"]:
        fail("loss_core kernels disagree with their plain versions or between runs")
    return worst


def golden_config(tmp: str) -> TrainConfig:
    """tests/test_golden_metrics.py's geometry: C5+O3, uniform prior, 3 inner steps."""
    c, o = 5, 3
    cd = os.path.join(tmp, "cd_golden.npy")
    np.save(cd, (np.ones(c) / c).astype(np.float32))
    return TrainConfig(model=ModelConfig(num_classes=c, open_classes=o,
                                         compute_dtype="float32"),
                       optim=OptimConfig(num_steps=1000),
                       simt=dataclasses.replace(SimTConfig(), class_dist=cd,
                                                inner_w_steps=3))


def phase_small_steps(tmp: str) -> None:
    """Three whole SimT steps on the card against the same steps on the CPU (float32,
    TF32 off). Tolerances: the losses rel 1e-3 / abs 1e-4 (cuDNN and the CPU sum
    convolutions in other orders); T1/T2 after the steps atol 1e-4, 4% of one Adam
    step at lr_T 2.5e-3."""
    cfg = golden_config(tmp)
    c, o = cfg.model.num_classes, cfg.model.open_classes
    student = init_weights(ResNetMulti(c, o, True, layers=(1, 1, 1, 1),
                                       dtype=torch.float32),
                           torch.Generator().manual_seed(SEED))
    teacher = init_weights(ResNetMulti(c, 0, False, layers=(1, 1, 1, 1),
                                       dtype=torch.float32),
                           torch.Generator().manual_seed(SEED + 1))
    batch = synthetic_batch(1, (32, 64), c, seed=SEED)
    out = {}
    for dev in ("cpu", "cuda"):
        st = create_simt_state(copy.deepcopy(student), copy.deepcopy(teacher), cfg,
                               torch.Generator().manual_seed(SEED + 2), dev)
        step = make_simt_step(cfg)
        losses = [{k: float(v) for k, v in step(st, batch).items()} for _ in range(3)]
        out[dev] = (losses, st.t1.param.detach().cpu(), st.t2.param.detach().cpu())
    ok = True
    for i, (lc, lg) in enumerate(zip(out["cpu"][0], out["cuda"][0])):
        for k in ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor",
                  "place"):
            ok = ok and math.isfinite(lg[k]) and abs(lg[k] - lc[k]) <= max(
                1e-4, 1e-3 * abs(lc[k]))
        print(f"small step {i}: loss cuda {lg['loss']:.6f} cpu {lc['loss']:.6f}, "
              f"anchor {lg['anchor']:.6f}/{lc['anchor']:.6f}")
    dt = max(float((out["cuda"][j] - out["cpu"][j]).abs().max()) for j in (1, 2))
    ok = ok and dt <= 1e-4
    print(f"small steps cuda vs cpu: T1/T2 max abs diff {dt:.3e} (limit 1e-4): "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the SimT step on the card disagrees with the CPU at the golden geometry")


def simt_main_setup(tmp: str):
    """The full-width SimT config, state and step through the CLI's own calls (a
    uniform class prior, as the CLI's synthetic mode)."""
    args = train_simt.build_parser().parse_args(
        ["--synthetic", "--preset", "simt_bapa_lr25",
         "--num-steps-stop", str(2 + TIMED_STEPS)])
    cfg = train_simt.build_config(args)
    cd = os.path.join(tmp, "cd_uniform.npy")
    np.save(cd, (np.ones(C) / C).astype(np.float32))
    cfg = cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=cd))
    student, teacher = loop.build_models(cfg)
    state = create_simt_state(student, teacher, cfg,
                              torch.Generator().manual_seed(cfg.random_seed + 2), "cuda")
    return cfg, state, make_simt_step(cfg)


def phase_train_main_path(tmp: str) -> dict:
    """The SimT step at full width through the CLI's own calls."""
    t0 = time.perf_counter()
    cfg, state, step = simt_main_setup(tmp)
    batches = train_simt.synthetic_batches(cfg, cfg.num_steps_stop, torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"train set-up (models, state, {len(batches)} synthetic 512x1024 batches): "
          f"{time.perf_counter() - t0:.1f} s")
    want = TIMED_STEPS * cfg.optim.iter_size
    # One B2 and one B3 a sub-batch. Student and teacher forwards (33 each); the input
    # gradient and the weight gradient of the trained blocks only (layers 3-4: 26;
    # layers 1-2 are frozen in this stage).
    return drive_train_path(
        "SimT", step, state, batches,
        lambda i, v: format_simt_line(i, cfg.num_steps, v)
        + f" loss = {v['loss']:.4f}",
        {"loss_core_fwd": want, "loss_core_bwd": want,
         "conv3x3_fwd": (2 * N_CONV2 + N_CONV2_L34) * want,
         "conv3x3_wgrad": N_CONV2_L34 * want})


# ---------------------------------------------------------------------------------
# The host input pipeline: the SimT step fed from PNGs on disk by build_loader
# ---------------------------------------------------------------------------------

PIPE_STEPS = 10  # timed pipeline steps a run (crop cache off, then on)
PIPE_RECORDED = 3  # the first batches that reached the step, held to PIL's decode
LOADER_ITEMS = 24  # items the loader is timed over alone


def check_native_vs_pil(paths: dict) -> None:
    """The native library against PIL, bit for bit, on this machine's Pillow: the
    fixture's first image and label, 2048x1024 -> 1024x512 (as the loader decodes them,
    with and without the mirror), and the raw resizes."""
    import PIL
    from PIL import Image

    from simt_tpu_torch.data import _native_preproc

    with open(paths["pseudo_lst"]) as f:
        img_rel, lab_rel = f.readline().split()
    img, lab = (os.path.join(paths["root"], r) for r in (img_rel, lab_rel))
    crop = (TRAIN_HW[1], TRAIN_HW[0])
    out = {}
    for use in (True, False):
        pipeline.USE_NATIVE = use
        out[use] = ([pipeline.load_image_bgr_u8(img, crop, mirror=m) for m in (False, True)]
                    + [pipeline.load_label(lab, crop)])
    pipeline.USE_NATIVE = True
    rgb = np.asarray(Image.open(img).convert("RGB"))
    raw = np.asarray(Image.open(lab))
    pairs = out[True] + [_native_preproc.resize_bicubic(rgb, *TRAIN_HW),
                         _native_preproc.resize_nearest(raw, *TRAIN_HW)]
    want = out[False] + [np.asarray(Image.fromarray(rgb).resize(crop, Image.BICUBIC)),
                         np.asarray(Image.fromarray(raw).resize(crop, Image.NEAREST))]
    equal = [bool(a.shape == b.shape and np.array_equal(a, b)) for a, b in zip(pairs, want)]
    print(f"native vs PIL (Pillow {PIL.__version__}) at {rgb.shape[1]}x{rgb.shape[0]} -> "
          f"{crop[0]}x{crop[1]}, image / mirrored image / label / bicubic / nearest "
          f"equal bit for bit: {equal}")
    if not all(equal):
        fail("native preprocessing differs from PIL on this machine")


def check_prefetch_slow_consumer() -> None:
    """``device_prefetch`` under a consumer slower than the loader: 8 distinct 512x1024
    batches, each read on the card only after a spin kernel of ~5 ms on the consuming
    stream, must arrive in order with their own bytes; a placed tensor is not copied
    again by ``torch.as_tensor``."""
    rng = np.random.default_rng(SEED)
    host = [rng.integers(0, 256, (1, *TRAIN_HW, 3), dtype=np.uint8) for _ in range(8)]
    source = ({"image": h, "name": [str(i)]} for i, h in enumerate(host))
    ok, sums = True, []
    for i, b in enumerate(device_prefetch(source, size=2, device="cuda")):
        # No host sync in the loop: each batch's memory is freed while the spin and the
        # sum that read it are still queued, and the copies of later batches run.
        torch.cuda._sleep(10_000_000)
        sums.append((b["image"].to(torch.int64) * torch.arange(
            3, device="cuda").add(1)).sum())
        ok = ok and b["name"] == [str(i)] and (
            torch.as_tensor(b["image"], device="cuda") is b["image"])
    want = [int((h.astype(np.int64) * np.arange(1, 4)).sum()) for h in host]
    ok = ok and [int(x) for x in sums] == want
    print(f"device_prefetch, consumer slower than the loader: 8 batches in order, "
          f"checksums equal, no second copy: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("device_prefetch lost the order or the content of its batches")


def loader_alone(cfg) -> dict:
    """The loader's host ms per item alone, threads against processes and native
    against PIL (``bench.loader_ms_per_item``)."""
    out = {}
    for procs in (True, False):
        for native in (True, False):
            c = cfg.replace(data=dataclasses.replace(
                cfg.data, process_workers=procs, use_native_preproc=native))
            first, per_item = bench.loader_ms_per_item(c, LOADER_ITEMS)
            key = f"{'processes' if procs else 'threads'}/{'native' if native else 'PIL'}"
            out[key] = per_item
            print(f"loader alone, {cfg.data.num_workers} {key}: first batch {first:.3f} s, "
                  f"{per_item:.3f} host ms per item over {LOADER_ITEMS} items")
    pipeline.USE_NATIVE = True
    return out


def phase_pipeline(tmp: str, resident: dict) -> dict:
    """The SimT step at full width fed from PNGs on disk: a 12-image 2048x1024 fixture,
    ``build_loader`` with process workers, native preprocessing and ``device_prefetch``,
    the crop cache off and then on. Holds the first batches that reached the step to
    PIL's decode for the same seed, and the B2/B3/B4/B5 launches a step to the resident
    path's."""
    t0 = time.perf_counter()
    paths = make_cityscapes_fixture(os.path.join(tmp, "pipeline"), n_train=12, n_val=0,
                                    image_wh=(OUT_HW[1], OUT_HW[0]), seed=SEED)
    print(f"pipeline fixture: 12 images and pseudo-labels at {OUT_HW[1]}x{OUT_HW[0]} in "
          f"{time.perf_counter() - t0:.1f} s")
    check_native_vs_pil(paths)
    check_prefetch_slow_consumer()
    cfg, state, step = simt_main_setup(tmp)
    per_step = {k: v // TIMED_STEPS for k, v in resident["launches"].items()}
    recorded = {False: [], True: []}
    out = {}
    for cache in (False, True):

        def recording_step(st, batch):
            if len(recorded[cache]) < PIPE_RECORDED:
                recorded[cache].append({k: (v.cpu() if torch.is_tensor(v) else v)
                                        for k, v in batch.items()})
            return step(st, batch)

        pcfg = bench.pipeline_config(cfg, paths["root"], paths["pseudo_lst"], TRAIN_HW,
                                     os.path.join(tmp, "crop_cache") if cache else "")
        name = "crop cache " + ("on" if cache else "off")
        t0 = time.perf_counter()
        batches = build_loader(pcfg, device="cuda")
        try:
            warm = 14 if cache else 3  # with the cache, epoch 1 (12 items) fills it
            for _ in range(warm):
                m = recording_step(state, next(batches))
            float(m["loss"])
            print(f"pipeline ({name}): {warm} warm-up steps in "
                  f"{time.perf_counter() - t0:.1f} s, worker start-up included")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PIPE_STEPS):
                m = step(state, next(batches))
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / PIPE_STEPS * 1e3
            launches = read_counts()
            if not math.isfinite(float(m["loss"])):
                fail(f"pipeline ({name}): non-finite loss {float(m['loss'])}")
            check_counts(f"pipeline ({name})", launches,
                         {k: v * PIPE_STEPS for k, v in per_step.items()})
            drawn = [next(batches) for _ in range(3)]
            device_ms = profile_steps(step, state, drawn, report=False)
        finally:
            batches.close()
        # The same step on batches drawn from the pipeline, with the loader stopped: what
        # running the loader beside the step costs the step.
        drawn_ms, _ = timed_steps(step, state, drawn, n=PIPE_STEPS)
        print(f"main path: SimT step from build_loader ({name}; {pcfg.data.num_workers} "
              f"process workers, native preprocessing, device_prefetch), full width, batch "
              f"1, 512x1024: {PIPE_STEPS} steps, {wall_ms:.3f} ms per step, "
              f"{1e3 / wall_ms:.3f} steps/s (resident batch: {resident['wall_ms']:.3f} ms, "
              f"{1e3 / resident['wall_ms']:.3f} steps/s; 3 uint8 batches drawn from the "
              f"pipeline, loader stopped: {drawn_ms:.3f} ms); device {device_ms:.3f} ms per "
              f"step (profiler), busy share {device_ms / wall_ms:.3f}; last loss "
              f"{float(m['loss']):.4f}")
        out[name] = {"wall_ms": wall_ms, "device_ms": device_ms, "launches": launches,
                     "drawn_ms": drawn_ms}

    # The first batches that reached the step, against the PIL plain path's decode.
    plain = cfg.replace(data=dataclasses.replace(
        bench.pipeline_config(cfg, paths["root"], paths["pseudo_lst"], TRAIN_HW).data,
        use_native_preproc=False, process_workers=False))
    it = build_loader(plain, device="cpu")
    want = [next(it) for _ in range(PIPE_RECORDED)]
    it.close()
    pipeline.USE_NATIVE = True
    ok = True
    for cache, got in recorded.items():
        ok = ok and len(got) == PIPE_RECORDED and all(
            g["name"] == w["name"] and g["mirror"] == w["mirror"]
            and g["image"].dtype == w["image"].dtype == torch.uint8
            and torch.equal(g["image"], w["image"]) and torch.equal(g["label"], w["label"])
            for g, w in zip(got, want))
    print(f"pipeline: first {PIPE_RECORDED} batches at the step, crop cache off and on "
          f"({[r['name'] for r in recorded[False]]}, mirror "
          f"{[r['mirror'] for r in recorded[False]]}), equal to PIL's decode for the same "
          f"seed: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the batches that reached the step differ from the plain path's decode")
    out["loader_ms"] = loader_alone(bench.pipeline_config(cfg, paths["root"],
                                                          paths["pseudo_lst"], TRAIN_HW))
    del state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------------
# The train loop: the CLIs through train(), evaluation in the loop, snapshots, resume
# ---------------------------------------------------------------------------------

LOOP_STEPS = 4  # SimT CLI steps (eval at step 2) and the resume comparison's length
LOOP_VAL = 2  # val images evaluated in the loop
TOL_RESUME = 1e-3  # resumed vs uninterrupted: losses and parameters, relative


def loop_fixture(tmp: str) -> dict:
    """The pipeline phase's 12 train images and pseudo-labels with the first
    ``LOOP_VAL`` val images and gt of the main eval path's fixture, all at 2048x1024,
    joined under one root by symbolic links (nothing is written again)."""
    root = os.path.join(tmp, "loop")
    os.makedirs(os.path.join(root, "lists"), exist_ok=True)
    for sub, src in (("train", "pipeline"), ("pseudo", "pipeline"), ("val", "full"),
                     ("label", "full")):
        os.symlink(os.path.join(tmp, src, sub), os.path.join(root, sub))
    with open(os.path.join(tmp, "full", "lists", "val.txt")) as f:
        names = [n.strip() for n in f if n.strip()][:LOOP_VAL]
    val_txt = os.path.join(root, "lists", "val.txt")
    with open(val_txt, "w") as f:
        f.write("\n".join(names) + "\n")
    return {"root": root, "pseudo_lst": os.path.join(tmp, "pipeline", "lists",
                                                     "pseudo.lst"),
            "val_txt": val_txt, "gt_dir": os.path.join(root, "label")}


def _loop_counts(steps: int, images: int, stage: str = "simt") -> dict:
    """The launches ``steps`` train steps and an evaluation of ``images`` make."""
    if stage == "simt":  # two scales an image
        return {"loss_core_fwd": steps, "loss_core_bwd": steps,
                "conv3x3_fwd": (2 * N_CONV2 + N_CONV2_L34) * steps + 2 * N_CONV2 * images,
                "conv3x3_wgrad": N_CONV2_L34 * steps, "multiscale_argmax_hist": images}
    return {"conv3x3_fwd": 2 * N_CONV2 * steps + N_CONV2 * images,  # one scale
            "conv3x3_wgrad": N_CONV2 * steps, "multiscale_argmax_hist": images}


def _snapshots(d: str) -> list:
    return sorted(n for n in os.listdir(d) if n.startswith("step_"))


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


def _state_tensors(st) -> dict:
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    out.update({k: getattr(st, k).param.detach() for k in ("t1", "t2", "w1", "w2")})
    return out


def phase_train_loop(tmp: str, smi: str, resident: dict) -> dict:
    """``train()`` at full width through its entry points: the SimT CLI from PNGs on
    disk with the two-scale evaluation at step 2, the best and last snapshots and the
    CSV; the resume on the card against the uninterrupted run, snapshot save/restore
    times and bytes, a snapshot crossing between the card and the CPU, the
    keep/delete sequence; the warmup CLI; ``--profile-dir``."""
    paths = loop_fixture(tmp)
    data = ["--data-dir-target", paths["root"], "--data-list-target", paths["pseudo_lst"],
            "--gt-dir", paths["gt_dir"], "--val-list", paths["val_txt"], "--log-every", "1"]
    out = {}

    # 1. The SimT CLI in this process (4 process workers, native preprocessing).
    snaps, csv_path = os.path.join(tmp, "loop_snaps"), os.path.join(tmp, "loop.csv")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    summary = train_simt.main(data + [
        "--preset", "simt_bapa_lr25", "--num-steps-stop", str(LOOP_STEPS),
        "--save-pred-every", "2", "--snapshot-dir", snaps, "--csv", csv_path])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()[1:]
    print(f"train loop, train_simt CLI ({LOOP_STEPS} steps from build_loader, eval at step "
          f"2 over {LOOP_VAL} 2048x1024 images on the two-scale protocol): {cli_s:.1f} s "
          f"with set-up; StepTimer {summary['steps_per_sec']:.3f} steps/s (eval and "
          f"snapshot inside; resident step {1e3 / resident['wall_ms']:.3f} steps/s); "
          f"in-loop eval {summary['eval_seconds']} s; best mIoU {summary['best_miou']} at "
          f"step {summary['best_step']}; snapshots {_snapshots(snaps)}; CSV rows "
          f"{len(rows)}; peak device memory {peak:.2f} GiB [{smi}]")
    check_counts("train loop (CLI)", launches, _loop_counts(LOOP_STEPS, LOOP_VAL))
    eval_b4 = 2 * N_CONV2 * LOOP_VAL  # held by check_counts above
    print(f"train loop launches a step: {launches['loss_core_fwd'] / LOOP_STEPS:.0f} B2, "
          f"{launches['loss_core_bwd'] / LOOP_STEPS:.0f} B3, "
          f"{(launches['conv3x3_fwd'] - eval_b4) / LOOP_STEPS:.0f} B4, "
          f"{launches['conv3x3_wgrad'] / LOOP_STEPS:.0f} B5; an image evaluated: B1 "
          f"{launches['multiscale_argmax_hist'] / LOOP_VAL:.0f}, B4 "
          f"{eval_b4 / LOOP_VAL:.0f}")
    if (summary["best_step"] != 2 or not math.isfinite(summary["best_miou"])
            or len(summary["eval_seconds"]) != 1
            or _snapshots(snaps) != ["step_00000002", f"step_{LOOP_STEPS:08d}"]
            or len(rows) != LOOP_STEPS
            or not all(math.isfinite(v) for v in summary["final_metrics"].values())):
        fail(f"train loop (CLI): summary {summary['best_step']}/{summary['best_miou']}/"
             f"{summary['eval_seconds']}, snapshots {_snapshots(snaps)}, {len(rows)} rows")
    out.update(cli_steps_per_sec=summary["steps_per_sec"], eval_s=summary["eval_seconds"][0],
               peak_gib=peak, launches=launches)
    del summary
    shutil.rmtree(snaps)

    # 2. Resume on the card, from a resident batch repeated every step.
    cfg = train_simt.build_config(train_simt.build_parser().parse_args(
        ["--preset", "simt_bapa_lr25", "--log-every", "1"]))
    batch = train_simt.synthetic_batches(cfg, 1, torch.device("cuda"))[0]

    def repeat():
        while True:
            yield batch

    scores = iter(range(1, 100))
    a_dir, b_dir = os.path.join(tmp, "loop_a"), os.path.join(tmp, "loop_b")
    quiet = lambda s: None  # noqa: E731
    whole = loop.train(cfg.replace(num_steps_stop=LOOP_STEPS, snapshot_dir=a_dir,
                                   save_pred_every=1),
                       batch_iter=repeat(), eval_fn=lambda m: float(next(scores)),
                       csv_path=os.path.join(tmp, "a.csv"), print_fn=quiet)
    keep = _snapshots(a_dir)
    loop.train(cfg.replace(num_steps_stop=LOOP_STEPS, snapshot_dir=b_dir),
               batch_iter=repeat(), max_steps=2, print_fn=quiet)
    reset_counts()
    resumed = loop.train(cfg.replace(num_steps_stop=LOOP_STEPS, snapshot_dir=b_dir),
                         batch_iter=repeat(), resume=True,
                         csv_path=os.path.join(tmp, "b.csv"), print_fn=quiet)
    resume_launches = read_counts()
    check_counts("train loop (resumed)", resume_launches, _loop_counts(2, 0))
    loss_err = 0.0
    with open(os.path.join(tmp, "a.csv")) as fa, open(os.path.join(tmp, "b.csv")) as fb:
        ra, rb = list(csv.DictReader(fa))[2:], list(csv.DictReader(fb))
    ok = [r["step"] for r in ra] == [r["step"] for r in rb] == ["2", "3"]
    for x, y in zip(rb, ra):
        for k in ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor",
                  "place"):
            loss_err = max(loss_err, abs(float(x[k]) - float(y[k]))
                           / max(abs(float(y[k])), 1e-30))
    want, got = _state_tensors(whole["state"]), _state_tensors(resumed["state"])
    param_err = max(_rel_err(got[k], v) for k, v in want.items())
    ok = (ok and loss_err <= TOL_RESUME and param_err <= TOL_RESUME
          and resumed["state"].step == LOOP_STEPS
          and keep == [f"step_{LOOP_STEPS - 1:08d}", f"step_{LOOP_STEPS:08d}"])
    print(f"train loop resume on the card: steps 2-3 resumed from the step-2 snapshot vs "
          f"uninterrupted: losses within {loss_err:.3e}, parameters within {param_err:.3e} "
          f"relative (limit {TOL_RESUME:g}); keep/delete with scores rising each step "
          f"leaves {keep}; StepTimer {resumed['steps_per_sec']:.3f} steps/s over the 2 "
          f"resumed steps (resident step {1e3 / resident['wall_ms']:.3f} steps/s) "
          f"[{smi}]: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("train loop: the resumed run differs from the uninterrupted one")

    # Snapshot save / restore times and bytes; the snapshot across card and CPU.
    st = resumed["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(st, os.path.join(tmp, "loop_c"), 7)
    save_s = time.perf_counter() - t0
    nbytes = checkpoint.snapshot_bytes(os.path.join(tmp, "loop_c"), 7)
    fresh = create_simt_state(*loop.build_models(cfg), cfg, torch.Generator().manual_seed(9),
                              "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore(fresh, os.path.join(tmp, "loop_c"))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    on_card = _state_tensors(st)
    cpu = create_simt_state(*loop.build_models(cfg), cfg, torch.Generator().manual_seed(9),
                            "cpu")
    checkpoint.restore(cpu, os.path.join(tmp, "loop_c"))
    checkpoint.save(cpu, os.path.join(tmp, "loop_d"), 7)
    checkpoint.restore(fresh, os.path.join(tmp, "loop_d"))
    crossed = all(torch.equal(_state_tensors(cpu)[k], v.cpu())
                  and torch.equal(_state_tensors(fresh)[k], v) for k, v in on_card.items())
    print(f"train loop snapshot: save {save_s:.3f} s, {nbytes} bytes "
          f"({nbytes / 2**30:.3f} GiB); restore {restore_s:.3f} s; card -> CPU -> card "
          f"equal bit for bit: {'yes' if crossed else 'NO'} [{smi}]")
    if not crossed:
        fail("train loop: a snapshot did not cross between the card and the CPU intact")
    out.update(save_s=save_s, snapshot_bytes=nbytes, restore_s=restore_s,
               loop_steps_per_sec=resumed["steps_per_sec"], resume_loss_err=loss_err,
               resume_param_err=param_err)
    del whole, resumed, st, fresh, cpu, on_card, want, got
    for d in (a_dir, b_dir, os.path.join(tmp, "loop_c"), os.path.join(tmp, "loop_d")):
        shutil.rmtree(d)
    torch.cuda.empty_cache()

    # 3. The warmup CLI: 3 steps, one evaluation (single scale), its snapshots.
    w_snaps = os.path.join(tmp, "loop_w")
    reset_counts()
    summary = train_warmup.main(data + ["--num-steps-stop", "3", "--save-pred-every", "2",
                                        "--snapshot-dir", w_snaps])
    launches = read_counts()
    print(f"train loop, train_warmup CLI (3 steps, eval at step 2): StepTimer "
          f"{summary['steps_per_sec']:.3f} steps/s, in-loop eval {summary['eval_seconds']} "
          f"s, best mIoU {summary['best_miou']}, snapshots {_snapshots(w_snaps)} [{smi}]")
    check_counts("train loop (warmup CLI)", launches, _loop_counts(3, LOOP_VAL, "warmup"))
    if (_snapshots(w_snaps) != ["step_00000002", "step_00000003"]
            or not math.isfinite(summary["best_miou"])):
        fail(f"train loop (warmup CLI): snapshots {_snapshots(w_snaps)}, mIoU "
             f"{summary['best_miou']}")
    del summary
    shutil.rmtree(w_snaps)
    torch.cuda.empty_cache()

    # 4. --profile-dir over 2 steps, the CLI in a process of its own as a user runs it:
    # after the loader workers of the runs above (spawned processes that import torch)
    # have exited, this process's profiler can record no CUDA activity at all
    # (tools/profiler_probe.py --torch-children).
    prof = os.path.join(tmp, "loop_prof")
    res = subprocess.run(
        [sys.executable, "-m", "simt_tpu_torch.tools.train_simt", "--data-dir-target",
         paths["root"], "--data-list-target", paths["pseudo_lst"], "--num-steps-stop", "2",
         "--snapshot-dir", "", "--profile-dir", prof],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    if res.returncode:
        fail(f"train loop --profile-dir: the CLI exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    named = {w: trace.count(w) for w in (KERNEL_WORD, "loss_fwd_kernel", "loss_bwd_kernel")}
    print(f"train loop --profile-dir: trace.json {len(trace)} bytes, kernel name counts "
          f"{named}")
    if not all(named.values()):
        fail(f"train loop: the profiler trace lacks the package's kernels: {named}")
    torch.cuda.empty_cache()
    return out


# Every kernel wrapper of the package, by name; each counts its own launches.
COUNTED = {"multiscale_argmax_hist": eval_fused.multiscale_argmax_hist,
           "loss_core_fwd": loss_fused.loss_core_fwd,
           "loss_core_bwd": loss_fused.loss_core_bwd,
           "conv3x3_fwd": conv3x3.conv3x3_fwd,
           "conv3x3_wgrad": conv3x3.conv3x3_wgrad,
           "bottleneck_fwd": bottleneck.bottleneck_fwd,
           "bottleneck_bwd": bottleneck.bottleneck_bwd}


# The wrappers that count their launches by kernel variant as well.
BY_VARIANT = ("conv3x3_fwd", "conv3x3_wgrad", "bottleneck_fwd", "bottleneck_bwd")


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    for name in BY_VARIANT:
        COUNTED[name].variants = dict.fromkeys(COUNTED[name].variants, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def read_variants() -> dict:
    return {name: dict(COUNTED[name].variants) for name in BY_VARIANT}


def check_wgmma(path: str, variants: dict) -> None:
    """Fails unless every B4/B5 (and B6/B7) launch of a bf16 path went to the wgmma
    kernels."""
    print(f"{path} B4/B5/B6/B7 launches by variant: {variants}")
    for name, counts in variants.items():
        if sum(counts.values()) != counts["wgmma"]:
            fail(f"{path}: {name} launched {counts}, not only its wgmma kernel")


def check_counts(path: str, launches: dict, want: dict) -> None:
    """Fails unless every kernel launched as often as ``want`` says (0 if absent)."""
    want = {name: want.get(name, 0) for name in COUNTED}
    print(f"{path} main path launches: {launches} (want {want})")
    if launches != want:
        fail(f"{path}: launches {launches}, want {want}")


def timed_steps(step, state, batches, n: int = TIMED_STEPS, first: int = 0):
    """``n`` steps on ``batches[first:]`` (cyclic): (wall ms per step, their metrics)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(state, batches[(first + i) % len(batches)]) for i in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, metrics


def drive_train_path(path: str, step, state, batches, line, want: dict) -> dict:
    """One train main path after its set-up: 2 warm-up steps; every launch count zeroed,
    TIMED_STEPS timed steps with their CUDA-event spans, the counts read and held to
    ``want``; every step's metric line (``line(i, values)``), all finite; 3 profiled
    steps for the device busy share; the A/B against conv2 on cuDNN."""
    metrics = [step(state, batches[i % len(batches)]) for i in range(2)]  # cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step.spans = []
    wall_ms, timed = timed_steps(step, state, batches, first=2)
    launches, variants = read_counts(), read_variants()
    parts = {}
    for name, start, end in step.spans:
        parts[name] = parts.get(name, 0.0) + start.elapsed_time(end) / TIMED_STEPS
    step.spans = None
    for i, m in enumerate(metrics + timed):  # the warm-up steps' lines too
        vals = {k: float(v) for k, v in m.items()}
        print(line(i, vals))
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"{path} step {i}: non-finite metrics {vals}")
    print(f"main path: {path} train step, full width, batch 1, 512x1024, bf16 autocast: "
          f"{TIMED_STEPS} steps, {wall_ms:.3f} ms per step, {1e3 / wall_ms:.3f} steps/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{path} step parts (CUDA events, ms per step): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; sum {sum(parts.values()):.3f}, wall {wall_ms:.3f}")
    check_counts(path, launches, want)
    check_wgmma(path, variants)
    device_ms = profile_steps(step, state, batches)
    print(f"{path} step device busy share: {device_ms:.3f} ms of kernels per step "
          f"(profiler) over {wall_ms:.3f} ms wall per step (timed run) = "
          f"{device_ms / wall_ms:.3f}")
    conv2_ab(path, step, state, batches)
    return {"launches": launches, "variants": variants, "wall_ms": wall_ms,
            "parts": parts, "device_ms": device_ms}


def phase_loss_kernel_times(launches: dict, worst: dict) -> list:
    """B2/B3 at the main path's shapes on the iid, regions, shifted and step label maps,
    timed by ``bench_loss_fused.time_loss``: ``ms`` the wrapper back to back (CUDA
    events), ``kernel_ms`` its kernel (profiler, held to the events' device time), every
    device operation of one call in launch order, host us a call. Fails unless each call is one device operation, its kernel
    (no fill or copy around it). The plain versions on iid; the bound from ``work()``
    with each map's own counts (its forward's placeholder and label counts). No single
    PyTorch call computes either function: library_ms is null."""
    h8, w8 = TRAIN_LOGIT_HW
    hh, ww = TRAIN_HW
    kwc = dict(num_classes=C, threshold_high=0.8)
    maps = make_maps(LABEL_MAPS, SEED)
    rows = {}
    for m, (xcat, label, conf, t1, t2, g) in maps.items():
        timed = time_loss(loss_calls(loss_fused, xcat, label, conf, t1, t2, g))
        sums = loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kwc)[0]
        work = loss_fused.work(1, h8, w8, hh, ww, C, O, place=int(sums[:, 5].sum()),
                               labelled=int(sums[:, 7].sum()))
        for op, r in timed.items():
            nbytes, ops, sfu = work[op]
            r["bound_ms"], r["bound_by"], r["bound_term"] = loss_fused.bound(nbytes, ops,
                                                                              sfu)
            r.update(bytes=nbytes, ops=ops, sfu_ops=sfu)
            rows[(m, op)] = r
            print(f"loss_core_{op} [{m}]: wrapper {r['ms']:.4f} ms, kernel "
                  f"{r['kernel_ms']:.4f} ms, {r['device_ops']} device operation(s) a call: "
                  + "; ".join(f"{n} {ms:.4f}" for n, ms in r["per_launch"])
                  + f"; host {r['host_us']:.1f} us; bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_term']}; events {r['busy_ms']:.4f} ms, {r['readings']} "
                  f"profiler reading(s), kernel ms by {r['kernel_ms_by']}")
            if r["launches"] != 1 or r["device_ops"] != 1:
                fail(f"loss_core_{op} [{m}]: {r['device_ops']} device operations a call "
                     f"({r['launches']} of its kernel), want its one kernel alone")
    xcat, label, conf, t1, t2, g = maps["iid"]
    plain = {"fwd": lambda: loss_fused.loss_core_fwd_reference(xcat, label, conf, t1, t2,
                                                                **kwc),
             "bwd": lambda: loss_fused.loss_core_bwd_reference(g, xcat, label, conf, t1,
                                                                t2, **kwc)}
    main = worst["cases"]["batch1"]
    keys = ("ms", "kernel_ms", "kernel_ms_by", "busy_ms", "launches", "device_ops",
            "host_us", "bound_ms", "bound_term")
    entries = []
    for op in ("fwd", "bwd"):
        fwd = op == "fwd"
        r = rows[("iid", op)]
        name = "loss_core_" + op
        entries.append({
            "name": name, "route": "cuda", "source": "simt_tpu_torch/csrc/loss_fused.cu",
            "replaces": ("experiments/pallas_alternates/loss_fused.py:184" if fwd
                         else "experiments/pallas_alternates/loss_fused.py:348"),
            "launches": launches[name],
            "max_abs_err": main["sums_max_abs"] if fwd else main["dx_max_abs"],
            "rel_err": ({"sums": main["sums_rel"]} if fwd else
                        {"dxcat": main["dx_rel"], "dt1": main["dt1_rel"],
                         "dt2": main["dt2_rel"]}),
            "match": worst["match"],
            "ms": r["ms"], "kernel_ms": r["kernel_ms"], "launches_per_call": r["launches"],
            "per_launch": r["per_launch"],
            "plain_ms": cuda_ms(plain[op], iters=3, warmup=1),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_term": r["bound_term"], "library_ms": None,
            "bytes": r["bytes"], "ops": r["ops"], "sfu_ops": r["sfu_ops"],
            "by_labels": {m: {k: rows[(m, op)][k] for k in keys} for m in maps},
            "shape": ("xcat 1x65x129x68 f32, label 1x512x1024 i32, conf 1x512x1024 u8, "
                      "T 2x34x19 f32" + (" -> sums 2x8, anchors 2x34" if fwd else
                                         " + g 2x8 -> dxcat 1x65x129x68, dT 2x34x19")),
        })
        print(f"{name}: plain {entries[-1]['plain_ms']:.3f} ms")
    return entries


# ---------------------------------------------------------------------------------
# The trunk's dilated 3x3 conv (B4/B5) and the warmup train path
# ---------------------------------------------------------------------------------

N_CONV2 = 33  # bottlenecks of ResNet-101: 3 + 4 + 23 + 3, one 3x3 conv each
N_CONV2_L34 = 26  # those of layers 3 and 4 (trained in the SimT stage)
# (name, H, W, channels, dilation, blocks) of the four trunk stages at a 512x1024 crop.
TRUNK = (("layer1", 129, 257, 64, 1, 3), ("layer2", 65, 129, 128, 1, 4),
         ("layer3", 65, 129, 256, 2, 23), ("layer4", 65, 129, 512, 4, 3))
# Tolerances of B4/B5 against their plain versions. bf16 outputs (B4 forward and input
# gradient): one bf16 ulp at the largest value, 2**-7 of the plain output's max abs.
# Both sum exactly representable bf16 products in float32, in other orders, and round
# once: a value then lands on the neighbouring bf16 number at most, which is up to
# 2**-7 of it (a half ulp, 2**-8, bounds each side's rounding but not their
# difference). float32 outputs: 1e-5 of the max (summation order). dw (float32 in
# both): 1e-4 of the max (sums of up to 66k terms in another order).
TOL_CONV_BF16, TOL_CONV_F32, TOL_WGRAD = 2.0 ** -7, 1e-5, 1e-4
# (name, H, W, channels, dilation) of the same stages at the eval path's 640x1280 scale.
TRUNK_EVAL_640 = (("layer1", 161, 321, 64, 1), ("layer2", 81, 161, 128, 1),
                  ("layer3", 81, 161, 256, 2), ("layer4", 81, 161, 512, 4))


def conv_inputs(batch: int, h: int, w: int, c: int, o: int, dtype: torch.dtype,
                gen: torch.Generator):
    """x (B, C, H, W), w (O, C, 3, 3) at the reference init's scale, g (B, O, H, W)."""
    def cl(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)
    x = cl(torch.relu(torch.randn(batch, c, h, w, device="cuda", generator=gen)))
    wt = (torch.randn(o, c, 3, 3, device="cuda", generator=gen) * 0.01).to(dtype)
    g = cl(torch.randn(batch, o, h, w, device="cuda", generator=gen))
    return x, wt, g


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    diff = float((a.float() - b.float()).abs().max())
    return diff, diff / max(float(b.float().abs().max()), 1e-30)


def phase_conv_kernels_vs_plain() -> dict:
    """B4 (forward and input gradient) and B5 against conv3x3_taps / wgrad_taps; each
    kernel run twice, bitwise equal. Prints the variant each case took: bf16 on the
    vector width the wgmma kernels, float32 and bf16 off it the first port's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {}
    for name, h, w, c, d, _ in TRUNK:
        for b in (1, 2):
            cases[f"{name}_b{b}"] = (b, h, w, c, c, d, torch.bfloat16)
    for name, h, w, c, d in TRUNK_EVAL_640:
        cases[f"eval640_{name}_b1"] = (1, h, w, c, c, d, torch.bfloat16)
    cases.update({
        "f32_17x23_32to48_d2": (2, 17, 23, 32, 48, 2, torch.float32),
        "edge_13x10_3to5_d2": (2, 13, 10, 3, 5, 2, torch.bfloat16),
        "edge_13x10_3to5_d2_f32": (2, 13, 10, 3, 5, 2, torch.float32),
        "edge_pad_wider_3x5_d4": (1, 3, 5, 8, 16, 4, torch.bfloat16),
        "edge_off_tile_72to40": (1, 9, 11, 72, 40, 1, torch.bfloat16),
        "edge_off_tile_20to36_f32": (2, 7, 9, 20, 36, 2, torch.float32),
    })
    worst = {"match": True, "cases": {}}
    for name, (b, h, w, c, o, d, dt) in cases.items():
        x, wt, g = conv_inputs(b, h, w, c, o, dt, gen)
        reset_counts()
        got = {"fwd": conv3x3.conv3x3_fwd(x, wt, d),
               "dx": conv3x3.conv3x3_fwd(g, wt, d, flip=True),
               "wgrad": conv3x3.conv3x3_wgrad(x, g, d)}
        took = {n: [k for k, v in c_.items() if v] for n, c_ in read_variants().items()}
        again = {"fwd": conv3x3.conv3x3_fwd(x, wt, d),
                 "dx": conv3x3.conv3x3_fwd(g, wt, d, flip=True),
                 "wgrad": conv3x3.conv3x3_wgrad(x, g, d)}
        want = {"fwd": conv3x3.conv3x3_taps(x, wt, d),
                "dx": conv3x3.conv3x3_taps(g, wt, d, flip=True),
                "wgrad": conv3x3.wgrad_taps(x, g, d)}
        torch.cuda.synchronize()
        tol_out = TOL_CONV_BF16 if dt == torch.bfloat16 else TOL_CONV_F32
        repeat_equal = all(torch.equal(got[op], again[op]) for op in got)
        err, ok = {}, repeat_equal
        for op in ("fwd", "dx", "wgrad"):
            if got[op].shape != want[op].shape or got[op].dtype != want[op].dtype:
                fail(f"conv3x3 {op} [{name}]: {got[op].shape}/{got[op].dtype} vs "
                     f"{want[op].shape}/{want[op].dtype}")
            abs_err, rel = _max_rel(got[op], want[op])
            err[op] = {"max_abs": abs_err, "rel_max": rel}
            ok = ok and rel <= (TOL_WGRAD if op == "wgrad" else tol_out) and bool(
                torch.isfinite(got[op]).all())
        print(f"conv3x3 vs plain [{name}] B{b} {h}x{w} {c}->{o} d{d} {str(dt)[6:]} "
              f"(B4 {'/'.join(took['conv3x3_fwd'])}, B5 {'/'.join(took['conv3x3_wgrad'])}): "
              + ", ".join(f"{op} {e['rel_max']:.3e}" for op, e in err.items())
              + f" of max; repeat bitwise equal: {repeat_equal}: {'ok' if ok else 'MISMATCH'}")
        worst["cases"][name] = err
        worst["match"] = worst["match"] and ok
    if not worst["match"]:
        fail("conv3x3 kernels disagree with their plain versions or between runs")
    return worst


@contextlib.contextmanager
def conv2_through(fn):
    """Route every bottleneck's conv2 through ``fn(x, w, d)`` instead of the port's op
    (B4/B5) while the block runs: the cuDNN yardstick or the plain taps. Only this
    script does this, to compare; the port always calls its own op."""
    saved = layers.dilated_conv3x3
    layers.dilated_conv3x3 = fn
    try:
        yield
    finally:
        layers.dilated_conv3x3 = saved


def cudnn_conv2(x, w, d):
    return F.conv2d(x, w, padding=d, dilation=d)


def plain_conv2(x, w, d):
    """The plain taps (float32 matmuls, outside autocast), differentiated by autograd."""
    with torch.autocast("cuda", enabled=False):
        return conv3x3.conv3x3_taps(x, w, d)


def conv2_ab(path: str, step, state, batches) -> dict:
    """The train step with conv2 on B4/B5 against the same step with conv2 on cuDNN
    (the yardstick), in turns kernels, cuDNN, cuDNN, kernels within this call: wall
    ms per step over TIMED_STEPS steps each, then device ms per step (profiler)."""
    wall = {"kernels": [], "cudnn": []}
    for mode in ("kernels", "cudnn", "cudnn", "kernels"):
        ctx = conv2_through(cudnn_conv2) if mode == "cudnn" else contextlib.nullcontext()
        with ctx:
            step(state, batches[0])  # cuDNN plans, allocator
            wall[mode].append(timed_steps(step, state, batches)[0])
    dev = {"kernels": profile_steps(step, state, batches, report=False)}
    with conv2_through(cudnn_conv2):
        dev["cudnn"] = profile_steps(step, state, batches, report=False)
    print(f"{path} step, conv2 on B4/B5 vs on cuDNN (yardstick), in turns: wall ms per "
          f"step kernels {wall['kernels'][0]:.3f}/{wall['kernels'][1]:.3f}, cuDNN "
          f"{wall['cudnn'][0]:.3f}/{wall['cudnn'][1]:.3f}; device ms per step (profiler) "
          f"kernels {dev['kernels']:.3f}, cuDNN {dev['cudnn']:.3f}")
    return {"wall": wall, "device": dev}


def warmup_vs_plain_conv(cfg, batches) -> None:
    """Three full-width warmup steps with conv2 on B4/B5 against the same steps from the
    same weights with conv2 on the plain taps (float32 sums, autograd backward): the
    losses within 2e-2 relative (bf16 activations: each conv2 output may round one
    bf16 ulp apart, 2**-7, and the steps feed that back)."""
    base = loop.build_models(cfg)[0]
    losses = {}
    for mode in ("kernels", "plain"):
        st = create_warmup_state(copy.deepcopy(base), cfg, "cuda")
        step = make_warmup_step(cfg)
        ctx = conv2_through(plain_conv2) if mode == "plain" else contextlib.nullcontext()
        with ctx:
            losses[mode] = [{k: float(v) for k, v in step(st, batches[i]).items()}
                            for i in range(3)]
        del st
        torch.cuda.empty_cache()
    ok = True
    for i, (lk, lp) in enumerate(zip(losses["kernels"], losses["plain"])):
        rel = max(abs(lk[k] - lp[k]) / abs(lp[k]) for k in ("loss_seg1", "loss_seg2"))
        ok = ok and rel <= 2e-2
        print(f"full-width warmup step {i}, conv2 on B4/B5 vs plain taps: loss_seg1 "
              f"{lk['loss_seg1']:.5f}/{lp['loss_seg1']:.5f}, loss_seg2 "
              f"{lk['loss_seg2']:.5f}/{lp['loss_seg2']:.5f} (rel {rel:.2e}, limit 2e-2)")
    if not ok:
        fail("the full-width warmup step disagrees with its plain-conv reference")


WARMUP_WATCH = ("conv1.weight", "layer1.0.conv2.weight")  # a stem and a layer1 weight


def warmup_golden_config() -> TrainConfig:
    """The golden geometry's closed-set warmup: C5, float32."""
    return TrainConfig(model=ModelConfig(num_classes=5, compute_dtype="float32"),
                       optim=OptimConfig(num_steps=1000))


def phase_warmup_small_steps() -> None:
    """Three whole warmup steps on the card against the same steps on the CPU (float32,
    TF32 off). Tolerances: the losses rel 1e-3 / abs 1e-4, as the SimT check; a stem
    and a layer1 conv2 weight after the steps within 5e-2 of their largest change (the
    random-init trunk's batch-statistic BatchNorm amplifies one-ulp differences, as in
    tests/test_torch_warmup_step.py)."""
    cfg = warmup_golden_config()
    model = init_weights(ResNetMulti(5, 0, False, layers=(1, 1, 1, 1),
                                     dtype=torch.float32),
                         torch.Generator().manual_seed(SEED))
    start = {k: model.state_dict()[k].clone() for k in WARMUP_WATCH}
    batches = [synthetic_batch(1, (32, 64), 5, seed=SEED + i) for i in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        st = create_warmup_state(copy.deepcopy(model), cfg, dev)
        step = make_warmup_step(cfg)
        losses = [{k: float(v) for k, v in step(st, b).items()} for b in batches]
        sd = st.model.state_dict()
        out[dev] = (losses, {k: sd[k].detach().cpu() for k in WARMUP_WATCH})
    ok = True
    for i, (lc, lg) in enumerate(zip(out["cpu"][0], out["cuda"][0])):
        for k in ("loss_seg1", "loss_seg2"):
            ok = ok and math.isfinite(lg[k]) and abs(lg[k] - lc[k]) <= max(
                1e-4, 1e-3 * abs(lc[k]))
        print(f"small warmup step {i}: loss_seg1 cuda {lg['loss_seg1']:.6f} cpu "
              f"{lc['loss_seg1']:.6f}, loss_seg2 {lg['loss_seg2']:.6f}/"
              f"{lc['loss_seg2']:.6f}")
    for k in WARMUP_WATCH:
        d_cpu = out["cpu"][1][k] - start[k]
        d_gpu = out["cuda"][1][k] - start[k]
        _, rel = _max_rel(d_gpu, d_cpu)
        moved = float(d_cpu.abs().max()) > 0
        ok = ok and moved and rel <= 5e-2
        print(f"small warmup steps cuda vs cpu: {k} change within {rel:.3e} of its max "
              f"{float(d_cpu.abs().max()):.3e} (limit 5e-2): {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the warmup step on the card disagrees with the CPU at the golden geometry")


def phase_warmup_main_path() -> dict:
    """The warmup step at full width through the CLI's own calls."""
    args = train_warmup.build_parser().parse_args(
        ["--synthetic", "--num-steps-stop", str(2 + TIMED_STEPS)])
    cfg = train_warmup.build_config(args)
    t0 = time.perf_counter()
    state = create_warmup_state(loop.build_models(cfg)[0], cfg, "cuda")
    batches = train_simt.synthetic_batches(cfg, cfg.num_steps_stop, torch.device("cuda"))
    step = make_warmup_step(cfg)
    torch.cuda.synchronize()
    print(f"warmup set-up (closed-set model, state, {len(batches)} synthetic 512x1024 "
          f"batches): {time.perf_counter() - t0:.1f} s")
    # Every bottleneck trains in this stage: forward, input gradient and weight gradient.
    want = TIMED_STEPS * cfg.optim.iter_size
    out = drive_train_path("warmup", step, state, batches,
                           lambda i, v: format_warmup_line(i, cfg.num_steps, v),
                           {"conv3x3_fwd": 2 * N_CONV2 * want,
                            "conv3x3_wgrad": N_CONV2 * want})
    del state
    torch.cuda.empty_cache()
    warmup_vs_plain_conv(cfg, batches)
    return out


def phase_conv_library_free() -> None:
    """One B4 forward, one dx and one B5 at layer3 under the profiler: only the
    package's kernels and the weight permute's copy may run (no library GEMM or
    convolution, no second B5 launch)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    _, h, w, c, d, _ = TRUNK[2]
    x, wt, g = conv_inputs(1, h, w, c, c, torch.bfloat16, gen)
    for op, (call, _) in conv_calls(conv3x3, x, wt, g, d).items():
        names = {n: k for n, (k, _) in profile_kernels(call, 1).items()}
        ours = [n for n in names if KERNEL_WORD in n]
        library = [n for n in names
                   if any(k in n.lower() for k in LIBRARY_KERNEL_WORDS + ("reduce",))]
        others = [n for n in names if n not in ours]
        print(f"conv3x3 {op} at layer3, CUDA kernels (profiler, launches a call): "
              + "; ".join(f"{n[:90]} x{k}" for n, k in sorted(names.items())))
        want_others = 0 if op == "wgrad" else 1  # the weight permute's copy
        if (len(ours) != 1 or names[ours[0]] != 1 or library
                or len(others) != want_others):
            fail(f"conv3x3 {op} ran {names}: want one package kernel"
                 + (" and the permute's copy" if want_others else ""))


def phase_conv_times(paths: dict, variants: dict, worst: dict) -> list:
    """B4 and B5 at the four trunk geometries (batch 1, bf16), timed by
    ``bench_conv3x3.time_conv``: ``ms``, the wrapper back to back as the model calls it
    (CUDA events; the weight permute and the host's pace included), and ``kernel_ms``,
    its kernel's device time (profiler); ``library_ms`` and ``library_kernel_ms``, the
    same two of cuDNN's call (F.conv2d, aten.convolution_backward; a yardstick the port
    never calls); the plain versions, the bound, the tile, splits and waves chosen.
    Returns the kernels line's entries, layer3 (23 of the 33 blocks) as the main figure
    and every geometry under by_geometry; prints the host cost of a call at layer3."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    step_ops = 0
    rows = {}
    for name, h, w, c, d, blocks in TRUNK:
        x, wt, g = conv_inputs(1, h, w, c, c, torch.bfloat16, gen)
        timed = time_conv(conv_calls(conv3x3, x, wt, g, d), host=name == "layer3")
        plain = {"fwd": lambda: conv3x3.conv3x3_taps(x, wt, d),
                 "dx": lambda: conv3x3.conv3x3_taps(g, wt, d, flip=True),
                 "wgrad": lambda: conv3x3.wgrad_taps(x, g, d)}
        ft, wg = conv3x3.fwd_tiles(h * w, c), conv3x3.wgrad_tiles(h * w, c, c)
        tiles = {"fwd": f"128x{ft.bn} tiles, {ft.tiles} blocks, {ft.waves} wave(s)",
                 "wgrad": (f"{wg.bc}x{wg.bo} tiles x 9 taps, {wg.splits} split(s) of "
                           f"{wg.per_split} pixels, {wg.items} blocks, {wg.waves} wave(s)")}
        tiles["dx"] = tiles["fwd"]
        line = []
        for op, r in timed.items():
            nbytes, ops = conv3x3.work(1, h, w, c, c, torch.bfloat16, op)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_BF16_FLOP_S * 1e3
            r.update(plain_ms=cuda_ms(plain[op], iters=3, warmup=1),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, ops=ops, tiles=tiles[op])
            rows[(name, op)] = r
            step_ops += ops * blocks
            line.append(f"{op} {r['ms']:.4f} ms wrapper, {r['kernel_ms']:.4f} kernel (plain "
                        f"{r['plain_ms']:.3f}; cuDNN {r['library_ms']:.4f} call, "
                        f"{r['library_kernel_ms']:.4f} kernels; bound {r['bound_ms']:.4f} by "
                        f"{r['bound_by']}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
                        f"kernel {ops / r['kernel_ms'] / 1e9:.1f} TFLOP/s; {tiles[op]})")
        print(f"conv3x3 times [{name} 1x{h}x{w}x{c} d{d}, {blocks} blocks]: "
              + "; ".join(line))
        if name == "layer3":
            print("conv3x3 host cost per call at layer3 (us, 200 calls issued back to "
                  "back), wrapper / cuDNN: " + ", ".join(
                      f"{op} {r['host_us']:.1f} / {r['library_host_us']:.1f}"
                      for op, r in timed.items()))
    print(f"conv3x3 work of one warmup step (forward + input gradient + weight gradient "
          f"of the 33 blocks): {step_ops / 1e12:.3f} TFLOP, "
          f"{step_ops / PEAK_BF16_FLOP_S * 1e3:.3f} ms at the bf16 peak")
    times = ("ms", "kernel_ms", "library_ms", "library_kernel_ms")
    entries = []
    for op, key in (("fwd", "conv3x3_fwd"), ("wgrad", "conv3x3_wgrad")):
        r = rows[("layer3", op)]
        err = worst["cases"]["layer3_b1"][op]
        geo = {}
        for name, *_ in TRUNK:
            g_ = rows[(name, op)]
            geo[name] = {k: g_[k] for k in times + ("bound_ms", "tiles")}
            if op == "fwd":
                geo[name].update({"dx_" + k: rows[(name, "dx")][k] for k in times})
        _, h, w, c, d, _ = TRUNK[2]
        entries.append({
            "name": key, "route": "cuda", "source": "simt_tpu_torch/csrc/conv3x3.cu",
            "replaces": "experiments/pallas_alternates/conv3x3.py:"
                        + ("73" if op == "fwd" else "97"),
            "launches": paths["warmup"][key],
            "launches_by_path": {p: v[key] for p, v in paths.items()},
            "variants_by_path": {p: v[key] for p, v in variants.items()},
            "max_abs_err": err["max_abs"], "rel_err": err["rel_max"],
            "match": worst["match"],
            **{k: r[k] for k in times + ("plain_ms", "bound_ms", "bound_by", "host_us",
                                         "library_host_us", "bytes", "ops", "tiles")},
            **({"dx_" + k: rows[("layer3", "dx")][k] for k in times + ("plain_ms",)}
               if op == "fwd" else {}),
            "by_geometry": geo,
            "shape": (f"x 1x{h}x{w}x{c} bf16 NHWC, w {c}x{c}x3x3 bf16, d {d} -> "
                      + (f"1x{h}x{w}x{c} bf16" if op == "fwd" else f"dw {c}x{c}x3x3 f32")),
        })
    return entries


# ---------------------------------------------------------------------------------
# The fused train-mode bottleneck (B6/B7) and its benchmark path
# ---------------------------------------------------------------------------------

# BNECK (imported from tools/bench_fused_bottleneck.py): (name, H, W, trunk channels
# Ct, planes P, dilation) of the trunk's identity blocks at a 512x1024 crop.
# Edge cases (H, W, Ct, P, d): an odd image; dilation 4 on a 3x5 image (every 3x3 tap
# but the centre falls off it); channel counts off the kernels' 8-element vector width,
# which the first port's kernels take on their scalar load path.
BNECK_EDGE = {"edge_odd_9x13": (9, 13, 64, 16, 2), "edge_d4_on_3x5": (3, 5, 32, 8, 4),
              "edge_off_vector_36_9": (9, 11, 36, 9, 1)}
# Tolerances of B6/B7 against their plain versions on the same inputs. Both sum exactly
# representable bf16 products in float32 in other orders, so each rounded conv output
# (h1raw, h2raw, outraw) may land one bf16 ulp apart, and BatchNorm passes that on:
#   - the output 2**-6 of its max, two bf16 ulps: its own rounding plus one ulp of
#     outraw scaled by a3, whose normalised value stays below the output's max (one ulp,
#     2**-7, was measured exceeded at layer3: 8.26e-3);
#   - each statistics vector 1e-3, or 2**-5/m on an image of m < 32 pixels: a variance
#     of its max, a mean of the largest RMS of the values it averages,
#     sqrt(var + mean^2) (a mean of centred values is near 0, so its own max is no
#     scale). One value of m that rounds one ulp apart moves a mean by up to 2**-7/m and
#     a variance by up to 2**-6/m of that scale; on the 15-pixel 3x5 image that gave
#     1.2e-3 for v3, so the limit there allows two such values;
#   - each of the ten gradients 2**-6 of its max (the same flips through three stages).
TOL_BNECK_OUT, TOL_BNECK_STATS, TOL_BNECK_GRAD = 2.0 ** -6, 1e-3, 2.0 ** -6
TOL_BNECK_STATS_PER_PIXEL = 2.0 ** -5
STAT_NAMES = ("m1", "v1", "m2", "v2", "m3", "v3")
BENCH_REPS = 10
BENCH_GEOMETRY = "65,129,256,1024,2"  # layer3: h, w, planes, trunk, dilation
GRAD_NAMES = ("dx", "dw1", "dw2", "dw3", "dg1", "db1", "dg2", "db2", "dg3", "db3")
LIBRARY_KERNEL_WORDS = ("gemm", "cublas", "cudnn", "xmma", "cutlass")


def _grads_flat(res) -> list:
    """(dx, dw1, dw2, dw3, dgb_p, dgb_t) -> the ten gradients."""
    dx, dw1, dw2, dw3, dgb_p, dgb_t = res
    return [dx, dw1, dw2, dw3, *dgb_p.unbind(), *dgb_t.unbind()]


def phase_bneck_kernels_vs_plain() -> dict:
    """B6 and B7 against bottleneck_fwd_plain / bottleneck_bwd_plain on the same inputs
    (B7 and its plain version both take B6's saved h1raw, h2raw and statistics), with
    the cotangent dy = 2*out of sum(out^2); each kernel run twice, bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = {name: (h, w, ct, p, d) for name, h, w, ct, p, d in BNECK}
    cases.update(BNECK_EDGE)
    worst = {"match": True, "cases": {}}
    for name, (h, w, ct, p, d) in cases.items():
        x, ws, vecs = bneck_inputs(h, w, ct, p, gen)
        reset_counts()
        got = bottleneck.bottleneck_fwd(x, *ws, *vecs, d)
        want = bottleneck.bottleneck_fwd_plain(x, *ws, *vecs, d)
        dy = (2.0 * got[0].float()).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        saved = (got[1], got[2], got[3], got[4], d)
        gb = bottleneck.bottleneck_bwd(dy, x, *ws, *vecs, *saved)
        wb = bottleneck.bottleneck_bwd_plain(dy, x, *ws, *vecs, *saved)
        took = {n: [k for k, v in c_.items() if v] for n, c_ in read_variants().items()
                if n.startswith("bottleneck")}
        again = (bottleneck.bottleneck_fwd(x, *ws, *vecs, d)
                 + bottleneck.bottleneck_bwd(dy, x, *ws, *vecs, *saved))
        torch.cuda.synchronize()
        # Every trunk geometry on the wgmma kernels; off the vector width the first port's.
        want_kind = "wgmma" if ct % 8 == 0 and p % 8 == 0 else "wmma"
        if any(v != [want_kind] for v in took.values()):
            fail(f"bottleneck [{name}] took {took}, want {want_kind} for both")
        repeat_equal = all(torch.equal(a, b) for a, b in zip(got + gb, again))
        err = {"out": _max_rel(got[0], want[0]), "stats": {}}
        stats = [*got[3].unbind(), *got[4].unbind()]
        stats_want = [*want[3].unbind(), *want[4].unbind()]
        for i, n in enumerate(STAT_NAMES):
            diff = float((stats[i] - stats_want[i]).abs().max())
            mean, var = stats_want[i - i % 2], stats_want[i - i % 2 + 1]
            scale = (var + mean * mean).sqrt() if i % 2 == 0 else var.abs()
            err["stats"][n] = diff / max(float(scale.max()), 1e-30)
        grads = {n: _max_rel(a, b) for n, a, b in zip(GRAD_NAMES, _grads_flat(gb),
                                                      _grads_flat(wb))}
        err["grads"] = grads
        finite = all(bool(torch.isfinite(t).all()) for t in got + gb)
        ok = (repeat_equal and finite and err["out"][1] <= TOL_BNECK_OUT
              and all(r <= max(TOL_BNECK_STATS, TOL_BNECK_STATS_PER_PIXEL / (h * w))
                      for r in err["stats"].values())
              and all(r <= TOL_BNECK_GRAD for _, r in grads.values()))
        print(f"bottleneck vs plain [{name}] {h}x{w} Ct {ct} P {p} d{d} ({want_kind}): "
              f"out {err['out'][1]:.3e}, stats "
              + ", ".join(f"{n} {r:.2e}" for n, r in err["stats"].items()) + ", grads "
              + ", ".join(f"{n} {r:.2e}" for n, (_, r) in grads.items())
              + f" of max; repeat bitwise equal: {repeat_equal}: "
              f"{'ok' if ok else 'MISMATCH'}")
        worst["cases"][name] = err
        worst["match"] = worst["match"] and ok
    if not worst["match"]:
        fail("bottleneck kernels disagree with their plain versions or between runs")
    return worst


def phase_bneck_library_free() -> list:
    """Profiles one fused forward + backward at layer3 and fails if any CUDA kernel in
    it is not this package's own (names with ``bneck_``) or a fill."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    _, h, w, ct, p, d = BNECK[2]
    x, ws, vecs = bneck_inputs(h, w, ct, p, gen)
    x.requires_grad_(True)
    for t in ws:
        t.requires_grad_(True)

    def run():
        out, _ = fused_bottleneck(x, *ws, *vecs, d)
        dy = (2.0 * out.detach().float()).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        return out, dy

    out, dy = run()
    torch.autograd.grad(out, (x, *ws), dy)  # warm-up: the library's first load
    out, dy = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, _ = fused_bottleneck(x, *ws, *vecs, d)
        torch.autograd.grad(out, (x, *ws), dy)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            names[e.name] = names.get(e.name, 0) + 1
    ours = {n for n in names if "bneck_" in n}
    library = [n for n in names if n not in ours
               and any(k in n.lower() for k in LIBRARY_KERNEL_WORDS)]
    other = [n for n in names if n not in ours and "fill" not in n.lower()]
    print(f"fused bottleneck fwd+bwd at layer3, CUDA kernels (profiler, {sum(names.values())} "
          f"launches): " + "; ".join(f"{n[:90]} x{c}" for n, c in sorted(names.items())))
    if not ours or library or other:
        fail(f"the fused bottleneck ran kernels not its own: library {library}, "
             f"other {other}")
    return sorted(names)


def phase_bneck_bench() -> dict:
    """The benchmark path: tools/bench_fused_bottleneck.main at layer3, full width,
    BENCH_REPS calls a chain, counts zeroed just before and read just after; then the
    same with every conv2 of the composed module on cuDNN (the yardstick)."""
    argv = ["--geometry", BENCH_GEOMETRY, "--reps", str(BENCH_REPS)]
    reset_counts()
    res = bench_fused_bottleneck.main(argv)
    launches = read_counts()
    r = BENCH_REPS
    # Each chain makes one warm-up call, then r: B6 in both fused chains, B7 in one; the
    # module runs conv2 forward in both chains and its input gradient in one (B4), its
    # weight gradient in one (B5).
    check_counts("fused bottleneck benchmark", launches,
                 {"bottleneck_fwd": 2 * (r + 1), "bottleneck_bwd": r + 1,
                  "conv3x3_fwd": 3 * (r + 1), "conv3x3_wgrad": r + 1})
    if not res["finite"]:
        fail("the fused bottleneck chains gave non-finite values")
    if res["agree_rel"] > 2.0 ** -6:
        fail(f"fused bottleneck and the composed module differ by {res['agree_rel']:.3e} "
             "of the output's max (limit 2**-6)")
    with conv2_through(cudnn_conv2):
        cud = bench_fused_bottleneck.main(argv)
    print(f"benchmark path (layer3, {BENCH_REPS} calls a chain, ms per call): fused fwd "
          f"{res['fused_fwd_ms']:.4f}, fwd+bwd {res['fused_fwdbwd_ms']:.4f}; module (conv2 "
          f"on B4/B5) fwd {res['module_fwd_ms']:.4f}, fwd+bwd {res['module_fwdbwd_ms']:.4f};"
          f" module with conv2 on cuDNN (yardstick) fwd {cud['module_fwd_ms']:.4f}, "
          f"fwd+bwd {cud['module_fwdbwd_ms']:.4f}; fused vs module output "
          f"{res['agree_rel']:.3e} of max (limit 2**-6)")
    return {"launches": launches, "res": res, "cudnn": cud}


def per_launch(timed: dict) -> list:
    """[short kernel name, device ms] of a ``time_bneck`` entry's launches, in order."""
    def short(name: str) -> str:
        return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    return [[short(n), ms] for n, ms in timed["per_launch"]]


# Launches a call at every trunk geometry (the wgmma path): B6 the weight packing, three
# GEMMs (statistics finished inside), two BatchNorm + ReLU passes and the residual
# pass; B7 the packing with the coefficients, one BatchNorm + ReLU pass, four GEMMs,
# three dor passes and three weight gradients (no reduce launch). The first port
# issued 10 and 23.
BNECK_LAUNCHES = {"fwd": 7, "bwd": 12}


def phase_bneck_times(bench: dict, paths: dict, worst: dict) -> list:
    """B6/B7 at the four trunk geometries, timed by ``bench_fused_bottleneck.time_bneck``:
    ``ms``, the wrapper back to back (CUDA events; the weight packing and the host's
    pace included), ``kernel_ms``, the device time of the call's ``bneck_`` kernels
    (profiler), the launches a call and each launch's device time (printed at layer3); the
    plain versions; the bound from ``work()``. Fails if a call issues other than
    BNECK_LAUNCHES launches. Returns the kernels line's entries at layer3, every
    geometry under by_geometry, with the composed module's times from the benchmark
    path in place of a library call (no single PyTorch call computes the fused block)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    for name, h, w, ct, p, d in BNECK:
        x, ws, vecs = bneck_inputs(h, w, ct, p, gen)
        reset_counts()
        timed = time_bneck(bneck_calls(bottleneck, x, ws, vecs, d))
        variants = read_variants()
        fwd = bottleneck.bottleneck_fwd(x, *ws, *vecs, d)
        dy = (2.0 * fwd[0].float()).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        plain = {"fwd": lambda: bottleneck.bottleneck_fwd_plain(x, *ws, *vecs, d),
                 "bwd": lambda: bottleneck.bottleneck_bwd_plain(dy, x, *ws, *vecs, *fwd[1:],
                                                                d)}
        line = []
        for op in ("fwd", "bwd"):
            r = timed[op]
            kinds = variants["bottleneck_" + op]
            if r["launches"] != BNECK_LAUNCHES[op] or kinds["wmma"]:
                fail(f"bottleneck {op} [{name}]: {r['launches']} launches a call "
                     f"(want {BNECK_LAUNCHES[op]}), variants {kinds}")
            nbytes, ops = bottleneck.work(h, w, ct, p, op)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_BF16_FLOP_S * 1e3
            r.update(plain_ms=cuda_ms(plain[op], iters=3, warmup=1),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, ops=ops)
            rows[(name, op)] = r
            line.append(f"{op} {r['ms']:.4f} ms wrapper, {r['kernel_ms']:.4f} kernels, "
                        f"{r['launches']:g} launches, {r['readings']} profiler reading(s), "
                        f"events {r['busy_ms']:.4f} (plain {r['plain_ms']:.3f}, bound "
                        f"{r['bound_ms']:.4f} by {r['bound_by']}; {ops / 1e9:.2f} GFLOP, "
                        f"{nbytes / 1e6:.1f} MB, kernels {ops / r['kernel_ms'] / 1e9:.1f} "
                        f"TFLOP/s)")
        print(f"bottleneck times [{name} 1x{h}x{w}x{ct} P {p} d{d}]: " + "; ".join(line))
        if name == "layer3":
            for op in ("fwd", "bwd"):
                print(f"bottleneck {op} launches at layer3, in order (profiler, device ms): "
                      + "; ".join(f"{n} {ms:.4f}" for n, ms in per_launch(timed[op])))
    entries = []
    _, h, w, ct, p, d = BNECK[2]
    keys = ("ms", "kernel_ms", "launches", "plain_ms", "bound_ms")
    for op in ("fwd", "bwd"):
        fwd_op = op == "fwd"
        key = "bottleneck_" + op
        r = rows[("layer3", op)]
        err = worst["cases"]["layer3"]
        res, cud = bench["res"], bench["cudnn"]
        entries.append({
            "name": key, "route": "cuda", "source": "simt_tpu_torch/csrc/bottleneck.cu",
            "replaces": "experiments/pallas_bottleneck/bottleneck.py:"
                        + ("74" if fwd_op else "195"),
            "launches": bench["launches"][key],
            "launches_by_path": {"bench": bench["launches"][key],
                                 **{k: v[key] for k, v in paths.items()}},
            "max_abs_err": (err["out"][0] if fwd_op
                            else max(a for a, _ in err["grads"].values())),
            "rel_err": ({"out": err["out"][1], "stats": err["stats"]} if fwd_op
                        else {n: r_ for n, (_, r_) in err["grads"].items()}),
            "match": worst["match"], "ms": r["ms"], "kernel_ms": r["kernel_ms"],
            "launches_per_call": r["launches"], "per_launch": per_launch(r),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the fused block; "
                            "module_* are the composed Bottleneck's ms per call",
            "module_ms": res["module_fwd_ms"] if fwd_op else res["module_fwdbwd_ms"],
            "module_cudnn_ms": (cud["module_fwd_ms"] if fwd_op
                                else cud["module_fwdbwd_ms"]),
            "fused_chain_ms": res["fused_fwd_ms"] if fwd_op else res["fused_fwdbwd_ms"],
            "bytes": r["bytes"], "ops": r["ops"],
            "by_geometry": {g[0]: {k: rows[(g[0], op)][k] for k in keys} for g in BNECK},
            "shape": (f"x 1x{h}x{w}x{ct} bf16 NHWC, P {p}, d {d}, weights f32 OIHW -> "
                      + ("out, h1raw, h2raw bf16, 6 stats f32" if fwd_op
                         else "dx bf16, dw1-3 f32, 6 dg/db f32")),
        })
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}; "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(SEED)

    phase_build()
    worst = phase_kernel_vs_plain(rng)
    conv_worst = phase_conv_kernels_vs_plain()
    phase_conv_library_free()
    bneck_worst = phase_bneck_kernels_vs_plain()
    phase_bneck_library_free()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_small_reference(tmp)
        phase_small_steps(tmp)
        phase_warmup_small_steps()
        model = deeplab_multi(C, 15, openset=True)
        init_weights(model, torch.Generator().manual_seed(SEED))
        launches, seconds, eval_variants = phase_main_path(tmp, model)
        forward_ms = phase_forward_times(model)
        del model
        torch.cuda.empty_cache()
        train = phase_train_main_path(tmp)
        torch.cuda.empty_cache()
        phase_pipeline(tmp, train)
        warm = phase_warmup_main_path()
        torch.cuda.empty_cache()
        bench = phase_bneck_bench()
        entry = phase_kernel_times(launches, worst)
        device_ms = sum(forward_ms) + entry["kernel_ms"]
        print(f"device time per image (forwards + kernel): {device_ms:.3f} ms; main path "
              f"wall time per image: {seconds / N_IMAGES * 1e3:.3f} ms; device busy share "
              f"(estimate): {device_ms * N_IMAGES / (seconds * 1e3):.3f}")
        paths = {"warmup": warm["launches"], "simt": train["launches"], "eval": launches}
        variants = {"warmup": warm["variants"], "simt": train["variants"],
                    "eval": eval_variants}
        conv_entries = phase_conv_times(paths, variants, conv_worst)
        bneck_entries = phase_bneck_times(bench, paths, bneck_worst)
        loss_worst = phase_loss_kernels_vs_plain(rng)
        loss_entries = phase_loss_kernel_times(train["launches"], loss_worst)
        # The train loop last, on the fixtures of the eval and pipeline phases: its
        # profiler session (--profile-dir) and its worker processes come after every
        # kernel timing of the phases above.
        phase_train_loop(tmp, smi, train)

    print(json.dumps({"kernels": [entry, *loss_entries, *conv_entries, *bneck_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
