#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (simt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build: compile every CUDA source of the package with nvcc for sm_90a, in parallel;
     then, in this process before any profiler session (after one, every step is
     slower and its rate noisier), ``tools/soak.py`` at full width (ResNet-101,
     512x1024, 19 + 15 classes, bf16; 200 steps in windows of 50): its line must pass
     (finite metrics, no kernel built and no reserved growth after the warm-up, the
     slowest window above 0.9 x the bench's steps/s), every SimT step B2/B3/B4/B5
     1/1/92/26, all B4/B5 on wgmma; then ``tools/eval_variants.py`` in this process
     (the seeded full-width ResNet-101, 19 + 15 classes, bf16, 512x1024 + 640x1280 ->
     1024x2048: the fused eval head, the same split from the forwards by a synchronize,
     and the unfused upsample/argmax/bincount, 20 timed calls each and their img/s; the
     fused and split histograms equal bit for bit, the unfused one's totals equal and L1
     within 2e-5 H W; B1 1 a fused or split call, none unfused, B4 66 a call) and
     ``tools/tgame.py`` on the card (the toy problem's game for 300 steps under the
     verbatim and paper-faithful forces, finite, T's distance printed; 20 verbatim steps
     against the CPU's, T within 1e-4); then the profiling tools in this process, before
     any phase whose children import torch (``phase_profile_tools``): ``tools/roofline.py``
     at batch 1 and 2 (the step's FLOPs and computed bytes counted on a CPU twin, wall
     and device ms, mfu, mfu_device, the floors), ``tools/profile_trace.py`` of the step
     (device ms by kernel family; the families sum to the total, "other" at most 10% of
     it, the total within 10% of ``timing.profile_steps``' reading of the same step) and
     of the student's forward + backward (B4/B5 59/26 a call), ``tools/profile_step.py``,
     ``profile_model.py``, ``profile_trunk.py`` and ``profile_layer3.py`` (its fused rows
     through B6/B7, its module rows through B4/B5), every SimT step B2/B3/B4/B5
     1/1/92/26, every B4-B7 launch on wgmma, no busy share, mfu or mfu_device above
     1.05; each tool's JSON line printed;
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
     no kernel but the package's own (and fills); the fused eval-mode BatchNorm
     (``bn_act``: BN -> ReLU, BN -> + residual -> ReLU, BN alone) at the trunk's shapes
     (the stem, layers 1-4) of a batch of 16 at 512x1024 and of a batch of 8 at the
     eval's 512x1024 and 640x1280, and on edge cases (channels off the powers of two, a
     tensor smaller than one block, no affine, NaN and inf), each within 1 bf16 ulp of
     its plain version, one device operation a call, and timed (the kernel by the
     profiler, the rest by CUDA events) beside its bytes bound, its plain version and
     ATen's BatchNorm + ReLU (+ add) (``library_ms``);
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
     Every path's launch counts hold ``bn_act`` with the other kernels: 104 a forward
     of an eval-mode trunk on the card (the stem, bn1 / bn2 / bn3 of 33 bottlenecks, 4
     downsamples; two forwards an evaluated image, one the SimT teacher a step, on the
     whole image or on a rank's rows), none in training.
     Each train path: 2 warm-up steps, then 5 timed steps with CUDA-event times of
     their parts, then 3 profiled steps for the device busy share, then the same step
     with every conv2 on cuDNN (a yardstick the port never calls) timed in turns
     against it; and three full-width warmup steps against conv2 on the plain taps;
     after the SimT path, ``tools/planted_noise.py`` in this process at full
     geometry (19 + 15 classes, 512x1024, the four arms, 8 warmup + 4 steps an
     arm): finite logged numbers, the oracle arm's
     t_dist_known at most 1e-4 after every step, the warmup and CE steps B4/B5 66/33
     and the SimT steps on the cached posterior B2/B3/B4/B5 1/1/59/26 a step (all
     wgmma), the teacher routing equal to the CPU's for the seed;
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
     launch order (``tools/bench_fused_bottleneck.py``'s ``time_bneck``); B1 at
     DeepLabv3's eval shapes (batch 4) with its bound by bytes;
  6. the loss core's forward and backward (B2/B3) against their plain versions at the
     train path's shapes (xcat 1x65x129x68 -> 512x1024, C 19 + O 15; batch 1, 2 and 16)
     on four label maps (iid per pixel, constant over 16x16 cells on a grid aligned to
     the warps and on one shifted off it, and the inputs one full-width SimT step hands
     the core), at batch 4 of the eval's 1024x2048, with all labels ignored, every pixel
     unknown, a 37x301 output from 6x39 logits and a planted anchor tie across blocks
     and images, each run twice and bitwise equal; then their times on the four maps
     with every device operation of a call (``tools/bench_loss_fused.py``'s timing: one
     each, or the run fails);
  7. the auxiliary models and stages, after every profiler reading (a run with their
     checks before the eval main path read no B1 launch there): B1 at their eval
     paths' shapes with uint8 gt (DeepLab-VGG's 64x128 + 80x160 logits, DeepLabv3's
     full-resolution 512x1024 + 640x1280 at batch 1 and 4) against its plain version
     and bit for bit against its own arithmetic, run twice; float32 on the card against
     the CPU at small size, the forward and three warmup steps of Res_Deeplab (layers
     (1,1,1,1)), DeepLab-VGG and DeepLabv3 at 64x128 and three adversarial warmup steps,
     and three SimT steps fed from the teacher cache against three uncached ones; at
     full width (``tools/test.py --model``, ``tools/train_warmup.py --model /
     --adversarial``) the two-scale evaluation over the 4 images of Res_Deeplab,
     DeepLab-VGG and DeepLabv3 (batch 4), one B1 a batch and Res_Deeplab's B4 66 an
     image; the warmup step of each (Res_Deeplab B4/B5 66/33 a step, VGG and DeepLabv3
     none) and the adversarial warmup step (DeepLabv2 + FCDiscriminator, B4/B5 66/33), 2
     warm-up and 3 timed steps with their CUDA-event spans; then, with worker
     processes, the SimT step fed from the teacher cache (``build_loader`` over the
     12-image fixture wrapped by ``TeacherCache``): a pass of misses, then turns of 5
     steps cached, uncached, uncached, cached, a hit step's launches B2/B3/B4/B5
     1/1/59/26; ``tools/bench.py --pipeline --cache-teacher`` in a process of its own,
     its JSON line;
  8. the train loop, last (its profiler session and worker processes come after
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
     process of its own, whose trace must name the loss and conv3x3 kernels;
  9. data parallelism (``parallel/mesh.py``), last, each rank a process of its own:
     the SimT CLI for 3 full-width steps in a one-rank NCCL group (``--coordinator``,
     ``--num-processes 1``, ``--process-id 0``, ``--mesh-data 1``) against the same run
     without those flags, the CSV rows and the last snapshot equal bit for bit; two
     ranks sharing the card over gloo, batch 1 each, 3 SimT and 3 warmup steps at full
     width against one process at batch 2 over the same global batches (the ranks'
     states equal bit for bit after every step, the continuous losses within 5e-3
     relative, each module's parameter change within 2e-2 of its norm, each rank's
     launches B2/B3/B4/B5 1/1/92/26 a SimT step and B4/B5 66/33 a warmup step, B1 and
     B6/B7 none), each rank's steps/s and ``grad_sync`` span (two ranks on one card
     measure no scaling); ``evaluate`` sharded over the 4 images and row-split on a
     spatial=2 mesh, each histogram equal bit for bit to one process's, B1 launched on
     each rank;
 10. the spatial axis (H-sharded training), last: B2/B3 on the output bands [0, 256)
     and [256, 512) at full width against their plain band versions and, combined,
     against the whole call (counts, anchors, presence equal); two ranks sharing the
     card over gloo on a (data 1, spatial 2) mesh, each holding half of every image's
     rows: the eval-mode forward's gathered logits against one process's (relative L2
     within five bf16 ulps), then 3 SimT and 3 warmup steps against the parallel
     phase's one process at batch 2 with its gates (states equal bit for bit, losses
     within 5e-3, the first step's module changes), each rank's launches B2/B3/B4/B5
     1/1/92/26 a SimT step and B4/B5 66/33 a warmup step (all wgmma), each rank's peak
     memory below one process's, its steps/s, spans and the rows exchange's host ms;
     then the other two families on the same ranks (``train_warmup --model deeplabv3``
     and ``--model deeplab_vgg``, full width, 19 classes, seeded): each rank's eval-mode
     logits (DeepLabv3's band of the input-size rows, VGG's gathered stride-8 map)
     against one process's (relative L2 within five bf16 ulps), DeepLabv3's row-split
     two-scale evaluation of the 4 images at batch 4 equal to one process's bit for bit
     with one B1 launch a rank, and 3 warmup steps at the global batch of 2 against one
     process (states equal bit for bit after every step, losses within 5e-3, no package
     kernel launched by the steps), each rank's ms a step, rows exchange and peak memory.

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
import functools
import importlib
import itertools
import json
import math
import multiprocessing
import os
import shutil
import socket
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
from simt_tpu_torch.device import PEAK_BF16_FLOP_S, PEAK_BYTES_S  # noqa: E402
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch  # noqa: E402
from simt_tpu_torch.eval import evaluate  # noqa: E402
from simt_tpu_torch.models import (DeeplabSingle, DeeplabVGG, DeepLabv3,  # noqa: E402
                                   FCDiscriminator, ResNetMulti, deeplab_multi,
                                   init_weights, layers)
from simt_tpu_torch.ops.bottleneck import fused_bottleneck  # noqa: E402
from simt_tpu_torch.parallel import (fetch_rows, initialize_multihost,  # noqa: E402
                                     make_mesh, replicate_state, row_block, shard_batch,
                                     spatial_rows)
from simt_tpu_torch.ops.kernels import _build  # noqa: E402
from simt_tpu_torch.ops.kernels import (bn_act, bottleneck, conv3x3, eval_fused,  # noqa: E402
                                         loss_fused)
from simt_tpu_torch.tools import (bench, bench_fused_bottleneck, common,  # noqa: E402
                                  eval_variants, flops, planted_noise, profile_layer3,
                                  profile_model, profile_step, profile_trace,
                                  profile_trunk, roofline, soak, tgame, train_simt,
                                  train_warmup)
from simt_tpu_torch.tools.bench_fused_bottleneck import (BNECK, bneck_calls,  # noqa: E402
                                                         bneck_inputs, time_bneck)
from simt_tpu_torch.tools.bench_conv3x3 import KERNEL_WORD, conv_calls, time_conv  # noqa: E402
from simt_tpu_torch.tools.timing import (checked_launches, cuda_ms,  # noqa: E402
                                         kernel_events, prime_session, profile_kernels,
                                         profile_steps, time_launches, timed_steps)
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
from simt_tpu_torch.train.adversarial import (create_discriminator_state,  # noqa: E402
                                              make_adversarial_warmup_step)
from simt_tpu_torch.train.teacher_cache import TeacherCache  # noqa: E402
from simt_tpu_torch.utils import format_simt_line, format_warmup_line  # noqa: E402

eval_module = importlib.import_module("simt_tpu_torch.eval.evaluate")
SEED = 0
C = 19
OUT_HW = (1024, 2048)
LOGIT_HW = ((65, 129), (81, 161))  # stride-8 maps of the 512x1024 and 640x1280 inputs
N_IMAGES = 4
CUDA = torch.device("cuda")


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
    # One B1 a image; two scales a image, one B4 forward for each of the 33 bottlenecks
    # and one fused BatchNorm for each of the trunk's 104.
    check_counts("eval", launches, {"multiscale_argmax_hist": N_IMAGES,
                                    "conv3x3_fwd": 2 * N_CONV2 * N_IMAGES,
                                    "bn_act": 2 * N_BN * N_IMAGES})
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
    # layers 1-2 are frozen in this stage); the eval-mode teacher's 104 fused BatchNorms.
    return drive_train_path(
        "SimT", step, state, batches,
        lambda i, v: format_simt_line(i, cfg.num_steps, v)
        + f" loss = {v['loss']:.4f}",
        {"loss_core_fwd": want, "loss_core_bwd": want,
         "conv3x3_fwd": (2 * N_CONV2 + N_CONV2_L34) * want,
         "conv3x3_wgrad": N_CONV2_L34 * want, "bn_act": N_BN * want})


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
        drawn_ms = timed_steps(step, state, cycled(drawn), 0, PIPE_STEPS, CUDA, None)
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
    if stage == "simt":  # two scales an image; the teacher's BatchNorms fused
        return {"loss_core_fwd": steps, "loss_core_bwd": steps,
                "conv3x3_fwd": (2 * N_CONV2 + N_CONV2_L34) * steps + 2 * N_CONV2 * images,
                "conv3x3_wgrad": N_CONV2_L34 * steps, "multiscale_argmax_hist": images,
                "bn_act": N_BN * steps + 2 * N_BN * images}
    return {"conv3x3_fwd": 2 * N_CONV2 * steps + N_CONV2 * images,  # one scale
            "conv3x3_wgrad": N_CONV2 * steps, "multiscale_argmax_hist": images,
            "bn_act": N_BN * images}


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


# ---------------------------------------------------------------------------------
# The auxiliary models and stages: Res_Deeplab, DeepLab-VGG, DeepLabv3, the
# adversarial warmup and the teacher-posterior cache
# ---------------------------------------------------------------------------------

AUX_ARCHS = ("deeplab_single", "deeplab_vgg", "deeplabv3")
# The logits B1 takes on each family's eval path: VGG's stride-8 maps (floor-mode pools)
# and DeepLabv3's maps at the input's size, of the 512x1024 and 640x1280 inputs.
AUX_HEAD_HW = {"deeplab_vgg": ((64, 128), (80, 160)),
               "deeplabv3": ((512, 1024), (640, 1280))}
AUX_EVAL_BATCH = {"deeplab_single": 1, "deeplab_vgg": 1, "deeplabv3": 4}  # v3: BASELINE's
AUX_TIMED = 3  # timed steps of each auxiliary train path, after 2 warm-up steps
CACHE_TURN = 5  # steps a turn of the cached / uncached SimT A/B
TOL_AUX = 1e-3  # card vs CPU and cached vs uncached: losses, relative (abs 1e-4)
# Card vs CPU: each module's parameter change over the first small step, relative by
# norm. Random-init batch statistics amplify one-ulp differences from step to step (on
# the CPU alone, one thread and four drift apart over three Res_Deeplab steps), so the
# change is read after the first step.
TOL_CHANGE = 5e-2


def phase_aux_head_vs_plain() -> dict:
    """B1 at the auxiliary eval paths' shapes with uint8 gt, against its plain version
    (equal totals, the L1 bound of ``phase_kernel_vs_plain``) and bit for bit against its
    own arithmetic (``kernel_arithmetic``) and between reruns: VGG's 64x128 + 80x160
    logits at batch 1; DeepLabv3's 512x1024 + 640x1280 at batch 1 and 4 (its eval's
    batch), iid and regions gt. Returns the worst errors at DeepLabv3's shapes."""
    worst = {"max_abs_err": 0, "l1_err": 0}
    cases = {"vgg_batch1": ("deeplab_vgg", 1, "iid"), "v3_batch1": ("deeplabv3", 1, "iid"),
             "v3_batch4": ("deeplabv3", 4, "iid"),
             "v3_batch4_regions": ("deeplabv3", 4, "regions")}
    rng = np.random.default_rng(SEED + 11)
    for name, (arch, batch, gmap) in cases.items():
        hw_a, hw_b = AUX_HEAD_HW[arch]
        la, lb, gt = head_inputs(rng, batch=batch, hw_a=hw_a, hw_b=hw_b, gt=gmap)
        g8 = gt.to(torch.uint8)
        hw = dict(out_hw=OUT_HW, num_classes=C)
        exact = kernel_arithmetic(la, lb, gt, **hw)
        want = eval_fused.multiscale_argmax_hist_reference(la, lb, gt, **hw)
        runs = [eval_fused.multiscale_argmax_hist(la, lb, g8, **hw) for _ in range(2)]
        torch.cuda.synchronize()
        got, want = runs[0].cpu().long(), want.cpu().long()
        counted = int(((gt >= 0) & (gt < C)).sum())
        l1, mx = int((got - want).abs().sum()), int((got - want).abs().max())
        limit = max(2.0, 2e-5 * OUT_HW[0] * OUT_HW[1] * batch)
        ok = int(got.sum()) == int(want.sum()) == counted and l1 <= limit
        same = all(torch.equal(r, exact) for r in runs)
        sched = eval_fused.schedule(*hw_a, *hw_b, OUT_HW, C, batch)
        print(f"eval_fused vs plain [{name}: la {batch}x{hw_a[0]}x{hw_a[1]}x{C}, lb "
              f"{batch}x{hw_b[0]}x{hw_b[1]}x{C}, {gmap} uint8 gt]: total {int(got.sum())}/"
              f"{int(want.sum())} (counted {counted}), L1 {l1} (limit {limit:.0f}), max abs "
              f"{mx}: {'ok' if ok else 'MISMATCH'}; both runs equal to its own arithmetic "
              f"bit for bit: {'yes' if same else 'NO'}; schedule {len(sched.blocks)} "
              f"blocks, {sched.smem} B shared memory a block")
        if not (ok and same):
            fail(f"eval_fused at {name}: plain {'ok' if ok else 'MISMATCH'}, own arithmetic "
                 f"{'ok' if same else 'DIFFERS'}")
        if arch == "deeplabv3":
            worst["max_abs_err"] = max(worst["max_abs_err"], mx)
            worst["l1_err"] = max(worst["l1_err"], l1)
        del la, lb, gt, g8, exact
        torch.cuda.empty_cache()
    return worst


def aux_config(arch: str, argv=()) -> TrainConfig:
    """The warmup-stage config that ``tools/train_warmup.py --synthetic --model arch``
    builds, with ``argv`` added (bf16, the 512x1024 crop)."""
    args = train_warmup.build_parser().parse_args(["--synthetic", "--model", arch, *argv])
    return train_warmup.build_config(args)


def _rel_ok(got: float, want: float) -> bool:
    return math.isfinite(got) and abs(got - want) <= max(1e-4, TOL_AUX * abs(want))


def _changes_by_module(model: torch.nn.Module, start: dict) -> dict:
    """Each top-level module's change of its trained parameters (``requires_grad``)
    from ``start``, flattened into one float32 CPU vector."""
    out = {}
    for k, p in model.named_parameters():
        if p.requires_grad:
            out.setdefault(k.split(".")[0], []).append(
                (p.detach().cpu() - start[k]).flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def _changes_agree(got: dict, want: dict) -> Tuple[bool, float]:
    """Every module's change on the card within ``TOL_CHANGE`` of the CPU's by norm,
    and every one moved; also the worst relative error."""
    if got.keys() != want.keys() or not want:
        return False, math.inf
    worst, ok = 0.0, True
    for k, w in want.items():
        n = float(w.norm())
        rel = float((got[k] - w).norm()) / n if n > 0 else math.inf
        worst = max(worst, rel)
        ok = ok and n > 0 and rel <= TOL_CHANGE
    return ok, worst


def _small_models(arch: str, c: int):
    if arch == "deeplab_single":
        return DeeplabSingle(c, layers=(1, 1, 1, 1), dtype=torch.float32)
    if arch == "deeplab_vgg":
        return DeeplabVGG(c, dtype=torch.float32)
    return DeepLabv3(c, dtype=torch.float32)


def phase_aux_small(tmp: str) -> None:
    """float32, card against CPU at small geometry (C5, 64x128; Res_Deeplab at layers
    (1,1,1,1)): each new model's eval forward (within 1e-3 of the output's largest
    magnitude), three warmup steps of each new arch and three adversarial warmup steps
    (losses within 1e-3 relative, abs 1e-4; with no weight decay, so that a change
    comes from the gradients alone, each top-level module's change of its trained parameters
    over the first step within ``TOL_CHANGE`` of the CPU's by norm, and every one moved);
    three SimT steps (the golden geometry) fed
    from the teacher cache (float32 storage) against three uncached ones on the card
    (losses within 1e-3)."""
    c, hw = 5, (64, 128)
    batches = [synthetic_batch(1, hw, c, seed=SEED + i) for i in range(3)]
    x = torch.from_numpy(batches[0]["image"]).permute(0, 3, 1, 2)
    ok = True
    for arch in AUX_ARCHS:
        model = init_weights(_small_models(arch, c), torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            want = model.eval()(x)
            got = copy.deepcopy(model).cuda().eval()(
                x.cuda().contiguous(memory_format=torch.channels_last))
        want, got = (t[0] if isinstance(t, tuple) else t for t in (want, got))
        err = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        f_ok = got.shape == want.shape and err <= TOL_AUX
        cfg = TrainConfig(stage="warmup", model=ModelConfig(
            arch=arch, num_classes=c, compute_dtype="float32"),
            optim=OptimConfig(num_steps=1000, weight_decay=0.0))
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        losses, moved = {}, {}
        for dev in ("cpu", "cuda"):
            st = create_warmup_state(copy.deepcopy(model), cfg, dev)
            step = make_warmup_step(cfg)
            losses[dev] = []
            for i, b in enumerate(batches):
                losses[dev].append({k: float(v) for k, v in step(st, b).items()})
                if i == 0:
                    moved[dev] = _changes_by_module(st.model, start)
        s_ok = all(_rel_ok(g[k], w[k]) for g, w in zip(losses["cuda"], losses["cpu"])
                   for k in ("loss_seg1", "loss_seg2"))
        p_ok, p_err = _changes_agree(moved["cuda"], moved["cpu"])
        print(f"small {arch}: forward cuda vs cpu within {err:.2e} of its max (limit "
              f"{TOL_AUX:g}); 3 warmup steps loss_seg2 cuda "
              f"{[round(m['loss_seg2'], 6) for m in losses['cuda']]} cpu "
              f"{[round(m['loss_seg2'], 6) for m in losses['cpu']]}; step 1's change of "
              f"{', '.join(sorted(moved['cpu']))} within {p_err:.2e} of the CPU's by norm "
              f"(limit {TOL_CHANGE:g}): {'ok' if f_ok and s_ok and p_ok else 'MISMATCH'}")
        ok = ok and f_ok and s_ok and p_ok

    cfg = TrainConfig(stage="warmup", model=ModelConfig(num_classes=c,
                                                        compute_dtype="float32"),
                      optim=OptimConfig(num_steps=1000, weight_decay=0.0))
    seg = init_weights(ResNetMulti(c, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32),
                       torch.Generator().manual_seed(SEED))
    disc = init_weights(FCDiscriminator(c, dtype=torch.float32),
                        torch.Generator().manual_seed(SEED + 1))
    starts = [{k: p.detach().clone() for k, p in m.named_parameters()} for m in (seg, disc)]
    losses, moved = {}, {}
    for dev in ("cpu", "cuda"):
        st = create_warmup_state(copy.deepcopy(seg), cfg, dev)
        d = create_discriminator_state(copy.deepcopy(disc), dev)
        step = make_adversarial_warmup_step(cfg)
        losses[dev] = []
        for i, b in enumerate(batches):
            losses[dev].append({k: float(v) for k, v in step(st, d, b).items()})
            if i == 0:
                moved[dev] = {f"{who}.{k}": v for who, m, start in (
                    ("seg", st.model, starts[0]), ("D", d.model, starts[1]))
                              for k, v in _changes_by_module(m, start).items()}
    p_ok, p_err = _changes_agree(moved["cuda"], moved["cpu"])
    a_ok = p_ok and all(_rel_ok(g[k], w[k]) for g, w in zip(losses["cuda"], losses["cpu"])
                        for k in ("loss_seg1", "loss_seg2", "loss_adv"))
    print(f"small adversarial warmup: 3 steps loss_adv cuda "
          f"{[round(m['loss_adv'], 6) for m in losses['cuda']]} cpu "
          f"{[round(m['loss_adv'], 6) for m in losses['cpu']]}, loss_seg2 cuda "
          f"{[round(m['loss_seg2'], 6) for m in losses['cuda']]} cpu "
          f"{[round(m['loss_seg2'], 6) for m in losses['cpu']]}; step 1's change of "
          f"the segmenter's and D's modules within {p_err:.2e} of the CPU's by norm (limit "
          f"{TOL_CHANGE:g}): {'ok' if a_ok else 'MISMATCH'}")

    gcfg = golden_config(tmp)
    gc, go = gcfg.model.num_classes, gcfg.model.open_classes
    student = init_weights(ResNetMulti(gc, go, True, layers=(1, 1, 1, 1),
                                       dtype=torch.float32),
                           torch.Generator().manual_seed(SEED))
    teacher = init_weights(ResNetMulti(gc, 0, False, layers=(1, 1, 1, 1),
                                       dtype=torch.float32),
                           torch.Generator().manual_seed(SEED + 1))
    named = [{k: torch.from_numpy(v).cuda() for k, v in
              synthetic_batch(1, (32, 64), gc, seed=SEED + i).items()} for i in range(3)]
    out = {}
    for cached in (False, True):
        st = create_simt_state(copy.deepcopy(student), copy.deepcopy(teacher), gcfg,
                               torch.Generator().manual_seed(SEED + 2), "cuda")
        cache = TeacherCache(st.teacher, store_dtype=torch.float32)
        step = make_simt_step(gcfg)
        feed = [cache.attach({**b, "name": [str(i)], "mirror": [False]}) if cached else b
                for i, b in enumerate(named)]
        out[cached] = [{k: float(v) for k, v in step(st, b).items()} for b in feed]
    c_ok = all(_rel_ok(g[k], w[k]) for g, w in zip(out[True], out[False])
               for k in ("loss", "loss_seg_p", "loss_seg_y", "anchor", "place"))
    print(f"small SimT steps on the card, teacher cache (float32 storage) vs teacher "
          f"forward: loss {[round(m['loss'], 6) for m in out[True]]} vs "
          f"{[round(m['loss'], 6) for m in out[False]]}: {'ok' if c_ok else 'MISMATCH'}")
    if not (ok and a_ok and c_ok):
        fail("an auxiliary model or stage on the card disagrees with the CPU at small size")


def phase_aux_eval(tmp: str) -> dict:
    """The two-scale ``evaluate(device="cuda")`` of each auxiliary family at full width
    (seeded random weights, built as ``tools/test.py --model`` builds it: simt mode,
    DeepLabv3 open-set, its 34 channels sliced to 19) over the main path's 4 synthetic
    2048x1024 images, after one warm-up pass; DeepLabv3 at batch 4. Launch counts held
    to each path's own: one B1 a batch into the running histogram; Res_Deeplab's 33
    bottleneck conv2s on B4 and its 104 BatchNorms fused at each scale; none for VGG
    and DeepLabv3 (cuDNN, ATen)."""
    paths = {"root": os.path.join(tmp, "full"),
             "val_txt": os.path.join(tmp, "full", "lists", "val.txt"),
             "gt_dir": os.path.join(tmp, "full", "label")}
    out = {}
    for arch in AUX_ARCHS:
        args = train_simt.build_parser().parse_args(["--model", arch])
        cfg = common.build_config(args, stage="simt")
        model, _ = loop.build_models(cfg)
        batch = AUX_EVAL_BATCH[arch]
        kw = dict(data_root=paths["root"], val_list=paths["val_txt"],
                  gt_dir=paths["gt_dir"], mode="simt", return_hist=True, device="cuda",
                  batch_size=batch, print_fn=lambda s: None)
        evaluate(model, **kw)  # warm-up: cuDNN plans, allocator
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, hist = evaluate(model, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, variants = read_counts(), read_variants()
        calls = N_IMAGES // batch
        want = {"multiscale_argmax_hist": calls}
        if arch == "deeplab_single":
            want.update(conv3x3_fwd=2 * N_CONV2 * N_IMAGES, bn_act=2 * N_BN * N_IMAGES)
        print(f"main path: evaluate(simt, two scales) of {arch} (tools/test.py --model "
              f"{arch}), batch {batch}, over {N_IMAGES} 2048x1024 images: {seconds:.3f} s, "
              f"{N_IMAGES / seconds:.3f} img/s, mIoU {miou}, "
              f"{sum(p.numel() for p in model.parameters())} parameters")
        check_counts(f"eval {arch}", launches, want)
        check_wgmma(f"eval {arch}", variants)
        if hist.sum() != N_IMAGES * OUT_HW[0] * OUT_HW[1] or not math.isfinite(miou):
            fail(f"eval {arch}: histogram total {hist.sum()} or mIoU {miou} is wrong")
        out[arch] = {"launches": launches, "seconds": seconds, "batch": batch}
        del model
        torch.cuda.empty_cache()
    return out


def drive_aux_path(path: str, call, step, want: dict) -> dict:
    """2 warm-up calls of ``call(i)`` (one train step on batch i), then every launch
    count zeroed, AUX_TIMED timed calls with the step's CUDA-event spans, the counts read
    and held to ``want`` (a step's launches), the metrics finite."""
    for i in range(2):
        call(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step.spans = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [call(2 + i) for i in range(AUX_TIMED)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / AUX_TIMED * 1e3
    launches, variants = read_counts(), read_variants()
    parts = {}
    for name, start, end in step.spans:
        parts[name] = parts.get(name, 0.0) + start.elapsed_time(end) / AUX_TIMED
    step.spans = None
    vals = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in vals for v in m.values()):
        fail(f"{path}: non-finite metrics {vals}")
    print(f"main path: {path}, full width, batch 1, 512x1024, bf16 autocast: {AUX_TIMED} "
          f"steps, {wall_ms:.3f} ms per step, {1e3 / wall_ms:.3f} steps/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; parts (CUDA events, ms per "
          "step): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; last metrics {vals[-1]}")
    check_counts(path, launches, {k: v * AUX_TIMED for k, v in want.items()})
    check_wgmma(path, variants)
    return {"wall_ms": wall_ms, "parts": parts, "launches": launches,
            "metrics": vals[-1]}


def phase_aux_warmup() -> dict:
    """The warmup step of each auxiliary family and the adversarial warmup step
    (DeepLabv2 + FCDiscriminator) at full width through ``tools/train_warmup.py``'s
    config and ``loop.build_models`` (seeded random weights, synthetic 512x1024
    batches). Launches a step: Res_Deeplab and the adversarial DeepLabv2 B4 66 (33
    forward + 33 input gradients) and B5 33, as the DeepLabv2 warmup; VGG and
    DeepLabv3 none."""
    out = {}
    for arch in AUX_ARCHS:
        cfg = aux_config(arch)
        state = create_warmup_state(loop.build_models(cfg)[0], cfg, "cuda")
        batches = train_simt.synthetic_batches(cfg, 4, torch.device("cuda"))
        step = make_warmup_step(cfg)
        want = ({"conv3x3_fwd": 2 * N_CONV2, "conv3x3_wgrad": N_CONV2}
                if arch == "deeplab_single" else {})
        out[arch] = drive_aux_path(f"warmup step ({arch})",
                                   lambda i: step(state, batches[i % 4]), step, want)
        del state
        torch.cuda.empty_cache()
    cfg = aux_config("deeplab_multi", ["--adversarial"])
    state = create_warmup_state(loop.build_models(cfg)[0], cfg, "cuda")
    disc = init_weights(FCDiscriminator(cfg.model.num_classes),
                        torch.Generator().manual_seed(cfg.random_seed + 1))
    d_state = create_discriminator_state(disc, "cuda")
    batches = train_simt.synthetic_batches(cfg, 4, torch.device("cuda"))
    step = make_adversarial_warmup_step(cfg)
    out["adversarial"] = drive_aux_path(
        "adversarial warmup step (DeepLabv2 + FCDiscriminator)",
        lambda i: step(state, d_state, batches[i % 4]), step,
        {"conv3x3_fwd": 2 * N_CONV2, "conv3x3_wgrad": N_CONV2})
    del state, d_state
    torch.cuda.empty_cache()
    return out


def phase_aux_head_times() -> dict:
    """B1 at DeepLabv3's eval shapes (512x1024 + 640x1280 logits, batch 4, uint8 gt with
    ``out=``, as ``evaluate`` calls it), timed as ``phase_kernel_times`` times the main
    path's: the wrapper (events), its kernel (profiler), its device operations (one or
    the run fails), the bound (bytes here: each image's ~94 MB of float32 logits), the
    plain version and the library chain (interpolate x2, argmax, bincount). Returns the
    kernels line's entry; ``launches`` and the errors against the plain version are
    added by the eval and check phases that run later."""
    hw_a, hw_b = AUX_HEAD_HW["deeplabv3"]
    batch = AUX_EVAL_BATCH["deeplabv3"]
    la, lb, gt = head_inputs(np.random.default_rng(SEED), batch=batch, hw_a=hw_a,
                             hw_b=hw_b)
    r = time_launches({"uint8": head_calls(eval_fused, la, lb, gt)["uint8"]},
                      HEAD_WORD)["uint8"]
    r.update(head_bound(gt, 1, hw_a, hw_b))
    sched = eval_fused.schedule(*hw_a, *hw_b, OUT_HW, C, batch)
    print(f"multiscale_argmax_hist [DeepLabv3 eval, batch {batch}, uint8 gt, out=]: wrapper "
          f"{r['ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms ({r['kernel_ms'] / batch:.4f} "
          f"an image), {r['device_ops']} device operation(s) a call; host "
          f"{r['host_us']:.1f} us; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bytes']} bytes, {r['ops']} operations); {len(sched.blocks)} blocks of "
          f"{sched.threads} threads, {sched.smem} B shared memory each")
    if r["launches"] != 1 or r["device_ops"] != 1:
        fail(f"multiscale_argmax_hist at DeepLabv3's shapes: {r['device_ops']} device "
             "operations a call, want its kernel alone")
    plain_ms = cuda_ms(lambda: eval_fused.multiscale_argmax_hist_reference(
        la, lb, gt, out_hw=OUT_HW, num_classes=C), iters=3, warmup=1)
    la_nchw, lb_nchw = (t.permute(0, 3, 1, 2).contiguous() for t in (la, lb))

    def library():
        up = F.interpolate(la_nchw, size=OUT_HW, mode="bilinear", align_corners=True)
        up = up + F.interpolate(lb_nchw, size=OUT_HW, mode="bilinear", align_corners=True)
        pred = up.argmax(1).reshape(-1)
        g = gt.reshape(-1)
        k = (g >= 0) & (g < C)
        return torch.bincount(C * g[k] + pred[k], minlength=C * C)

    library_ms = cuda_ms(library, iters=3, warmup=1)
    print(f"multiscale_argmax_hist [DeepLabv3 eval]: plain {plain_ms:.3f} ms, library "
          f"chain {library_ms:.3f} ms")
    return {
        "name": "multiscale_argmax_hist_deeplabv3", "route": "cuda",
        "source": "simt_tpu_torch/csrc/eval_fused.cu",
        "replaces": "simt_tpu/ops/pallas/eval_fused.py:35",
        "launches": None, "max_abs_err": None, "l1_err": None,
        "ms": r["ms"], "kernel_ms": r["kernel_ms"], "kernel_ms_by": r["kernel_ms_by"],
        "device_ops": r["device_ops"], "host_us": r["host_us"], "plain_ms": plain_ms,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": library_ms,
        "bytes": r["bytes"], "ops": r["ops"], "blocks": len(sched.blocks),
        "smem_bytes": sched.smem,
        "shape": f"la {batch}x{hw_a[0]}x{hw_a[1]}x19 f32, lb {batch}x{hw_b[0]}x{hw_b[1]}x19 "
                 f"f32, gt {batch}x1024x2048 u8 -> 19x19 i32 (accumulated in place)",
    }


def phase_aux_teacher_cache(tmp: str, resident: dict) -> dict:
    """The SimT step fed from the teacher cache at full width: ``build_loader`` over the
    pipeline fixture's 12 images (4 process workers, the mirror off so that one pass
    meets every key), wrapped by ``TeacherCache`` as ``train()`` wraps it. One pass of
    misses (the teacher runs in ``attach``), then every launch count zeroed and turns of
    CACHE_TURN steps, cached, uncached, uncached, cached (the uncached steps take the
    same loader batches without ``teacher_prob8``), with the steps' CUDA-event spans.
    A hit step's launches: B2 1, B3 1, B4 59 (the student's 33 forwards and 26 input
    gradients), B5 26 and no fused BatchNorm; an uncached step's: the resident path's
    (B4 92, the teacher's 104 fused BatchNorms)."""
    cfg, state, step = simt_main_setup(tmp)
    paths = {"root": os.path.join(tmp, "pipeline"),
             "pseudo_lst": os.path.join(tmp, "pipeline", "lists", "pseudo.lst")}
    pcfg = bench.pipeline_config(cfg, paths["root"], paths["pseudo_lst"], TRAIN_HW)
    pcfg = pcfg.replace(data=dataclasses.replace(pcfg.data, mirror=False),
                        simt=dataclasses.replace(pcfg.simt, cache_teacher=True))
    raw = build_loader(pcfg, device="cuda")
    out = {}
    try:
        cache = TeacherCache(state.teacher, mean_bgr=pcfg.data.mean_bgr)
        feed = cache.wrap(raw)
        t0 = time.perf_counter()
        for _ in range(12):
            m = step(state, next(feed))
        float(m["loss"])
        print(f"teacher cache: one pass of 12 images in {time.perf_counter() - t0:.1f} s "
              f"(worker start-up included): {cache.misses} misses, {cache.hits} hits, "
              f"{len(cache)} entries")
        per_step = {k: v // TIMED_STEPS for k, v in resident["launches"].items()}
        hit_step = dict(per_step, conv3x3_fwd=per_step["conv3x3_fwd"] - N_CONV2,
                        bn_act=per_step["bn_act"] - N_BN)
        turns = {"cached": [], "uncached": []}
        parts = {"cached": {}, "uncached": {}}
        for mode in ("cached", "uncached", "uncached", "cached"):
            batches = [next(feed) for _ in range(CACHE_TURN)]
            if mode == "uncached":
                batches = [{k: b[k] for k in ("image", "label")} for b in batches]
            torch.cuda.synchronize()
            reset_counts()
            step.spans = []
            t0 = time.perf_counter()
            for b in batches:
                m = step(state, b)
            torch.cuda.synchronize()
            turns[mode].append((time.perf_counter() - t0) / CACHE_TURN * 1e3)
            for name, start, end in step.spans:
                parts[mode][name] = (parts[mode].get(name, 0.0)
                                     + start.elapsed_time(end) / (2 * CACHE_TURN))
            step.spans = None
            if not math.isfinite(float(m["loss"])):
                fail(f"teacher cache ({mode}): non-finite loss {float(m['loss'])}")
            check_counts(f"SimT step, {mode}", read_counts(),
                         {k: v * CACHE_TURN for k, v in
                          (hit_step if mode == "cached" else per_step).items()})
        if cache.misses != 12 or cache.hits != 2 * CACHE_TURN * 2:
            fail(f"teacher cache: {cache.misses} misses, {cache.hits} hits after the "
                 f"first pass (want 12 and {4 * CACHE_TURN})")
    finally:
        raw.close()
    for mode in turns:
        print(f"main path: SimT step from build_loader, {mode} teacher, full width, batch 1, "
              f"512x1024, in turns (cached, uncached, uncached, cached) of {CACHE_TURN} "
              f"steps: {turns[mode][0]:.3f} / {turns[mode][1]:.3f} ms per step; parts (CUDA "
              "events, ms per step): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts[mode].items()))
        out[mode] = {"wall_ms": turns[mode], "parts": parts[mode]}
    out["hits"], out["misses"] = cache.hits, cache.misses
    del state
    torch.cuda.empty_cache()
    return out


def phase_aux_bench_cli(tmp: str) -> str:
    """``python -m simt_tpu_torch.tools.bench --pipeline --cache-teacher`` in a process
    of its own, as a user runs it (the JAX bench's 14 + 50 steps on its own 12-image
    fixture): its one JSON line on stdout, with the ``_teacher_cache`` metric."""
    res = subprocess.run([sys.executable, "-m", "simt_tpu_torch.tools.bench", "--pipeline",
                          "--cache-teacher"], cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    if res.returncode or len(lines) != 1:
        fail(f"bench --pipeline --cache-teacher exited {res.returncode}: "
             f"{res.stdout[-1000:]} {res.stderr[-2000:]}")
    line = json.loads(lines[0])
    if line["metric"] != ("simt_train_steps_per_sec_bs1_512x1024_with_input_pipeline"
                          "_teacher_cache") or not line["value"] > 0:
        fail(f"bench --pipeline --cache-teacher: {line}")
    info = [s for s in res.stderr.splitlines() if "teacher cache:" in s or "busy share" in s]
    print(f"bench --pipeline --cache-teacher: {lines[0]}; " + "; ".join(info))
    return lines[0]


# Every kernel wrapper of the package, by name; each counts its own launches.
COUNTED = {"multiscale_argmax_hist": eval_fused.multiscale_argmax_hist,
           "loss_core_fwd": loss_fused.loss_core_fwd,
           "loss_core_bwd": loss_fused.loss_core_bwd,
           "conv3x3_fwd": conv3x3.conv3x3_fwd,
           "conv3x3_wgrad": conv3x3.conv3x3_wgrad,
           "bottleneck_fwd": bottleneck.bottleneck_fwd,
           "bottleneck_bwd": bottleneck.bottleneck_bwd,
           "bn_act": bn_act.bn_act}


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


def cycled(batches: list, first: int = 0):
    """``next_batch`` for ``timing.timed_steps``: ``batches[first:]``, then round again."""
    return functools.partial(next, itertools.islice(itertools.cycle(batches), first, None))


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
    timed = []
    wall_ms = timed_steps(step, state, cycled(batches, 2), 0, TIMED_STEPS, CUDA, None,
                          timed)
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
N_BN = 1 + 3 * N_CONV2 + 4  # BatchNorms a ResNet-101 forward: stem, 3 a block, 4 downsample
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
            wall[mode].append(timed_steps(step, state, cycled(batches), 0, TIMED_STEPS,
                                          CUDA, None))
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


# ---------------------------------------------------------------------------------
# The fused eval-mode BatchNorm (bn_act): BN -> ReLU, BN -> + residual -> ReLU, BN alone
# ---------------------------------------------------------------------------------

# (case, batch, H, W, C, variant) at the main paths' shapes: the SimT teacher's batch of
# 16 at 512x1024 (stem 256x512, layer1 129x257, layers 2-4 65x129) and the eval's batch
# of 8 at both its scales, 512x1024 and 640x1280 (stem 320x640, layer1 161x321, layers
# 2-4 81x161); bn1 / bn2 take the block's planes, bn3 and the downsample 4x (layer2's
# first block strides 2 in conv1 and in its downsample, so all of its BatchNorms sit at
# the smaller grid).
BN_CASES = [(f"{tag}_{name}", b, h, w, c, v)
            for tag, b, geo in (("b16", 16, ((256, 512), (129, 257), (65, 129))),
                                ("eval512_b8", 8, ((256, 512), (129, 257), (65, 129))),
                                ("eval640_b8", 8, ((320, 640), (161, 321), (81, 161))))
            for name, (h, w), c, v in (
                ("stem", geo[0], 64, "relu"),
                ("layer1_bn1", geo[1], 64, "relu"), ("layer1_bn3", geo[1], 256, "add"),
                ("layer1_downsample", geo[1], 256, "alone"),
                ("layer2_bn1", geo[2], 128, "relu"), ("layer2_bn3", geo[2], 512, "add"),
                ("layer2_downsample", geo[2], 512, "alone"),
                ("layer3_bn1", geo[2], 256, "relu"), ("layer3_bn3", geo[2], 1024, "add"),
                ("layer3_downsample", geo[2], 1024, "alone"),
                ("layer4_bn1", geo[2], 512, "relu"), ("layer4_bn3", geo[2], 2048, "add"),
                ("layer4_downsample", geo[2], 2048, "alone"))]
# Off the main path: channels off the powers of two (a grid of a multiple of 3 blocks),
# fewer vectors than one block's threads, BatchNorm without an affine, NaN and inf.
BN_EDGE = [("edge_c24_odd", 3, 7, 13, 24, "add"), ("edge_tiny", 1, 1, 3, 16, "relu"),
           ("edge_no_affine", 2, 9, 11, 64, "alone"), ("edge_nan_inf", 2, 5, 7, 32, "add")]


def bn_inputs(b: int, h: int, w: int, c: int, variant: str, seed: int,
              affine: bool = True) -> dict:
    """Seeded ``bn_act`` arguments on the card: x and the residual N(0, 1) bf16
    channels_last, running mean N(0, 0.25), variance U(0.5, 2), weight U(0.5, 1.5), bias
    N(0, 0.04), eps 1e-5."""
    g = torch.Generator(device=CUDA).manual_seed(seed)
    act = dict(device=CUDA, generator=g)

    def image():
        return torch.randn((b, c, h, w), **act).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    return {"x": image(), "mean": torch.randn(c, **act) * 0.5,
            "var": torch.rand(c, **act) * 1.5 + 0.5,
            "weight": torch.rand(c, **act) + 0.5 if affine else None,
            "bias": torch.randn(c, **act) * 0.2 if affine else None, "eps": 1e-5,
            "residual": image() if variant == "add" else None,
            "relu": variant != "alone"}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 steps between ``a`` and ``b`` (bf16) at any element: the bit patterns
    mapped onto a line that orders the values (+0 and -0 alike); a NaN in both counts
    0, in one a huge distance."""
    def line(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    d = (line(a) - line(b)).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, 0, torch.where(na ^ nb, 1 << 16, d))
    return int(d.max())


def library_bn(kw: dict):
    """ATen's eval-mode BatchNorm, then the add and the ReLU: the port's composition."""
    out = F.batch_norm(kw["x"], kw["mean"], kw["var"], kw["weight"], kw["bias"], False,
                       0.0, kw["eps"])
    if kw["residual"] is not None:
        out = out + kw["residual"]
    return torch.relu_(out) if kw["relu"] else out


def phase_bn_act() -> list:
    """``bn_act`` at the main paths' shapes and on edge cases against its plain version
    (within 1 bf16 ulp, twice, one device operation a call), then timed at the main
    paths' shapes: ``ms`` by CUDA events beside its bytes bound at the HBM rate, the
    plain version and ATen's composition (``library_ms``). Returns the kernels line's
    entries."""
    fused = bn_act.bn_act
    out, rows = [], []
    for i, (name, b, h, w, c, v) in enumerate(BN_CASES + BN_EDGE):
        kw = bn_inputs(b, h, w, c, v, SEED + i, affine=name != "edge_no_affine")
        if name == "edge_nan_inf":
            flat = kw["x"].permute(0, 2, 3, 1).view(-1)  # NHWC: its memory, in order
            flat[::97] = float("nan")
            flat[5::89] = float("inf")
            flat[7::83] = float("-inf")
        args = [kw[k] for k in ("x", "mean", "var", "weight", "bias", "eps")]
        call = functools.partial(fused, *args, residual=kw["residual"], relu=kw["relu"])
        got, again = call(), call()
        want = bn_act.bn_act_plain(*args, residual=kw["residual"], relu=kw["relu"])
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, want)
        same = torch.equal(got.view(torch.int16), again.view(torch.int16))
        layout = got.is_contiguous(memory_format=torch.channels_last)
        print(f"bn_act {name} ({b}x{c}x{h}x{w}, {v}): {ulps} bf16 ulp from the plain "
              f"version, rerun {'equal' if same else 'DIFFERS'}")
        if ulps > 1 or not same or not layout:
            fail(f"bn_act {name}: {ulps} ulp from its plain version (limit 1), rerun "
                 f"equal {same}, channels_last {layout}")
        if name.startswith("edge"):
            continue
        t = time_launches({name: call}, "bn_fw_act")[name]
        if t["launches"] != 1 or t["device_ops"] != 1:
            fail(f"bn_act {name}: {t['device_ops']} device operations a call "
                 f"({t['launches']} of its kernel), want its kernel alone")
        nbytes = bn_act.work(kw["x"].numel(), kw["residual"] is not None)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        plain_ms = cuda_ms(lambda: bn_act.bn_act_plain(*args, residual=kw["residual"],
                                                       relu=kw["relu"]), 5)
        library_ms = cuda_ms(lambda: library_bn(kw), 20)
        share = bound_ms / t["kernel_ms"]
        rows.append(f"  {name}: kernel {t['kernel_ms']:.4f} ms (wrapper {t['ms']:.4f}, "
                    f"host {t['host_us']:.1f} us), bound {bound_ms:.4f} ms ({share:.1%} of "
                    f"it, {nbytes / t['kernel_ms'] / 1e6:.0f} GB/s), plain {plain_ms:.4f}, "
                    f"library {library_ms:.4f} ms ({library_ms / t['kernel_ms']:.2f}x)")
        out.append({"kernel": f"bn_act {name}", "shape": [b, c, h, w], "variant": v,
                    "ms": t["ms"], "kernel_ms": t["kernel_ms"], "bound_ms": bound_ms,
                    "bound_share": share, "plain_ms": plain_ms, "library_ms": library_ms,
                    "host_us": t["host_us"], "max_ulp": ulps})
        del kw, args, call, got, again, want
    print("bn_act times (H100 at 3.35 TB/s; kernel by the profiler):\n" + "\n".join(rows))
    torch.cuda.empty_cache()
    return out


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
        prime_session()
        out, _ = fused_bottleneck(x, *ws, *vecs, d)
        torch.autograd.grad(out, (x, *ws), dy)
        torch.cuda.synchronize()
    names = {}
    for e in kernel_events(prof):
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


# ---------------------------------------------------------------------------------
# Data parallelism: ranks over torch.distributed, last of all
# ---------------------------------------------------------------------------------

PAR_WORLD = 2  # two ranks sharing the one card over gloo (NCCL takes one rank a device)
PAR_STEPS = 3  # train steps of each stage, from the seeded initialisation
# The continuous losses against one process at batch 2: |a - b| <= 5e-3 max(1, |b|)
# (tests/test_multihost.py's bound).
TOL_PAR_LOSS = 5e-3
# Each module's parameter change after the first step, by the norm of the reference's:
# 2e-2, or twice the reference's own spread where that is larger. The spread is the
# same process's change with the batch's two images swapped, the same sums in another
# order: the random-init trunk's batch-statistic gradient does not reproduce under it
# (the stem and layers 1-3 1.37-1.42 of its norm, layer4 0.78-0.91, the heads
# 0.007-0.07, printed by this phase).
TOL_PAR_CHANGE = 2e-2
PAR_CONTINUOUS = {"SimT": ("loss_seg_p", "loss_seg_y", "convex", "volume"),
                  "warmup": ("loss_seg1", "loss_seg2")}
PAR_COUNTS = {"SimT": {"loss_core_fwd": 1, "loss_core_bwd": 1,  # launches a step
                       "conv3x3_fwd": 2 * N_CONV2 + N_CONV2_L34,
                       "conv3x3_wgrad": N_CONV2_L34, "bn_act": N_BN},
              "warmup": {"conv3x3_fwd": 2 * N_CONV2, "conv3x3_wgrad": N_CONV2}}


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def par_setup(tmp: str, stage: str, argv=()):
    """The full-width config (global batch 2, ``argv``'s mesh flags), seeded models and
    state of ``stage`` on the current card, through the CLIs' own calls; and the
    ``PAR_STEPS`` global batches (the same on every rank and in the reference)."""
    if stage == "SimT":
        cfg = train_simt.build_config(train_simt.build_parser().parse_args(
            ["--preset", "simt_bapa_lr25", *argv]))
        cd = os.path.join(tmp, "cd_uniform.npy")
        np.save(cd, (np.ones(C) / C).astype(np.float32))
        cfg = cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=cd))
    else:
        cfg = train_warmup.build_config(train_warmup.build_parser().parse_args(list(argv)))
    per_shard = 2 // cfg.mesh.data_axis  # DataConfig.batch_size is per data shard
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=per_shard))
    whole = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2))
    batches = train_simt.synthetic_batches(whole, PAR_STEPS, torch.device("cuda"))
    student, teacher = loop.build_models(cfg)
    if stage == "SimT":
        state = create_simt_state(student, teacher, cfg,
                                  torch.Generator().manual_seed(cfg.random_seed + 2), "cuda")
    else:
        state = create_warmup_state(student, cfg, "cuda")
    return cfg, state, batches


def _bits(state) -> torch.Tensor:
    """Every parameter and buffer of the trained model (and the NTM / W parameters) as
    one int32 vector: equal vectors are equal bit for bit."""
    ts = [p.detach() for p in state.model.parameters()] + list(state.model.buffers())
    if hasattr(state, "t1"):
        ts += [getattr(state, k).param.detach() for k in ("t1", "t2", "w1", "w2")]
    return torch.cat([t.contiguous().reshape(-1).view(torch.int32) for t in ts])


def _par_rank(rank: int, port: int, tmp: str, queue) -> None:
    """One rank of the two: 3 SimT and 3 warmup steps at batch 1 on its block of the
    global batches, the ranks' states held equal bit for bit after every step; then
    ``evaluate`` sharded over the images and row-split on a spatial=2 mesh."""
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = initialize_multihost(f"127.0.0.1:{port}", PAR_WORLD, rank, "cuda",
                                   backend="gloo")
        out = {}
        for stage in ("SimT", "warmup"):
            cfg, state, batches = par_setup(tmp, stage, ["--mesh-data", str(PAR_WORLD)])
            mesh = loop.build_mesh(cfg, dev)
            replicate_state(state, mesh)
            step = (make_simt_step if stage == "SimT" else make_warmup_step)(cfg, mesh)
            metrics, equal, spans, wall = [], [], {}, 0.0
            reset_counts()
            for i, b in enumerate(batches):
                # The steps after the first are timed, the checks between them are not.
                step.spans = [] if i else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, shard_batch(b, mesh))
                torch.cuda.synchronize()
                wall += (time.perf_counter() - t0) if i else 0.0
                metrics.append({k: float(v) for k, v in m.items()})
                for name, start, end in step.spans or ():
                    spans[name] = spans.get(name, 0.0) + start.elapsed_time(end) / (
                        PAR_STEPS - 1)
                if rank == 0:
                    torch.save({k: p.detach().cpu() for k, p in
                                state.model.named_parameters() if p.requires_grad},
                               os.path.join(tmp, f"par_{stage}_{i}.pt"))
                mine = _bits(state)
                theirs = mine.clone()
                dist.broadcast(theirs, src=0)
                same = torch.tensor([int(torch.equal(mine, theirs))], device=dev)
                dist.all_reduce(same, op=dist.ReduceOp.MIN)
                equal.append(bool(same.item()))
            out[stage] = {"metrics": metrics, "equal": equal, "launches": read_counts(),
                          "steps_per_sec": (PAR_STEPS - 1) / wall, "spans": spans}
            del state, step
            torch.cuda.empty_cache()
        model = deeplab_multi(C, O, openset=True)
        init_weights(model, torch.Generator().manual_seed(SEED))
        kw = dict(data_root=os.path.join(tmp, "full"),
                  val_list=os.path.join(tmp, "full", "lists", "val.txt"),
                  gt_dir=os.path.join(tmp, "full", "label"), return_hist=True,
                  device=dev, print_fn=lambda s: None)
        for name, extra in (("shard", {}),
                            ("spatial", {"mesh": make_mesh(1, PAR_WORLD, device=dev)})):
            reset_counts()
            _, hist = evaluate(model, **kw, **extra)
            out[name] = {"hist": hist, "launches": read_counts()}
        queue.put((rank, out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        import traceback

        queue.put((rank, traceback.format_exc()))


def _par_reference(tmp: str) -> dict:
    """One process at the global batch 2: the same steps from the same initialisation,
    its metrics and each module's parameter change after every step; the same with the
    batch's two images swapped (the reference's own spread); the unsharded
    histogram."""
    out = {}
    for stage in ("SimT", "warmup"):
        for order in ("given", "swapped"):
            cfg, state, batches = par_setup(tmp, stage)
            if order == "swapped":
                batches = [{k: v.flip(0) for k, v in b.items()} for b in batches]
            start = {k: v.detach().cpu().clone()
                     for k, v in state.model.named_parameters()}
            step = (make_simt_step if stage == "SimT" else make_warmup_step)(cfg)
            metrics, changes = [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for b in batches:
                metrics.append({k: float(v) for k, v in step(state, b).items()})
                changes.append(_changes_by_module(state.model, start))
            out.setdefault(stage, {"start": start, "trained": [
                k for k, p in state.model.named_parameters() if p.requires_grad]})
            out[stage][order] = {"metrics": metrics, "changes": changes,
                                 "peak": torch.cuda.max_memory_allocated()}
            del state, step
            torch.cuda.empty_cache()
    model = deeplab_multi(C, O, openset=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    _, out["hist"] = evaluate(model, data_root=os.path.join(tmp, "full"),
                              val_list=os.path.join(tmp, "full", "lists", "val.txt"),
                              gt_dir=os.path.join(tmp, "full", "label"), return_hist=True,
                              device="cuda", print_fn=lambda s: None)
    del model
    torch.cuda.empty_cache()
    return out


def _against_one_process(tmp: str, tag: str, phase: str, stage: str, rank0: dict,
                         ref: dict):
    """Rank 0's continuous losses and each module's parameter change after every step
    (saved as ``<tag>_<stage>_<i>.pt``) against one process at batch 2 (``ref``): (the
    largest loss error relative to max(1, |loss|), the first step's changes within
    max(TOL_PAR_CHANGE, 2 x the swapped batch's spread), the first step's errors)."""
    given = ref[stage]["given"]
    loss_err = max(abs(m[k] - w[k]) / max(1.0, abs(w[k]))
                   for m, w in zip(rank0["metrics"], given["metrics"])
                   for k in PAR_CONTINUOUS[stage])
    change_ok, first = True, None
    for i in range(PAR_STEPS):
        sd = torch.load(os.path.join(tmp, f"{tag}_{stage}_{i}.pt"))
        changes = {}
        for k in ref[stage]["trained"]:  # _changes_by_module's order
            changes.setdefault(k.split(".")[0], []).append(
                (sd[k] - ref[stage]["start"][k]).flatten())
        err = _module_errors({k: torch.cat(v) for k, v in changes.items()},
                             given["changes"][i])
        spread = _module_errors(ref[stage]["swapped"]["changes"][i], given["changes"][i])
        if i == 0:
            change_ok = all(e <= max(TOL_PAR_CHANGE, 2 * spread[m]) for m, e in err.items())
            first = {"loss": loss_err, "change": err, "spread": spread}
        print(f"{phase} {stage} step {i}: each module's change against one process's, "
              "by its norm (that process with the batch's images swapped): "
              + ", ".join(f"{m} {e:.3e} ({spread[m]:.3e})" for m, e in err.items()))
    return loss_err, change_ok, first


def _module_errors(got: dict, want: dict) -> dict:
    """Each module's ||got - want|| / ||want|| (``_changes_by_module``'s vectors)."""
    return {k: float((got[k] - w).norm()) / max(float(w.norm()), 1e-30)
            for k, w in want.items()}


def _run_ranks(target, tmp: str, phase: str) -> dict:
    """``target(rank, port, tmp, queue)`` in PAR_WORLD spawned processes sharing the
    card; their results by rank (fails if a rank reported a traceback)."""
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=target, args=(r, port, tmp, queue))
             for r in range(PAR_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=900) for _ in range(PAR_WORLD))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    print(f"{phase}: {PAR_WORLD} ranks over gloo on one card: "
          f"{time.perf_counter() - t0:.1f} s from spawn to results")
    for r, v in got.items():
        if isinstance(v, str):
            fail(f"{phase}: rank {r} failed:\n{v}")
    return got


def _one_rank_cli(tmp: str) -> None:
    """The SimT CLI for 3 steps in a one-rank NCCL group (``--coordinator``,
    ``--num-processes 1``, ``--process-id 0``, ``--mesh-data 1``) and without those
    flags, each a process of its own, one after the other: the CSV rows and the last
    snapshot equal bit for bit (cuDNN set deterministic in both)."""
    runs, logs = {}, {}
    for name, flags in (("plain", []), ("nccl", [
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
            "--process-id", "0", "--mesh-data", "1"])):
        d = os.path.join(tmp, f"cli_{name}")
        argv = ["--synthetic", "--input-size-target", "1024,512", "--num-steps-stop",
                str(PAR_STEPS), "--log-every", "1", "--snapshot-dir", d, "--csv",
                d + ".csv", *flags]
        code = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                "torch.backends.cudnn.benchmark = False; "
                "from simt_tpu_torch.tools import train_simt; train_simt.main(sys.argv[1:])")
        res = subprocess.run([sys.executable, "-c", code, *argv],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=600)
        if res.returncode:
            fail(f"parallel: the {name} SimT CLI exited {res.returncode}: "
                 f"{res.stdout[-2000:]}")
        runs[name], logs[name] = (d, None), res.stdout
    rows = {}
    for name, (d, _) in runs.items():
        with open(d + ".csv") as f:  # every column but the wall-clock time
            rows[name] = [{k: v for k, v in r.items() if k != "time"}
                          for r in csv.DictReader(f)]
    snaps = {name: torch.load(os.path.join(checkpoint.snapshot_path(d, PAR_STEPS),
                                           checkpoint.FILE), map_location="cpu")
             for name, (d, _) in runs.items()}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}.")
        elif torch.is_tensor(tree):
            yield prefix, tree

    a, b = dict(flat(snaps["plain"])), dict(flat(snaps["nccl"]))
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    line = [s for s in logs["nccl"].splitlines() if s.startswith("process group:")]
    print(f"parallel, one-rank NCCL group: the SimT CLI ({PAR_STEPS} steps, full width, "
          f"512x1024 synthetic) with --coordinator/--num-processes 1/--process-id 0/"
          f"--mesh-data 1 against the same run without them: {line}; CSV rows but "
          f"their time {'equal' if rows['plain'] == rows['nccl'] else 'DIFFER'} "
          f"({len(rows['nccl'])} rows); last snapshot {len(a)} tensors "
          f"{'equal bit for bit' if same else 'DIFFER'}")
    if (rows["plain"] != rows["nccl"] or len(rows["nccl"]) != PAR_STEPS or not same
            or line != ["process group: rank 0 of 1 (nccl), device cuda:0"]):
        fail("parallel: the one-rank NCCL run differs from the plain run")
    for d, _ in runs.values():
        shutil.rmtree(d)


def phase_parallel(tmp: str, smi: str, ref: dict) -> dict:
    """Data parallelism through ``torch.distributed``, each rank a process of its own:
    the one-rank NCCL CLI against the plain one; two ranks sharing the card over gloo
    (batch 1 each) against one process at batch 2 over the same global batches
    (``ref``, ``_par_reference``), 3 SimT and 3 warmup steps; the sharded and the
    row-split evaluation."""
    _one_rank_cli(tmp)
    got = _run_ranks(_par_rank, tmp, "parallel")
    ok = True
    worst = {}
    for stage in ("SimT", "warmup"):
        mine = [got[r][stage] for r in range(PAR_WORLD)]
        want = {k: v * PAR_STEPS for k, v in PAR_COUNTS[stage].items()}
        loss_err, change_ok, worst[stage] = _against_one_process(tmp, "par", "parallel",
                                                                 stage, mine[0], ref)
        equal = all(all(m["equal"]) for m in mine)
        same_metrics = mine[0]["metrics"] == mine[1]["metrics"]
        counts_ok = all(m["launches"] == {n: want.get(n, 0) for n in COUNTED} for m in mine)
        print(f"parallel {stage}: {PAR_WORLD} ranks x batch 1 against one process at batch "
              f"2, {PAR_STEPS} steps: states equal bit for bit after every step "
              f"{[m['equal'] for m in mine]}; metrics equal across the ranks "
              f"{same_metrics}; continuous losses within {loss_err:.3e} of max(1, |loss|) "
              f"(limit {TOL_PAR_LOSS:g}); first step's module changes within "
              f"max({TOL_PAR_CHANGE:g}, 2 x the swap's): {change_ok}; launches a rank "
              f"{[m['launches'] for m in mine]} (want {want})")
        for r, m in enumerate(mine):
            print(f"parallel {stage} rank {r}: {m['steps_per_sec']:.3f} steps/s over "
                  f"{PAR_STEPS - 1} steps; spans (CUDA events, ms a step) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in m["spans"].items())
                  + f" [{smi}]; two ranks share one card: no scaling is measured")
        ok = (ok and equal and same_metrics and counts_ok and loss_err <= TOL_PAR_LOSS
              and change_ok)
    for name, b1 in (("shard", 2), ("spatial", 4)):
        for r in range(PAR_WORLD):
            g = got[r][name]
            same = np.array_equal(g["hist"], ref["hist"])
            counts = g["launches"]
            ok = (ok and same and counts["multiscale_argmax_hist"] == b1
                  and counts["bn_act"] == 2 * N_BN * b1)
            print(f"parallel evaluate ({name}) rank {r}: histogram equal to one "
                  f"process's bit for bit: {same}; B1 launches {counts['multiscale_argmax_hist']}"
                  f" (want {b1}), fused BatchNorms {counts['bn_act']} (want "
                  f"{2 * N_BN * b1}: two scales an image), B6/B7 "
                  f"{counts['bottleneck_fwd']}/{counts['bottleneck_bwd']}")
    if not ok:
        fail("parallel: the ranks disagree with one process or with each other")
    return worst


# ---------------------------------------------------------------------------------
# The spatial axis: each image's rows over the ranks (H-sharded training)
# ---------------------------------------------------------------------------------

# The ranks' gathered stride-8 logits (eval mode, bf16 autocast) against one process's,
# by relative L2: the windows' convolutions may take other cuDNN algorithms than the
# whole map's, so single bf16 roundings (2^-8) differ and spread through ~100 layers.
# Five bf16 ulps.
TOL_SPATIAL_FWD = 5 * 2.0 ** -8
BAND_EDGES = (0, 256, 512)  # the band kernels' check: two bands of a 512-row output


def phase_band_kernels(rng: np.random.Generator) -> dict:
    """B2/B3 on bands [0, 256) and [256, 512) of the main path's output (xcat
    1x65x129x68 -> 512x1024, iid labels) against their plain band versions (counts,
    anchors, presence equal; sums, dT, dxcat at TOL_SUMS / TOL_DT / TOL_DX) and, the
    bands combined, against the whole call (counts, anchor maxima and indices, presence
    equal; sums, dT and dxcat summed over the bands at the same tolerances); each run
    twice and bitwise equal."""
    h8, w8 = TRAIN_LOGIT_HW
    hh, ww = TRAIN_HW
    xcat, label, conf, t1, t2 = loss_inputs(rng, batch=1, h8=h8, w8=w8, hh=hh, ww=ww)
    g = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).cuda()
    kw = dict(num_classes=C, threshold_high=0.8)
    whole = loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kw)
    dwhole = loss_fused.loss_core_bwd(g, xcat, label, conf, t1, t2, **kw)
    bands, dbands, ok = [], [], True
    for r0, r1 in zip(BAND_EDGES[:-1], BAND_EDGES[1:]):
        lb, cb = label[:, r0:r1].contiguous(), conf[:, r0:r1].contiguous()
        bkw = dict(kw, band=(r0, hh))
        got, again = (loss_fused.loss_core_fwd(xcat, lb, cb, t1, t2, **bkw)
                      for _ in range(2))
        want = loss_fused.loss_core_fwd_reference(xcat, lb, cb, t1, t2, **bkw)
        dgot, dagain = (loss_fused.loss_core_bwd(g, xcat, lb, cb, t1, t2, **bkw)
                        for _ in range(2))
        dwant = loss_fused.loss_core_bwd_reference(g, xcat, lb, cb, t1, t2, **bkw)
        torch.cuda.synchronize()
        exact = (torch.equal(got[0][:, 1::2], want[0][:, 1::2])
                 and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])))
        rerun = (all(torch.equal(a, b) for a, b in zip(got, again))
                 and all(torch.equal(a, b) for a, b in zip(dgot, dagain)))
        sums_rel = float(((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-30)).max())
        errs = (_rel(dgot[0], dwant[0]), _rel(dgot[1], dwant[1]), _rel(dgot[2], dwant[2]))
        band_ok = (exact and rerun and sums_rel <= TOL_SUMS and errs[0] <= TOL_DX
                   and max(errs[1:]) <= TOL_DT)
        print(f"band [{r0}, {r1}) of {hh} rows, B2/B3 vs their plain band versions: "
              f"counts/anchors/presence {'equal' if exact else 'DIFFER'}, sums rel "
              f"{sums_rel:.3e}, dxcat {errs[0]:.3e}, dT {max(errs[1:]):.3e} of max; reruns "
              f"{'bitwise equal' if rerun else 'DIFFER'}: {'ok' if band_ok else 'MISMATCH'}")
        ok = ok and band_ok
        bands.append(got)
        dbands.append(dgot)
    (s0, m0, i0, p0), (s1, m1, i1, p1) = bands
    amax = torch.maximum(m0, m1)
    aidx = torch.where(m1 > m0, i1, torch.where(m1 == m0, torch.minimum(i0, i1), i0))
    combined = (torch.equal((s0 + s1)[:, 1::2], whole[0][:, 1::2])
                and torch.equal(amax, whole[1]) and torch.equal(aidx, whole[2])
                and torch.equal(torch.maximum(p0, p1), whole[3]))
    sums_rel = float(((s0 + s1 - whole[0]).abs() / whole[0].abs().clamp(min=1e-30)).max())
    errs = [_rel(dbands[0][i] + dbands[1][i], dwhole[i]) for i in range(3)]
    whole_ok = (combined and sums_rel <= TOL_SUMS and errs[0] <= TOL_DX
                and max(errs[1:]) <= TOL_DT)
    print(f"bands {list(zip(BAND_EDGES[:-1], BAND_EDGES[1:]))} combined vs the whole call: "
          f"counts, anchor maxima and indices, presence {'equal' if combined else 'DIFFER'}; "
          f"sums rel {sums_rel:.3e}, dxcat {errs[0]:.3e}, dT {max(errs[1:]):.3e} of max: "
          f"{'ok' if whole_ok else 'MISMATCH'}")
    if not (ok and whole_ok):
        fail("spatial: the band kernels disagree with their plain versions or the whole call")
    return {"sums_rel": sums_rel, "dx_rel": errs[0], "dt_rel": max(errs[1:])}


def _spatial_forward_model(dev):
    model = deeplab_multi(C, O, openset=True)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def _spatial_forward_input(dev) -> torch.Tensor:
    return torch.from_numpy(synthetic_batch(2, TRAIN_HW, C, seed=SEED)["image"]).to(dev)


# The other two families on the spatial axis (H-sharded training of DeepLabv3 and
# DeepLab-VGG): each rank's eval-mode logits (DeepLabv3's band of the input-size rows,
# VGG's gathered stride-8 map), the row-split evaluation of DeepLabv3 (B1) and the
# warmup steps, against one process at batch 2.
SPATIAL_AUX = ("deeplabv3", "deeplab_vgg")


def _aux_eval_kw(tmp: str) -> dict:
    """``evaluate``'s arguments for the 4-image 2048x1024 fixture at DeepLabv3's batch."""
    return dict(data_root=os.path.join(tmp, "full"),
                val_list=os.path.join(tmp, "full", "lists", "val.txt"),
                gt_dir=os.path.join(tmp, "full", "label"), return_hist=True,
                batch_size=AUX_EVAL_BATCH["deeplabv3"], print_fn=lambda s: None)


def _spatial_aux_run(tmp: str, arch: str, dev, mesh=None) -> dict:
    """``arch``'s seeded full-width model (``train_warmup --model arch``, 19 classes):
    the eval-mode forward of the spatial phase's batch of 2 (on this rank's rows with a
    ``mesh``), DeepLabv3's two-scale evaluation (row-split over ``mesh``), then PAR_STEPS
    warmup steps at the global batch of 2 with their metrics, launches, the wall ms of
    the steps after the first, the rows exchange's host ms and bytes a step, the peak
    memory and, on ranks, whether the ranks' states are equal after every step."""
    import torch.distributed as dist

    argv = ["--model", arch] + (["--mesh-spatial", str(PAR_WORLD)] if mesh else [])
    cfg, state, batches = par_setup(tmp, "warmup", argv)
    if mesh is not None:
        replicate_state(state, mesh)
    x = _spatial_forward_input(dev)
    if mesh is not None:
        x = shard_batch({"image": x}, mesh)["image"]
    model = state.model.eval()
    with torch.no_grad(), spatial_rows(mesh, TRAIN_HW[0]):
        y = model(x.permute(0, 3, 1, 2))
    out = {"forward": (y[0] if isinstance(y, tuple) else y).float().cpu().numpy()}
    if arch == "deeplabv3":
        reset_counts()
        _, out["hist"] = evaluate(model, device=dev, mesh=mesh, **_aux_eval_kw(tmp))
        out["eval_launches"] = read_counts()
    model.train()
    step = make_warmup_step(cfg, mesh)
    metrics, equal, wall, exchange = [], [], 0.0, [0.0, 0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        fetch_rows.seconds, fetch_rows.bytes = 0.0, 0
        t0 = time.perf_counter()
        m = step(state, b if mesh is None else shard_batch(b, mesh))
        torch.cuda.synchronize()
        if i:
            wall += time.perf_counter() - t0
            exchange[0] += fetch_rows.seconds / (PAR_STEPS - 1)
            exchange[1] = fetch_rows.bytes
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            mine = _bits(state)
            theirs = mine.clone()
            dist.broadcast(theirs, src=0)
            same = torch.tensor([int(torch.equal(mine, theirs))], device=dev)
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            equal.append(bool(same.item()))
    out.update({"metrics": metrics, "equal": equal, "launches": read_counts(),
                "ms_a_step": wall / (PAR_STEPS - 1) * 1e3,
                "exchange_ms": exchange[0] * 1e3, "exchange_bytes": exchange[1],
                "peak": torch.cuda.max_memory_allocated()})
    del state, step, model
    torch.cuda.empty_cache()
    return out


def _spatial_rank(rank: int, port: int, tmp: str, queue) -> None:
    """One rank of the two on a (data 1, spatial 2) mesh, each holding half of every
    image's rows: the eval-mode forward (its gathered logits); then 3 SimT and 3 warmup
    steps on the global batches of the parallel phase, the ranks' states held equal bit
    for bit after every step, with launches, spans, the exchange's host seconds and the
    peak memory."""
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = initialize_multihost(f"127.0.0.1:{port}", PAR_WORLD, rank, "cuda",
                                   backend="gloo")
        mesh = make_mesh(1, PAR_WORLD, device=dev)
        model = _spatial_forward_model(dev)
        x = shard_batch({"image": _spatial_forward_input(dev)}, mesh)["image"]
        with torch.no_grad(), spatial_rows(mesh, TRAIN_HW[0]):
            # numpy: a rank's CPU tensors would cross the queue as shared-memory handles,
            # which the parent cannot open once the rank has exited
            logits = [y.cpu().numpy() for y in model(x.permute(0, 3, 1, 2))]
        out = {"forward": logits}
        del model
        for stage in ("SimT", "warmup"):
            cfg, state, batches = par_setup(tmp, stage, ["--mesh-spatial", str(PAR_WORLD)])
            mesh = loop.build_mesh(cfg, dev)
            replicate_state(state, mesh)
            step = (make_simt_step if stage == "SimT" else make_warmup_step)(cfg, mesh)
            metrics, equal, spans, wall, exchange = [], [], {}, 0.0, [0.0, 0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            for i, b in enumerate(batches):
                # The steps after the first are timed, the checks between them are not.
                step.spans = [] if i else None
                torch.cuda.synchronize()
                fetch_rows.seconds, fetch_rows.bytes = 0.0, 0
                t0 = time.perf_counter()
                m = step(state, shard_batch(b, mesh))
                torch.cuda.synchronize()
                if i:
                    wall += time.perf_counter() - t0
                    exchange[0] += fetch_rows.seconds / (PAR_STEPS - 1)
                    exchange[1] = fetch_rows.bytes
                metrics.append({k: float(v) for k, v in m.items()})
                for name, start, end in step.spans or ():
                    spans[name] = spans.get(name, 0.0) + start.elapsed_time(end) / (
                        PAR_STEPS - 1)
                if rank == 0:
                    torch.save({k: p.detach().cpu() for k, p in
                                state.model.named_parameters() if p.requires_grad},
                               os.path.join(tmp, f"spatial_{stage}_{i}.pt"))
                mine = _bits(state)
                theirs = mine.clone()
                dist.broadcast(theirs, src=0)
                same = torch.tensor([int(torch.equal(mine, theirs))], device=dev)
                dist.all_reduce(same, op=dist.ReduceOp.MIN)
                equal.append(bool(same.item()))
            out[stage] = {"metrics": metrics, "equal": equal, "launches": read_counts(),
                          "variants": read_variants(),
                          "steps_per_sec": (PAR_STEPS - 1) / wall, "spans": spans,
                          "exchange_ms": exchange[0] * 1e3, "exchange_bytes": exchange[1],
                          "peak": torch.cuda.max_memory_allocated()}
            del state, step
            torch.cuda.empty_cache()
        for arch in SPATIAL_AUX:
            out[arch] = _spatial_aux_run(tmp, arch, dev, mesh)
        queue.put((rank, out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        import traceback

        queue.put((rank, traceback.format_exc()))


def _check_spatial_aux(arch: str, mine: list, ref: dict, smi: str) -> dict:
    """The ranks' runs of ``arch`` (``_spatial_aux_run``) against one process's: each
    rank's eval-mode logits within TOL_SPATIAL_FWD by relative L2 (DeepLabv3: its band
    of the rows), the warmup losses within TOL_PAR_LOSS, the ranks' states equal bit for
    bit after every step and their metrics equal, no package kernel launched by the
    steps (cuDNN); DeepLabv3's row-split evaluation equal to one process's bit for bit,
    one B1 launch a rank (one batch of 4)."""
    fwd = []
    for r, m in enumerate(mine):
        want = torch.from_numpy(ref["forward"])
        if arch == "deeplabv3":
            lo, hi = row_block(TRAIN_HW[0], r, PAR_WORLD)
            want = want[:, :, lo:hi]
        fwd.append(float((torch.from_numpy(m["forward"]) - want).norm() / want.norm()))
    loss_err = max(abs(m[k] - w[k]) / max(1.0, abs(w[k]))
                   for m, w in zip(mine[0]["metrics"], ref["metrics"])
                   for k in PAR_CONTINUOUS["warmup"])
    equal = all(all(m["equal"]) for m in mine)
    same_metrics = all(m["metrics"] == mine[0]["metrics"] for m in mine)
    none = all(not any(m["launches"].values()) for m in mine)
    ok = (max(fwd) <= TOL_SPATIAL_FWD and loss_err <= TOL_PAR_LOSS and equal
          and same_metrics and none)
    line = (f"spatial {arch} (train_warmup --model {arch} --mesh-spatial {PAR_WORLD}, full "
            f"width, 19 classes, batch 2, 512x1024): eval-mode logits against one "
            f"process's by relative L2 {[f'{e:.3e}' for e in fwd]} (limit "
            f"{TOL_SPATIAL_FWD:.3e}); {PAR_STEPS} warmup steps: losses within "
            f"{loss_err:.3e} of max(1, |loss|) (limit {TOL_PAR_LOSS:g}), states equal bit "
            f"for bit after every step {[m['equal'] for m in mine]}, metrics equal across "
            f"the ranks {same_metrics}, package kernels launched by the steps "
            f"{[m['launches'] for m in mine]} (want none)")
    if arch == "deeplabv3":
        hist_ok = all(np.array_equal(m["hist"], ref["hist"]) for m in mine)
        b1 = [m["eval_launches"]["multiscale_argmax_hist"] for m in mine]
        ok = ok and hist_ok and b1 == [1] * PAR_WORLD
        line += (f"; row-split evaluation of the 4 images at batch 4: histograms equal "
                 f"to one process's {hist_ok}, B1 launches a rank {b1} (want 1)")
    print(line + f": {'ok' if ok else 'MISMATCH'}")
    for r, m in enumerate(mine):
        print(f"spatial {arch} rank {r}: {m['ms_a_step']:.3f} ms a warmup step (wall, "
              f"{PAR_STEPS - 1} steps; one process at batch 2 {ref['ms_a_step']:.3f}); the "
              f"rows exchange {m['exchange_ms']:.3f} host ms over {m['exchange_bytes']} "
              f"bytes a step; peak memory {m['peak'] / 2**30:.3f} GiB (one process "
              f"{ref['peak'] / 2**30:.3f}) [{smi}]")
    return {"ok": ok, "forward": max(fwd), "loss": loss_err,
            "ms_a_step": [m["ms_a_step"] for m in mine], "ms_ref": ref["ms_a_step"],
            "exchange_ms": [m["exchange_ms"] for m in mine],
            "exchange_bytes": mine[0]["exchange_bytes"],
            "peak": [m["peak"] for m in mine], "peak_ref": ref["peak"]}


def phase_spatial(tmp: str, smi: str, ref: dict, rng: np.random.Generator) -> dict:
    """H-sharded training on the spatial axis (``parallel/mesh.py::spatial_rows``): the
    band kernels at full width; two ranks sharing the card over gloo on a (data 1,
    spatial 2) mesh, each holding half of every image's rows, against one process at
    batch 2 (``ref``, the parallel phase's reference): the eval-mode forward's gathered
    logits within TOL_SPATIAL_FWD, then 3 SimT and 3 warmup steps with the parallel
    phase's gates (states equal bit for bit, losses within TOL_PAR_LOSS, the first
    step's module changes), each rank's launches as one process's batch-1 step's, every
    B4/B5 launch on its wgmma kernel, and each rank's peak memory below one process's."""
    t_phase = time.perf_counter()
    band = phase_band_kernels(rng)
    model = _spatial_forward_model("cuda")
    with torch.no_grad():
        want = [y.cpu() for y in model(_spatial_forward_input("cuda").permute(0, 3, 1, 2))]
    del model
    torch.cuda.empty_cache()
    t_aux = time.perf_counter()
    aux_ref = {arch: _spatial_aux_run(tmp, arch, "cuda") for arch in SPATIAL_AUX}
    t_aux = time.perf_counter() - t_aux
    got = _run_ranks(_spatial_rank, tmp, "spatial")
    ok = True
    fwd_err = []
    for r in range(PAR_WORLD):
        errs = [float((torch.from_numpy(g) - w).norm() / w.norm())
                for g, w in zip(got[r]["forward"], want)]
        fwd_err.append(max(errs))
        same = all(np.array_equal(a, b) for a, b in zip(got[r]["forward"], got[0]["forward"]))
        ok = ok and same and max(errs) <= TOL_SPATIAL_FWD
        print(f"spatial forward (eval mode, bf16, batch 2, 512x1024) rank {r}: gathered "
              f"logits {tuple(got[r]['forward'][0].shape)} against one process's by "
              f"relative L2: head 1 {errs[0]:.3e}, head 2 {errs[1]:.3e} (limit "
              f"{TOL_SPATIAL_FWD:.3e}); equal to rank 0's bit for bit: {same}")
    out = {"forward": max(fwd_err), "band": band}
    for stage in ("SimT", "warmup"):
        mine = [got[r][stage] for r in range(PAR_WORLD)]
        want_counts = {k: v * PAR_STEPS for k, v in PAR_COUNTS[stage].items()}
        loss_err, change_ok, out[stage] = _against_one_process(tmp, "spatial", "spatial",
                                                               stage, mine[0], ref)
        equal = all(all(m["equal"]) for m in mine)
        same_metrics = mine[0]["metrics"] == mine[1]["metrics"]
        counts_ok = all(m["launches"] == {n: want_counts.get(n, 0) for n in COUNTED}
                        for m in mine)
        wgmma = all(sum(c.values()) == c["wgmma"] for m in mine
                    for c in m["variants"].values())
        peak_ref = ref[stage]["given"]["peak"]
        lower = all(m["peak"] < peak_ref for m in mine)
        print(f"spatial {stage}: {PAR_WORLD} ranks x half of every image's rows against "
              f"one process at batch 2, {PAR_STEPS} steps: states equal bit for bit after "
              f"every step {[m['equal'] for m in mine]}; metrics equal across the ranks "
              f"{same_metrics}; continuous losses within {loss_err:.3e} of max(1, |loss|) "
              f"(limit {TOL_PAR_LOSS:g}); first step's module changes within "
              f"max({TOL_PAR_CHANGE:g}, 2 x the swap's): {change_ok}; launches a rank "
              f"{[m['launches'] for m in mine]} (want {want_counts}); B4/B5 all wgmma "
              f"{wgmma}; peak memory a rank "
              f"{[round(m['peak'] / 2**30, 3) for m in mine]} GiB against one process's "
              f"{peak_ref / 2**30:.3f} GiB: lower {lower}")
        for r, m in enumerate(mine):
            print(f"spatial {stage} rank {r}: {m['steps_per_sec']:.3f} steps/s over "
                  f"{PAR_STEPS - 1} steps; spans (CUDA events, ms a step) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in m["spans"].items())
                  + f"; the rows exchange (fetch_rows and gather_rows all-reduces, host "
                  f"ms a step, the wait for the card and the peer included) "
                  f"{m['exchange_ms']:.3f} over {m['exchange_bytes']} bytes [{smi}]; "
                  "two ranks share one card: no scaling is measured")
        out[stage].update({"steps_per_sec": [m["steps_per_sec"] for m in mine],
                           "peak": [m["peak"] for m in mine], "peak_ref": peak_ref})
        ok = (ok and equal and same_metrics and counts_ok and wgmma and lower
              and loss_err <= TOL_PAR_LOSS and change_ok)
    for arch in SPATIAL_AUX:
        out[arch] = _check_spatial_aux(arch, [got[r][arch] for r in range(PAR_WORLD)],
                                       aux_ref[arch], smi)
        ok = ok and out[arch]["ok"]
    print(f"spatial: the other families' one-process reference took {t_aux:.1f} s")
    print(f"spatial: the phase took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    if not ok:
        fail("spatial: the ranks disagree with one process or with each other")
    return out


# ---------------------------------------------------------------------------------
# The long-run tools: the soak run and the planted-noise run at full width
# ---------------------------------------------------------------------------------

SOAK_ARGV = ["--steps", "200", "--window", "50"]
PLANTED_ARGV = ["--warmup-steps", "8", "--train-steps", "4", "--log-every", "2",
                "--n-train", "2", "--n-val", "1"]
TOL_ORACLE_T = 1e-4  # the oracle arm's t_dist_known: T frozen at P*
# Launches a step: the SimT step on the cached teacher posterior runs no teacher (B4 33
# for the student's forward, 26 for the input gradient of layers 3-4).
CACHED_SIMT_COUNTS = {"loss_core_fwd": 1, "loss_core_bwd": 1,
                      "conv3x3_fwd": N_CONV2 + N_CONV2_L34, "conv3x3_wgrad": N_CONV2_L34}


class StepLaunches:
    """A train step whose calls are counted, with the launches each call made (the
    counts read before and after it) summed by kernel; ``after(state)`` runs after each
    call when given."""

    def __init__(self, step, after=None):
        self.step, self.after = step, after
        self.calls = 0
        self.launches = dict.fromkeys(COUNTED, 0)

    @property
    def spans(self):
        return self.step.spans

    @spans.setter
    def spans(self, value):  # the step's own CUDA-event spans (SimTStep.spans)
        self.step.spans = value

    def __call__(self, state, batch):
        before = read_counts()
        metrics = self.step(state, batch)
        for name, n in read_counts().items():
            self.launches[name] += n - before[name]
        self.calls += 1
        if self.after is not None:
            self.after(state)
        return metrics


def check_per_step(path: str, steps: list, want: dict) -> Tuple[int, dict]:
    """Fails unless the counted ``steps`` launched each kernel ``want`` times a call (0
    if absent) and nothing else; returns (calls, launches)."""
    calls = sum(s.calls for s in steps)
    launches = {name: sum(s.launches[name] for s in steps) for name in COUNTED}
    check_counts(f"{path} ({calls} steps)", launches,
                 {name: n * calls for name, n in want.items()})
    return calls, launches


def phase_soak(smi: str) -> dict:
    """``tools/soak.py`` at full width (ResNet-101, 512x1024, 19 + 15 classes, bf16),
    200 steps in windows of 50, in this process: its JSON line must pass; every step
    (the bench's floor reading, the warm-up, the soak, the profiled steps) launches
    B2/B3/B4/B5 1/1/92/26, all B4/B5 on wgmma."""
    t0 = time.perf_counter()
    steps = []

    def counted(cfg, *a, **kw):
        steps.append(StepLaunches(make_simt_step(cfg, *a, **kw)))
        return steps[-1]

    reset_counts()
    with mock.patch.object(bench, "make_simt_step", counted):
        out = soak.run(soak.build_parser().parse_args(SOAK_ARGV))
    print(json.dumps(out))
    calls, _ = check_per_step("soak", steps, PAR_COUNTS["SimT"])
    check_wgmma("soak", read_variants())
    print(f"soak: {out['steps']} steps in windows of {SOAK_ARGV[3]}, {calls} SimT steps "
          f"in all, launches a step B2/B3/B4/B5 1/1/{PAR_COUNTS['SimT']['conv3x3_fwd']}/"
          f"{PAR_COUNTS['SimT']['conv3x3_wgrad']}; the phase took "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if not out["pass"]:
        fail(f"soak: the run did not pass: {out}")
    return out


def _numbers(rec):
    if isinstance(rec, dict):
        for v in rec.values():
            yield from _numbers(v)
    elif isinstance(rec, list):
        for v in rec:
            yield from _numbers(v)
    elif isinstance(rec, (int, float)) and not isinstance(rec, bool):
        yield rec


def phase_planted(tmp: str, smi: str) -> dict:
    """``tools/planted_noise.py`` at full geometry (19 + 15 classes, 512x1024,
    ResNet-101, bf16), all four arms at a small step count, in this process: every
    logged number finite; the oracle arm's t_dist_known at most TOL_ORACLE_T after
    every step; the warmup (and CE) steps B4/B5 66/33 a step, the SimT steps on the
    cached posterior B2/B3/B4/B5 1/1/59/26, all B4/B5 on wgmma; the teacher routing on
    the card equal to the fixture's on the CPU for the same seed."""
    t0 = time.perf_counter()
    args = planted_noise.build_parser().parse_args(
        PLANTED_ARGV + ["--out", os.path.join(tmp, "planted.json")])
    fx, layers, _ = planted_noise.geometry(args.smoke)
    warm_steps, simt_steps, oracle_dist = [], [], []

    def counted_warmup(cfg, *a, **kw):
        warm_steps.append(StepLaunches(make_warmup_step(cfg, *a, **kw)))
        return warm_steps[-1]

    def counted_simt(cfg, *a, **kw):
        after = None
        if cfg.optim.learning_rate_t == 0.0:  # the oracle arm
            def after(st):
                oracle_dist.append(planted_noise.t_metrics(
                    fx, st.t1.param, st.t2.param)["t_dist_known"])
        simt_steps.append(StepLaunches(make_simt_step(cfg, *a, **kw), after))
        return simt_steps[-1]

    reset_counts()
    with mock.patch.object(planted_noise, "make_warmup_step", counted_warmup), \
            mock.patch.object(planted_noise, "make_simt_step", counted_simt):
        res = planted_noise.run(args, planted_noise.seeded_inits(fx, layers, args.seed))
    check_per_step("planted warmup + ce", warm_steps, PAR_COUNTS["warmup"])
    check_per_step("planted SimT arms", simt_steps, CACHED_SIMT_COUNTS)
    check_wgmma("planted", read_variants())
    if not all(math.isfinite(v) for v in _numbers(res)):
        fail("planted: a logged number is not finite")
    print(f"planted: oracle t_dist_known after each step {oracle_dist} "
          f"(limit {TOL_ORACLE_T})")
    if len(oracle_dist) != int(PLANTED_ARGV[3]) or max(oracle_dist) > TOL_ORACLE_T:
        fail(f"planted: the oracle arm's T moved: t_dist_known {oracle_dist}")
    cpu = fx.routing_diagnostics(fx.make_dataset(args.n_train, args.seed))
    print(f"planted: teacher routing {res['teacher_routing']} (CPU {cpu})")
    if res["teacher_routing"] != cpu:
        fail("planted: the teacher routing on the card differs from the CPU's")
    rates = {a: [r["steps_per_sec"] for r in v["traj"]] for a, v in res["arms"].items()}
    print(f"planted: summary {json.dumps(res['summary'])}; steps/s by arm {rates}; "
          f"the phase took {time.perf_counter() - t0:.1f} s [{smi}]")
    return res


# ---------------------------------------------------------------------------------
# The eval head's variants and the T-game
# ---------------------------------------------------------------------------------

EVAL_VARIANT_CALLS = 20  # timed calls a variant, after one warm-up call
TGAME_STEPS = 300  # outer steps of the toy problem's game on the card
TGAME_CPU_STEPS = 20  # ... held to the CPU's game at TOL_TGAME
TOL_TGAME = 1e-4  # T after TGAME_CPU_STEPS steps, the card against the CPU


def phase_eval_variants(smi: str) -> dict:
    """``tools/eval_variants.py`` at full width in this process (function calls: a
    spawned child that imports torch would blind later profiler sessions): the fused,
    split and unfused heads after the two forwards of the seeded ResNet-101 (19 + 15
    classes, bf16, 512x1024 + 640x1280 -> 1024x2048), EVAL_VARIANT_CALLS timed calls
    each after one warm-up call; their histograms held to one another (fused and split
    bit for bit; unfused totals equal and L1 within 2e-5 H W); launches B1 1 a fused
    or split call and none unfused, B4 66 a call (33 a forward), all wgmma."""
    t0 = time.perf_counter()
    reset_counts()
    res = eval_variants.run(device="cuda", calls=EVAL_VARIANT_CALLS, print_fn=print)
    calls = EVAL_VARIANT_CALLS + 1
    check_counts("eval variants", read_counts(),
                 {"multiscale_argmax_hist": 2 * calls,
                  "conv3x3_fwd": 2 * N_CONV2 * calls * len(eval_variants.VARIANTS),
                  "bn_act": 2 * N_BN * calls * len(eval_variants.VARIANTS)})
    check_wgmma("eval variants", read_variants())
    recs = res["records"]
    per_call = {v: r["b1_launches"] / calls for v, r in recs.items()}
    print(f"eval variants: img/s fused {recs['fused']['img_per_sec']:.3f}, split "
          f"{recs['split']['img_per_sec']:.3f}, unfused {recs['unfused']['img_per_sec']:.3f}"
          f"; B1 launches a call {per_call}; checks {res['checks']}; the phase took "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if not res["checks"]["ok"] or per_call != {"fused": 1, "split": 1, "unfused": 0}:
        fail(f"eval variants: the heads disagree or B1 ran off its path: {res['checks']}")
    return recs


def phase_tgame(smi: str) -> dict:
    """``tools/tgame.py`` on the card: the toy problem's game (C=8, O=2) for
    TGAME_STEPS steps under the reference-verbatim and the paper-faithful forces (T's
    distance from T* finite and printed), and TGAME_CPU_STEPS steps of the verbatim game
    against the same game on the CPU from the same start (T within TOL_TGAME)."""
    t0 = time.perf_counter()
    prob = tgame.toy_problem()
    out = {}
    for label, kw in (tgame.SETTINGS[0], tgame.SETTINGS[3]):
        d0, d1, t = tgame.run_game(*prob, steps=TGAME_STEPS, device="cuda", verbose=False,
                                   **kw)
        out[label] = (d0, d1)
        print(f"tgame toy C=8/O=2, {label}, {TGAME_STEPS} steps on the card: dT {d0:.4f} "
              f"-> {d1:.4f}")
        if not (math.isfinite(d1) and np.isfinite(t).all()):
            fail(f"tgame: {label} is not finite")
    _, _, card = tgame.run_game(*prob, steps=TGAME_CPU_STEPS, device="cuda", verbose=False)
    _, _, cpu = tgame.run_game(*prob, steps=TGAME_CPU_STEPS, device="cpu", verbose=False)
    err = float(np.abs(card - cpu).max())
    print(f"tgame: {TGAME_CPU_STEPS} verbatim steps, the card's T against the CPU's: max "
          f"|diff| {err:.3e} (limit {TOL_TGAME:g}); the phase took "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if err > TOL_TGAME:
        fail("tgame: the card's game differs from the CPU's")
    return out


# ---------------------------------------------------------------------------------
# The profiling tools
# ---------------------------------------------------------------------------------

ROOF_STEPS = 10  # wall and profiled steps of each roofline reading
TRACE_REPS = 3  # profiled calls of each profile_trace target
TOL_TRACE = 0.10  # profile_trace's step device ms against timing.profile_steps'
MAX_OTHER = 0.10  # "other"'s share of the step's device ms
LAYER3_REPS, LAYER3_N = 20, 3  # profile_layer3: blocks a chain, calls a row
TOOL_N = 3  # timed calls a row of profile_step, profile_model and profile_trunk
# Launches a call of the student's forward + backward of the dummy loss (profile_trace
# --what fwdbwd): B4 for the 33 forwards and layers 3-4's input gradients, B5 for theirs.
FWDBWD_COUNTS = {"conv3x3_fwd": N_CONV2 + N_CONV2_L34, "conv3x3_wgrad": N_CONV2_L34}


def _check_shares(tool: str, rows: dict) -> None:
    """Fails unless every row's busy share is at most roofline.MAX_SHARE."""
    high = {k: r["busy"] for k, r in rows.items() if r["busy"] > roofline.MAX_SHARE}
    if high:
        fail(f"{tool}: busy share above {roofline.MAX_SHARE}: {high}")


def _check_families(what: str, got: dict) -> None:
    """Fails unless the families partition the traced device total."""
    fam_ms = sum(f["ms"] for f in got["families"].values())
    print(f"profile_trace {what}: families sum {fam_ms:.6f} ms, device total "
          f"{got['device_ms']:.6f} ms a call")
    if abs(fam_ms - got["device_ms"]) > 1e-9 * got["device_ms"]:
        fail(f"profile_trace {what}: the families sum to {fam_ms}, not {got['device_ms']}")


def phase_profile_tools(smi: str) -> dict:
    """The profiling tools in this process at full width (ResNet-101, 19 + 15 classes,
    512x1024, bf16), before any phase whose children import torch (a process's profiler
    records nothing after such children exit): ``roofline`` at batch 1 and 2,
    ``profile_trace`` of the step (held to ``timing.profile_steps``' reading of the same
    step within TOL_TRACE, "other" at most MAX_OTHER of it) and of the student's forward
    + backward (launches FWDBWD_COUNTS a call), ``profile_step``, ``profile_model``,
    ``profile_trunk`` and ``profile_layer3`` (B6 2 and B7 1 a rep of the fused rows, B4 3
    and B5 1 of the module rows). Every SimT step the tools run launches B2/B3/B4/B5
    1/1/92/26, every B4-B7 launch on wgmma; the families sum to each trace's total; no
    busy share, mfu or mfu_device above 1.05. Each tool prints its JSON line."""
    t0 = time.perf_counter()
    steps = []

    def counted(cfg, *a, **kw):
        steps.append(StepLaunches(make_simt_step(cfg, *a, **kw)))
        return steps[-1]

    def clocked(label: str, fn, *args):
        t1 = time.perf_counter()
        res = fn(*args)
        print(f"profile tools: {label} took {time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
        return res

    out = {}
    for bs in (1, 2):  # roofline's CPU counts first: their twin's step is no card step
        clocked(f"flops.step_work('step', batch_size={bs}) on "
                f"{torch.get_num_threads()} CPU threads",
                lambda: flops.step_work("step", batch_size=bs))
    reset_counts()
    with mock.patch.object(bench, "make_simt_step", counted):
        for bs in (1, 2):
            out[f"roofline_bs{bs}"] = clocked(f"roofline at batch {bs}", roofline.main,
                                              ["--batch-size", str(bs), "--n",
                                               str(ROOF_STEPS)])
        fn = clocked("profile_trace's step", profile_trace.target, "step", CUDA)
        got = clocked("profile_trace --what step", profile_trace.trace, fn, CUDA,
                      TRACE_REPS, 30)
        ref = profile_steps(lambda st, b: fn(), None, [None], report=False)
        del fn
        print(json.dumps({"metric": "profile_trace_step_bs1_512x1024", **got,
                          "profile_steps_ms": ref}))
        out["trace_step"] = got
        out["step_parts"] = clocked("profile_step", profile_step.main,
                                    ["--n", str(TOOL_N)])
    check_per_step("profile tools' SimT steps", steps, PAR_COUNTS["SimT"])
    check_wgmma("profile tools' SimT steps", read_variants())
    _check_families("step", got)
    other = got["families"].get(profile_trace.OTHER, {"share": 0.0})["share"]
    print(f"profile_trace step: device {got['device_ms']:.3f} ms a step, profile_steps "
          f"{ref:.3f} ms; other {other:.4f} of it: {got['other']}")
    if abs(got["device_ms"] - ref) > TOL_TRACE * ref:
        fail(f"profile_trace step: {got['device_ms']:.3f} device ms a step, "
             f"profile_steps {ref:.3f}: more than {TOL_TRACE} apart")
    if other > MAX_OTHER:
        fail(f"profile_trace step: other holds {other:.3f} of the step: {got['other']}")
    _check_shares("profile_step", out["step_parts"]["rows"])

    reset_counts()
    got = clocked("profile_trace --what fwdbwd", profile_trace.main,
                  ["--what", "fwdbwd", "--reps", str(TRACE_REPS), "--top", "20"])
    check_counts("profile_trace fwdbwd", read_counts(),
                 {k: v * got["calls"] for k, v in FWDBWD_COUNTS.items()})
    _check_families("fwdbwd", got)
    out["trace_fwdbwd"] = got
    for tool in (profile_model, profile_trunk):
        name = tool.__name__.rsplit(".", 1)[1]
        out[name] = clocked(name, tool.main, ["--n", str(TOOL_N)])
        _check_shares(name, out[name]["rows"])
    check_wgmma("profile_trace fwdbwd, profile_model, profile_trunk", read_variants())

    reset_counts()
    res = clocked("profile_layer3", profile_layer3.main,
                  ["--reps", str(LAYER3_REPS), "--n", str(LAYER3_N)])
    per_row = (1 + 2 * LAYER3_N + 3) * LAYER3_REPS  # reps a row: warm-up, wall, profiled
    check_counts("profile_layer3", read_counts(),
                 {"bottleneck_fwd": 2 * per_row, "bottleneck_bwd": per_row,
                  "conv3x3_fwd": 3 * per_row, "conv3x3_wgrad": per_row})
    check_wgmma("profile_layer3", read_variants())
    _check_shares("profile_layer3", res["rows"])
    out["layer3"] = res
    print(f"profile tools: the phase took {time.perf_counter() - t0:.1f} s [{smi}]")
    return out


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
    # The soak first: it holds its slowest window to 0.9 x a 20-step reading of the
    # same rate, and after a profiler session in the process every step is slower and
    # its rate noisier (CUPTI stays attached; tools/host_probe.py).
    phase_soak(smi)
    phase_eval_variants(smi)
    torch.cuda.empty_cache()
    phase_tgame(smi)
    # The profiling tools before any phase whose children import torch.
    phase_profile_tools(smi)
    torch.cuda.empty_cache()
    worst = phase_kernel_vs_plain(rng)
    conv_worst = phase_conv_kernels_vs_plain()
    phase_conv_library_free()
    bneck_worst = phase_bneck_kernels_vs_plain()
    phase_bneck_library_free()
    bn_entries = phase_bn_act()
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
        # The planted run before any phase starts worker processes.
        phase_planted(tmp, smi)
        torch.cuda.empty_cache()
        phase_pipeline(tmp, train)
        warm = phase_warmup_main_path()
        torch.cuda.empty_cache()
        bench = phase_bneck_bench()
        entry = phase_kernel_times(launches, worst)
        aux_entry = phase_aux_head_times()
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
        # The auxiliary models and stages after every profiler reading above (a run
        # with their checks before the eval main path read no B1 launch there).
        aux_entry.update(phase_aux_head_vs_plain())
        phase_aux_small(tmp)
        aux_eval = phase_aux_eval(tmp)
        aux_entry["launches"] = aux_eval["deeplabv3"]["launches"]["multiscale_argmax_hist"]
        aux_warm = phase_aux_warmup()
        # The teacher cache's phase and the bench CLI use build_loader's worker processes.
        phase_aux_teacher_cache(tmp, train)
        phase_aux_bench_cli(tmp)
        print("auxiliary paths' launches: " + json.dumps(
            {**{f"eval {a}": v["launches"] for a, v in aux_eval.items()},
             **{f"warmup {a}": v["launches"] for a, v in aux_warm.items()}}))
        # The train loop last, on the fixtures of the eval and pipeline phases: its
        # profiler session (--profile-dir) and its worker processes come after every
        # kernel timing of the phases above.
        phase_train_loop(tmp, smi, train)
        # Data parallelism and the spatial axis last of all: their ranks are processes of
        # their own, after every profiler reading and after the train loop phase. Both
        # hold their ranks to one process at batch 2 (one reference for both).
        ref = _par_reference(tmp)
        phase_parallel(tmp, smi, ref)
        phase_spatial(tmp, smi, ref, rng)

    print(json.dumps({"kernels": [entry, aux_entry, *loss_entries, *conv_entries,
                                  *bneck_entries, *bn_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
