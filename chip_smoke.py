#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (simt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build: compile every CUDA source of the package with nvcc for sm_90a, in parallel;
  2. kernels vs plain, on the card: the eval head (B1) at the eval path's shapes
     (65x129 + 81x161 logits, 19 classes, -> 1024x2048; batch 1 and 2; warmup's 1x1
     zero operand) and edge cases; the loss core's forward and backward (B2/B3) at the
     train path's shapes (xcat 1x65x129x68 -> 512x1024, C 19 + O 15; batch 1 and 2),
     with all labels ignored, every pixel unknown, a 37x301 output from 6x39 logits
     and a planted anchor tie across blocks and images; the trunk's dilated 3x3 conv
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
     DeepLabv2-ResNet-101 over 4 synthetic 2048x1024 images; the SimT train step of
     ``tools/train_simt.py`` (full-width student and teacher with seeded random
     weights, batch 1, 512x1024 synthetic batches, bf16 autocast); the warmup train
     step of ``tools/train_warmup.py`` (full-width closed-set model, the same inputs).
     Each train path: 2 warm-up steps, then 5 timed steps with CUDA-event times of
     their parts, then 3 profiled steps for the device busy share, then the same step
     with every conv2 on cuDNN (a yardstick the port never calls) timed in turns
     against it; and three full-width warmup steps against conv2 on the plain taps;
     the benchmark path of ``tools/bench_fused_bottleneck.py`` at layer3 (the fused
     block against the composed module, 10 calls a chain), and the same module with
     conv2 on cuDNN;
  5. times: per-scale forward (and with conv2 on cuDNN), each kernel against its
     plain version, its bound and, where one exists, a library call computing the
     same function; B4/B5 at the four trunk geometries by the wrappers' time (CUDA
     events, ``ms``) and their kernels' device time
     (profiler, ``kernel_ms``), cuDNN by the same two clocks, with the tiles, splits
     and waves chosen and the host cost a call (``tools/bench_conv3x3.py``'s timing);
     B6/B7 at the four trunk geometries by the same two clocks with their launches a
     call (7 and 12, or the run fails) and, at layer3, each launch's device time in
     launch order (``tools/bench_fused_bottleneck.py``'s ``time_bneck``).

Output, last three lines: {"kernels": [...]}; the card's name and power limit from
nvidia-smi; {"ok": true, "device": {...}}. float32 convolutions and matmuls run without
TF32 (both allow_tf32 flags are set False); the main paths' convolutions run under bf16
autocast.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simt_tpu_torch.config import (ModelConfig, OptimConfig, SimTConfig,  # noqa: E402
                                   TrainConfig)
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch  # noqa: E402
from simt_tpu_torch.eval import evaluate  # noqa: E402
from simt_tpu_torch.models import ResNetMulti, deeplab_multi, init_weights  # noqa: E402
from simt_tpu_torch.models import layers  # noqa: E402
from simt_tpu_torch.ops.bottleneck import fused_bottleneck  # noqa: E402
from simt_tpu_torch.ops.fused_losses import teacher_conf  # noqa: E402
from simt_tpu_torch.ops.kernels import _build  # noqa: E402
from simt_tpu_torch.ops.kernels import bottleneck, conv3x3, eval_fused, loss_fused  # noqa: E402
from simt_tpu_torch.tools import bench_fused_bottleneck, train_simt, train_warmup  # noqa: E402
from simt_tpu_torch.tools.bench_fused_bottleneck import (BNECK, bneck_calls,  # noqa: E402
                                                         bneck_inputs, time_bneck)
from simt_tpu_torch.tools.bench_conv3x3 import (KERNEL_WORD, conv_calls,  # noqa: E402
                                                cuda_ms, profile_kernels, time_conv)
from simt_tpu_torch.train import (create_simt_state, create_warmup_state,  # noqa: E402
                                  make_simt_step, make_warmup_step)
from simt_tpu_torch.utils import format_warmup_line  # noqa: E402

SEED = 0
C = 19
OUT_HW = (1024, 2048)
LOGIT_HW = ((65, 129), (81, 161))  # stride-8 maps of the 512x1024 and 640x1280 inputs
N_IMAGES = 4
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor-core) flop/s,
# bf16 dense tensor-core flop/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
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


def eval_inputs(rng: np.random.Generator, batch: int, hw_a=LOGIT_HW[0], hw_b=LOGIT_HW[1],
                out_hw=OUT_HW, c=C, zero_b=False):
    dev = "cuda"
    la = torch.from_numpy((rng.standard_normal((batch, *hw_a, c)) * 3)
                          .astype(np.float32)).to(dev)
    lb = torch.from_numpy((rng.standard_normal((batch, *hw_b, c)) * 3)
                          .astype(np.float32)).to(dev)
    if zero_b:
        lb.zero_()
    gt = rng.integers(0, c + 5, size=(batch, *out_hw)).astype(np.int32)  # >= c: invalid
    gt[rng.random((batch, *out_hw)) < 0.2] = 255
    return la, lb, torch.from_numpy(gt).to(dev)


def phase_kernel_vs_plain(rng: np.random.Generator) -> dict:
    """eval_fused against its plain version; returns the worst errors seen.

    The main path's shapes, then edge cases off that path: ragged row and column
    counts, another class count, a single output pixel, and more than 48 KB of
    shared memory (the opt-in launch attribute).
    """
    worst = {"max_abs_err": 0, "l1_err": 0, "match": True}
    cases = {"batch1": dict(batch=1), "batch2": dict(batch=2),
             "warmup_zero_1x1": dict(batch=1, hw_b=(1, 1), zero_b=True),
             "edge_ragged_c5": dict(batch=2, hw_a=(7, 13), hw_b=(3, 4), out_hw=(37, 301),
                                    c=5),
             "edge_single_pixel": dict(batch=1, hw_a=(4, 6), hw_b=(1, 1), out_hw=(1, 1)),
             "edge_smem_over_48k": dict(batch=1, hw_a=(9, 400), hw_b=(11, 300),
                                        out_hw=(64, 1000))}
    for name, kw in cases.items():
        la, lb, gt = eval_inputs(rng, **kw)
        out_hw, c = kw.get("out_hw", OUT_HW), kw.get("c", C)
        got = eval_fused.multiscale_argmax_hist(la, lb, gt, out_hw=out_hw, num_classes=c)
        want = eval_fused.multiscale_argmax_hist_reference(la, lb, gt, out_hw=out_hw,
                                                           num_classes=c)
        torch.cuda.synchronize()
        got, want = got.cpu().long(), want.cpu().long()
        counted = int(((gt >= 0) & (gt < c)).sum())
        l1 = int((got - want).abs().sum())
        mx = int((got - want).abs().max())
        # A near-tie argmax flip moves two counts; FMA contraction differs from the
        # plain version's rounding.
        limit = max(2.0, 2e-5 * out_hw[0] * out_hw[1] * kw["batch"])
        ok = int(got.sum()) == int(want.sum()) == counted and l1 <= limit
        print(f"eval_fused vs plain [{name}]: total {int(got.sum())}/{int(want.sum())} "
              f"(counted {counted}), L1 {l1} (limit {limit:.0f}), max abs {mx}: "
              f"{'ok' if ok else 'MISMATCH'}")
        worst["max_abs_err"] = max(worst["max_abs_err"], mx)
        worst["l1_err"] = max(worst["l1_err"], l1)
        worst["match"] = worst["match"] and ok
    if not worst["match"]:
        fail("eval_fused kernel disagrees with its plain version")
    return worst


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
    lines = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
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
    if hist.sum() != N_IMAGES * OUT_HW[0] * OUT_HW[1] or not math.isfinite(miou):
        fail(f"main path histogram total {hist.sum()} or mIoU {miou} is wrong")
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


def phase_kernel_times(rng: np.random.Generator, launches: dict, worst: dict) -> dict:
    la, lb, gt = eval_inputs(rng, batch=1)
    dev = la.device
    taps_i, taps_f = eval_fused.device_taps(*LOGIT_HW[0], *LOGIT_HW[1], OUT_HW, dev)
    hist = torch.zeros((C, C), dtype=torch.int32, device=dev)
    kernel_ms = cuda_ms(lambda: eval_fused.launch(la, lb, gt, taps_i, taps_f, hist),
                        iters=200)
    wrapper_ms = cuda_ms(lambda: eval_fused.multiscale_argmax_hist(
        la, lb, gt, out_hw=OUT_HW, num_classes=C), iters=200)
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
    counted = int(((gt >= 0) & (gt < C)).sum())
    nbytes, ops = eval_fused.work(*LOGIT_HW[0], *LOGIT_HW[1], OUT_HW, C, batch=1,
                                  n_counted=counted)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOP_S * 1e3
    return {
        "name": "multiscale_argmax_hist", "route": "cuda",
        "source": "simt_tpu_torch/csrc/eval_fused.cu",
        "replaces": "simt_tpu/ops/pallas/eval_fused.py:35",
        "launches": launches["multiscale_argmax_hist"],
        "max_abs_err": worst["max_abs_err"], "l1_err": worst["l1_err"],
        "match": worst["match"],
        "ms": kernel_ms, "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "bytes": nbytes, "ops": ops,
        "shape": "la 1x65x129x19 f32, lb 1x81x161x19 f32, gt 1x1024x2048 i32 -> 19x19 i32",
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
# softmax denominator and picked posterior with the kernel's operations in its order.
# The sums differ in summation order only (float32 over up to 1M pixels): 1e-5
# relative. dT sums the same terms in another order (the kernel's shared-memory float
# atomics included): 1e-4 of max|dT|. dxcat: 1e-5 of max|dxcat|.
TOL_SUMS, TOL_DT, TOL_DX = 1e-5, 1e-4, 1e-5


def loss_inputs(rng: np.random.Generator, batch: int, h8: int, w8: int, hh: int,
                ww: int):
    dev = "cuda"
    c, tot = C, C + O
    xcat = torch.from_numpy((rng.standard_normal((batch, h8, w8, 2 * tot)) * 2)
                            .astype(np.float32)).to(dev)
    tp = torch.softmax(torch.from_numpy((rng.standard_normal((batch, h8, w8, c)) * 3)
                                        .astype(np.float32)), -1).to(dev)
    label = rng.integers(0, c, (batch, hh, ww)).astype(np.int32)
    label[rng.random((batch, hh, ww)) < 0.1] = 255
    conf = teacher_conf(tp, (hh, ww), num_classes=c, threshold_high=0.8,
                        threshold_low=0.2)
    t1, t2 = (torch.softmax(torch.from_numpy(rng.standard_normal((tot, c))
                                             .astype(np.float32)), -1).to(dev)
              for _ in range(2))
    return xcat, torch.from_numpy(label).to(dev), conf, t1, t2


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def phase_loss_kernels_vs_plain(rng: np.random.Generator) -> dict:
    """B2/B3 against loss_core_fwd_reference / loss_core_bwd_reference on the card."""
    h8, w8 = TRAIN_LOGIT_HW
    hh, ww = TRAIN_HW
    cases = {"batch1": dict(batch=1), "batch2": dict(batch=2),
             "all_ignored": dict(batch=1, labels=255),
             "all_unknown": dict(batch=1, conf=C),
             "edge_37x301_from_6x39": dict(batch=2, h8=6, w8=39, hh=37, ww=301),
             "anchor_tie_across_blocks": dict(batch=2, tie=True)}
    worst = {"match": True, "cases": {}}
    for name, kw in cases.items():
        shape = dict(batch=kw["batch"], h8=kw.get("h8", h8), w8=kw.get("w8", w8),
                     hh=kw.get("hh", hh), ww=kw.get("ww", ww))
        xcat, label, conf, t1, t2 = loss_inputs(rng, **shape)
        if "labels" in kw:
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
        got = loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kwc)
        want = loss_fused.loss_core_fwd_reference(xcat, label, conf, t1, t2, **kwc)
        g = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).cuda()
        dgot = loss_fused.loss_core_bwd(g, xcat, label, conf, t1, t2, **kwc)
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
        ok = (exact and err["sums_rel"] <= TOL_SUMS and err["dt1_rel"] <= TOL_DT
              and err["dt2_rel"] <= TOL_DT and err["dx_rel"] <= TOL_DX
              and bool(torch.isfinite(dgot[0]).all()))
        if want_idx is not None:
            ok = ok and int(got[2][0, 3]) == want_idx and float(got[1][0, 3]) == 40.0
        print(f"loss_core vs plain [{name}] {shape}: counts/anchor/presence "
              f"{'equal' if exact else 'DIFFER'}, sums rel {err['sums_rel']:.3e}, "
              f"dT1 {err['dt1_rel']:.3e}, dT2 {err['dt2_rel']:.3e}, dxcat "
              f"{err['dx_rel']:.3e} of max: {'ok' if ok else 'MISMATCH'}")
        worst["cases"][name] = err
        worst["match"] = worst["match"] and ok
    if not worst["match"]:
        fail("loss_core kernels disagree with their plain versions")
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


def phase_train_main_path(tmp: str) -> dict:
    """The SimT step at full width through the CLI's own calls."""
    args = train_simt.build_parser().parse_args(
        ["--synthetic", "--preset", "simt_bapa_lr25",
         "--num-steps-stop", str(2 + TIMED_STEPS)])
    cfg = train_simt.build_config(args)
    cd = os.path.join(tmp, "cd_uniform.npy")
    np.save(cd, (np.ones(C) / C).astype(np.float32))
    cfg = cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=cd))
    t0 = time.perf_counter()
    student, teacher = train_simt.build_models(cfg)
    state = create_simt_state(student, teacher, cfg,
                              torch.Generator().manual_seed(cfg.random_seed + 2), "cuda")
    batches = train_simt.synthetic_batches(cfg, cfg.num_steps_stop, torch.device("cuda"))
    step = make_simt_step(cfg)
    torch.cuda.synchronize()
    print(f"train set-up (models, state, {len(batches)} synthetic 512x1024 batches): "
          f"{time.perf_counter() - t0:.1f} s")
    want = TIMED_STEPS * cfg.optim.iter_size
    # One B2 and one B3 a sub-batch. Student and teacher forwards (33 each); the input
    # gradient and the weight gradient of the trained blocks only (layers 3-4: 26;
    # layers 1-2 are frozen in this stage).
    return drive_train_path(
        "SimT", step, state, batches,
        lambda i, v: train_simt.format_simt_line(i, cfg.num_steps, v)
        + f" loss = {v['loss']:.4f}",
        {"loss_core_fwd": want, "loss_core_bwd": want,
         "conv3x3_fwd": (2 * N_CONV2 + N_CONV2_L34) * want,
         "conv3x3_wgrad": N_CONV2_L34 * want})


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


def profile_steps(step, state, batches, n: int = 3, report: bool = True,
                  ours=("loss_fwd", "loss_bwd", "conv3x3")) -> float:
    """Kernel time per step from torch.profiler over ``n`` more steps; with ``report``,
    prints the kernels that take the most of it and those of this package (names
    containing ``ours``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    # Device-side events, without the annotation spans that enclose kernels.
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    total = sum(by_name.values())
    if not report:
        return total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"train step kernels (profiler, ms per step, {len(kernels) / n:.0f} launches per "
          f"step, total {total:.3f}): " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    mine = {k: v for k, v in by_name.items() if any(o in k for o in ours)}
    print("this package's kernels in the step (ms per step): "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in mine.items())
          + f"; sum {sum(mine.values()):.3f}")
    return total


def phase_loss_kernel_times(rng: np.random.Generator, launches: dict, worst: dict) -> list:
    """B2/B3 at the main path's shapes: the wrapper (what the step calls), the plain
    version, the bound. No single PyTorch call computes either function: library_ms is
    null."""
    h8, w8 = TRAIN_LOGIT_HW
    hh, ww = TRAIN_HW
    xcat, label, conf, t1, t2 = loss_inputs(rng, 1, h8, w8, hh, ww)
    g = torch.ones((2, 8), device="cuda")
    kwc = dict(num_classes=C, threshold_high=0.8)
    fns = {
        "loss_core_fwd": (lambda: loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kwc),
                          lambda: loss_fused.loss_core_fwd_reference(
                              xcat, label, conf, t1, t2, **kwc)),
        "loss_core_bwd": (lambda: loss_fused.loss_core_bwd(g, xcat, label, conf, t1, t2,
                                                           **kwc),
                          lambda: loss_fused.loss_core_bwd_reference(
                              g, xcat, label, conf, t1, t2, **kwc)),
    }
    work = loss_fused.work(1, h8, w8, hh, ww, C, O)
    main = worst["cases"]["batch1"]
    entries = []
    for name, (kernel, plain) in fns.items():
        direction = name[-3:]
        ms = cuda_ms(kernel, iters=50)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        nbytes, ops = work[direction]
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOP_S * 1e3
        fwd = direction == "fwd"
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
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "shape": ("xcat 1x65x129x68 f32, label 1x512x1024 i32, conf 1x512x1024 u8, "
                      "T 2x34x19 f32" + (" -> sums 2x8, anchors 2x34" if fwd else
                                         " + g 2x8 -> dxcat 1x65x129x68, dT 2x34x19")),
        })
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f}"
              f" ms by {entries[-1]['bound_by']})")
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
    base = train_warmup.build_model(cfg)
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
    state = create_warmup_state(train_warmup.build_model(cfg), cfg, "cuda")
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
                        f"{r['launches']:g} launches (plain {r['plain_ms']:.3f}, bound "
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
    loss_worst = phase_loss_kernels_vs_plain(rng)
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
        warm = phase_warmup_main_path()
    torch.cuda.empty_cache()
    bench = phase_bneck_bench()
    entry = phase_kernel_times(rng, launches, worst)
    device_ms = sum(forward_ms) + entry["kernel_ms"]
    print(f"device time per image (forwards + kernel): {device_ms:.3f} ms; main path "
          f"wall time per image: {seconds / N_IMAGES * 1e3:.3f} ms; device busy share "
          f"(estimate): {device_ms * N_IMAGES / (seconds * 1e3):.3f}")
    loss_entries = phase_loss_kernel_times(rng, train["launches"], loss_worst)
    paths = {"warmup": warm["launches"], "simt": train["launches"], "eval": launches}
    variants = {"warmup": warm["variants"], "simt": train["variants"], "eval": eval_variants}
    conv_entries = phase_conv_times(paths, variants, conv_worst)
    bneck_entries = phase_bneck_times(bench, paths, bneck_worst)

    print(json.dumps({"kernels": [entry, *loss_entries, *conv_entries, *bneck_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
