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
     and a planted anchor tie across blocks and images;
  3. small-input checks, float32 on the card against the CPU: the whole evaluation, and
     three whole SimT steps at the golden geometry (C5+O3, layers (1,1,1,1), 32x64,
     inner_w_steps 3);
  4. main paths, each with every launch count zeroed just before and read just after:
     the two-scale ``evaluate(device="cuda")`` of a full-width open-set
     DeepLabv2-ResNet-101 over 4 synthetic 2048x1024 images; then the SimT train step
     of ``tools/train_simt.py`` (full-width student and teacher with seeded random
     weights, batch 1, 512x1024 synthetic batches, bf16 autocast): 2 warm-up steps,
     then 5 timed steps with CUDA-event times of their parts;
  5. times: per-scale forward, each kernel against its plain version, its bound and,
     where one exists, a library call computing the same function.

Output, last three lines: {"kernels": [...]}; the card's name and power limit from
nvidia-smi; {"ok": true, "device": {...}}. float32 convolutions and matmuls run without
TF32 (both allow_tf32 flags are set False); the main paths' convolutions run under bf16
autocast.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simt_tpu_torch.config import (ModelConfig, OptimConfig, SimTConfig,  # noqa: E402
                                   TrainConfig)
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch  # noqa: E402
from simt_tpu_torch.eval import evaluate  # noqa: E402
from simt_tpu_torch.models import ResNetMulti, deeplab_multi, init_weights  # noqa: E402
from simt_tpu_torch.ops.fused_losses import teacher_conf  # noqa: E402
from simt_tpu_torch.ops.kernels import _build  # noqa: E402
from simt_tpu_torch.ops.kernels import eval_fused, loss_fused  # noqa: E402
from simt_tpu_torch.tools import train_simt  # noqa: E402
from simt_tpu_torch.train import create_simt_state, make_simt_step  # noqa: E402

SEED = 0
C = 19
OUT_HW = (1024, 2048)
LOGIT_HW = ((65, 129), (81, 161))  # stride-8 maps of the 512x1024 and 640x1280 inputs
N_IMAGES = 4
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor-core) flop/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    eval_fused.multiscale_argmax_hist.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou, hist = evaluate(model, **dict(kw, print_fn=lines.append))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"multiscale_argmax_hist": eval_fused.multiscale_argmax_hist.launches}
    print(lines[-1])
    print(f"main path: evaluate(simt, two scales, {OUT_HW[0]}x{OUT_HW[1]}) over "
          f"{N_IMAGES} images: {seconds:.3f} s, {N_IMAGES / seconds:.3f} img/s, "
          f"mIoU {miou}, launches {launches}")
    if launches["multiscale_argmax_hist"] != N_IMAGES:
        fail(f"eval_fused launched {launches['multiscale_argmax_hist']} times for "
             f"{N_IMAGES} images")
    if hist.sum() != N_IMAGES * OUT_HW[0] * OUT_HW[1] or not math.isfinite(miou):
        fail(f"main path histogram total {hist.sum()} or mIoU {miou} is wrong")
    return launches, seconds


def phase_forward_times(model: torch.nn.Module) -> list:
    gen = torch.Generator().manual_seed(SEED)
    times = []
    for (h8, w8), (w, h) in zip(LOGIT_HW, ((1024, 512), (1280, 640))):
        x = (torch.randn(1, 3, h, w, generator=gen) * 50).cuda()
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            x1, x2 = model(x)
            ms = cuda_ms(lambda: model(x), iters=10)
        for out in (x1, x2):
            if out.shape != (1, C + 15, h8, w8) or not torch.isfinite(out).all():
                fail(f"forward at {w}x{h}: shape {tuple(out.shape)} or non-finite values")
        print(f"forward {w}x{h} (bf16 autocast, channels_last): {ms:.3f} ms")
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
    # Warm-up: cuDNN plans, allocator, kernel tables.
    metrics = [step(state, batches[i % len(batches)]) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_fused.loss_core_fwd.launches = 0
    loss_fused.loss_core_bwd.launches = 0
    step.spans = []
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        metrics.append(step(state, batches[(2 + i) % len(batches)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"loss_core_fwd": loss_fused.loss_core_fwd.launches,
                "loss_core_bwd": loss_fused.loss_core_bwd.launches}
    parts = {}
    for name, start, end in step.spans:
        parts[name] = parts.get(name, 0.0) + start.elapsed_time(end) / TIMED_STEPS
    step.spans = None
    for i, m in enumerate(metrics):  # the warm-up steps' lines too
        vals = {k: float(v) for k, v in m.items()}
        print(train_simt.format_simt_line(i, cfg.num_steps, vals)
              + f" loss = {vals['loss']:.4f}")
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"train step {i}: non-finite metrics {vals}")
    want = TIMED_STEPS * cfg.optim.iter_size
    print(f"main path: SimT train step, full width, batch 1, 512x1024, bf16 autocast: "
          f"{TIMED_STEPS} steps in {seconds:.3f} s, {TIMED_STEPS / seconds:.3f} steps/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    print("train step parts (CUDA events, ms per step): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; sum {sum(parts.values()):.3f}, wall {seconds / TIMED_STEPS * 1e3:.3f}")
    if launches["loss_core_fwd"] != want or launches["loss_core_bwd"] != want:
        fail(f"loss core launched {launches} times for {want} sub-batch steps")
    device_ms = profile_steps(step, state, batches)
    print(f"train step device busy share: {device_ms:.3f} ms of kernels per step (profiler)"
          f" over {seconds / TIMED_STEPS * 1e3:.3f} ms wall per step (timed run) = "
          f"{device_ms / (seconds / TIMED_STEPS * 1e3):.3f}")
    return {"launches": launches, "seconds": seconds, "parts": parts,
            "device_ms": device_ms}


def profile_steps(step, state, batches, n: int = 3) -> float:
    """Kernel time per step from torch.profiler over ``n`` more steps, with the kernels
    that take the most of it."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"train step kernels (profiler, ms per step, {len(kernels) / n:.0f} launches per "
          f"step, total {total:.3f}): " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    ours = {k: v for k, v in by_name.items() if "loss_fwd" in k or "loss_bwd" in k}
    print("loss core kernels in the step (ms per step): "
          + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ours.items()))
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_small_reference(tmp)
        phase_small_steps(tmp)
        model = deeplab_multi(C, 15, openset=True)
        init_weights(model, torch.Generator().manual_seed(SEED))
        launches, seconds = phase_main_path(tmp, model)
        forward_ms = phase_forward_times(model)
        del model
        torch.cuda.empty_cache()
        train = phase_train_main_path(tmp)
    entry = phase_kernel_times(rng, launches, worst)
    device_ms = sum(forward_ms) + entry["kernel_ms"]
    print(f"device time per image (forwards + kernel): {device_ms:.3f} ms; main path "
          f"wall time per image: {seconds / N_IMAGES * 1e3:.3f} ms; device busy share "
          f"(estimate): {device_ms * N_IMAGES / (seconds * 1e3):.3f}")
    loss_entries = phase_loss_kernel_times(rng, train["launches"], loss_worst)

    print(json.dumps({"kernels": [entry, *loss_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
