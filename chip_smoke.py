#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (simt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build: compile every CUDA source of the package with nvcc for sm_90a, in parallel;
  2. kernels vs plain: each kernel's wrapper against its plain PyTorch version on the
     card, at the main path's shapes (two-scale eval: 65x129 + 81x161 logits, 19
     classes, -> 1024x2048; batch 1 and 2; warmup's 1x1 zero operand), then a few
     edge cases off that path;
  3. small-input check: the whole evaluation on the card against the same model on
     the CPU (float32, tiny fixture);
  4. main path: full-width open-set DeepLabv2-ResNet-101 with seeded random weights,
     two-scale ``evaluate(device="cuda")`` over 4 synthetic 2048x1024 val images; every
     kernel's launch count is zeroed just before and read just after;
  5. times: per-scale forward, each kernel against its plain version, its bound and a
     library call computing the same function.

Output, last three lines: {"kernels": [...]}; the card's name and power limit from
nvidia-smi; {"ok": true, "device": {...}}. float32 convolutions and matmuls run without
TF32 (both allow_tf32 flags are set False); the main path's forward is bf16 autocast.
"""

from __future__ import annotations

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

from simt_tpu_torch.eval import evaluate  # noqa: E402
from simt_tpu_torch.models import ResNetMulti, deeplab_multi, init_weights  # noqa: E402
from simt_tpu_torch.ops.kernels import _build  # noqa: E402
from simt_tpu_torch.ops.kernels import eval_fused  # noqa: E402
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture  # noqa: E402

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_small_reference(tmp)
        model = deeplab_multi(C, 15, openset=True)
        init_weights(model, torch.Generator().manual_seed(SEED))
        launches, seconds = phase_main_path(tmp, model)
    forward_ms = phase_forward_times(model)
    entry = phase_kernel_times(rng, launches, worst)
    device_ms = sum(forward_ms) + entry["kernel_ms"]
    print(f"device time per image (forwards + kernel): {device_ms:.3f} ms; main path "
          f"wall time per image: {seconds / N_IMAGES * 1e3:.3f} ms; device busy share "
          f"(estimate): {device_ms * N_IMAGES / (seconds * 1e3):.3f}")

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
