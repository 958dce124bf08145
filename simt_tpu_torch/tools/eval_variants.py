"""The eval head's variants on the two-scale evaluation (counterpart of the JAX
package's ``experiments/wide_aspp_eval_fault/repro.py``): what the fused eval head (B1,
``ops/kernels/eval_fused.py``) is worth end to end.

The JAX program pins a TPU worker fault of one formulation of the ASPP heads with the
Pallas eval head in one program and times the restructurings. The port's heads have
one formulation (a cuDNN conv a dilation, summed in float32; ROADMAP decision C-d3),
and there is no program boundary to move, only the order of work on the card, so its
variants map as follows:

  ==============================  ==========  =========================================
  JAX variant                     port        what it does
  ==============================  ==========  =========================================
  ``fused_wide``,                 ``fused``   the two forwards, then B1, queued back to
  ``fused_pertap``                            back on one stream (``evaluate``'s path)
  ``split_wide``                  ``split``   the same with ``torch.cuda.synchronize()``
                                              between the forwards and B1 (the jit
                                              boundary's counterpart)
  ``nonpallas_wide``              ``unfused`` the forwards, then ``F.interpolate``
                                              (align corners) x2 summed, ``argmax``
                                              and ``bincount`` (``fast_hist``)
  ==============================  ==========  =========================================

The fixture is the JAX program's: ``deeplab_multi`` at 19 + 15 classes, open set,
bf16 autocast, seeded init; seeded random inputs at 512x1024 and 640x1280 and random
ground truth in [0, 19) at 1024x2048 (uint8 on the card, as the eval path sends it);
head 2's known channels. Each variant makes one warm-up call, then 20 timed calls,
the last read back to the host, and prints one JSON line with its img/s and
B1's launches. The histograms are then held to one another: ``fused`` and ``split``
equal bit for bit, ``unfused`` with equal totals and an L1 of at most 2e-5 H W against
them (B1's gate against its plain version); the run exits 1 if they disagree.

    python -m simt_tpu_torch.tools.eval_variants            the card, all three
    python -m simt_tpu_torch.tools.eval_variants --smoke --device cpu
        layers (1,1,1,1), float32, 64x128 + 80x160 -> 128x256: the plumbing
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import IMG_MEAN_BGR
from ..data.pipeline import normalize_image
from ..device import resolve_device
from ..models import ResNetMulti, init_weights
from ..ops.kernels.eval_fused import multiscale_argmax_hist
from ..ops.metrics import fast_hist

VARIANTS = ("fused", "split", "unfused")
C, O = 19, 15
SEED = 0
# (model layers, the two input scales (h, w), the output (h, w), compute dtype)
FULL = ((3, 4, 23, 3), ((512, 1024), (640, 1280)), (1024, 2048), torch.bfloat16)
SMOKE = ((1, 1, 1, 1), ((64, 128), (80, 160)), (128, 256), torch.float32)
L1_PER_PIXEL = 2e-5  # B1's gate against its plain version (PERF.md section 2)


def fixture(device: torch.device, geometry=FULL):
    """(model in eval mode on ``device``, the two images (1, h, w, 3) float32, gt (1, H,
    W) uint8) of the seeded fixture."""
    layers, (sa, sb), out_hw, dtype = geometry
    model = init_weights(ResNetMulti(C, O, True, layers=layers, dtype=dtype),
                         torch.Generator().manual_seed(SEED))
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device=device, memory_format=fmt).eval()
    rng = np.random.RandomState(SEED)
    xa = torch.from_numpy(rng.randn(1, *sa, 3).astype(np.float32)).to(device)
    xb = torch.from_numpy(rng.randn(1, *sb, 3).astype(np.float32)).to(device)
    gt = torch.from_numpy(rng.randint(0, C, (1, *out_hw)).astype(np.uint8)).to(device)
    return model, xa, xb, gt


@torch.inference_mode()
def head2(model: torch.nn.Module, image: torch.Tensor) -> torch.Tensor:
    """Head 2's known-class logits, float32 NHWC (``evaluate``'s forward)."""
    x = normalize_image(image, IMG_MEAN_BGR).permute(0, 3, 1, 2)
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    return model(x)[1][:, :C].float().permute(0, 2, 3, 1).contiguous()


def variant_call(name: str, model, xa, xb, gt) -> Callable[[], torch.Tensor]:
    """A call of variant ``name``: the image's (C, C) int32 histogram on the card."""
    out_hw = tuple(gt.shape[1:])

    def fused():
        hist = torch.zeros((C, C), dtype=torch.int32, device=gt.device)
        return multiscale_argmax_hist(head2(model, xa), head2(model, xb), gt,
                                      out_hw=out_hw, num_classes=C, out=hist)

    def split():
        a, b = head2(model, xa), head2(model, xb)
        if gt.device.type == "cuda":
            torch.cuda.synchronize(gt.device)
        hist = torch.zeros((C, C), dtype=torch.int32, device=gt.device)
        return multiscale_argmax_hist(a, b, gt, out_hw=out_hw, num_classes=C, out=hist)

    def up(x):
        return F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
                             align_corners=True)

    @torch.inference_mode()
    def unfused():
        logits = up(head2(model, xa)) + up(head2(model, xb))
        return fast_hist(gt, torch.argmax(logits, dim=1), C)

    return {"fused": fused, "split": split, "unfused": unfused}[name]


def check(hists: Dict[str, torch.Tensor], out_hw: Tuple[int, int]) -> Dict:
    """The histograms held to one another: ``fused`` and ``split`` bit for bit,
    ``unfused`` against the fused one by totals and L1 (at most ``L1_PER_PIXEL`` H W)."""
    out = {"ok": True}
    fused = [hists[v] for v in ("fused", "split") if v in hists]
    if len(fused) == 2:
        out["fused_split_equal"] = bool(torch.equal(*fused))
        out["ok"] &= out["fused_split_equal"]
    if fused and "unfused" in hists:
        a = fused[0].to(torch.int64)
        b = hists["unfused"].to(torch.int64)
        out["unfused_l1"] = int((a - b).abs().sum())
        out["unfused_l1_limit"] = L1_PER_PIXEL * out_hw[0] * out_hw[1]
        out["totals_equal"] = int(a.sum()) == int(b.sum())
        out["ok"] &= out["totals_equal"] and out["unfused_l1"] <= out["unfused_l1_limit"]
    return out


def run(variants: Sequence[str] = VARIANTS, device="cuda", calls: int = 20,
        geometry=FULL, print_fn: Callable[[str], None] = print) -> Dict:
    """Each variant: one warm-up call, ``calls`` timed calls ending in a read back, one
    JSON line (img/s, B1 launches); then ``check``. Returns the records, the histograms
    (on the host) and the checks."""
    dev = resolve_device(device)
    model, xa, xb, gt = fixture(dev, geometry)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records, hists = {}, {}
    for v in variants:
        call = variant_call(v, model, xa, xb, gt)
        before = multiscale_argmax_hist.launches
        call().cpu()
        t0 = time.perf_counter()
        for _ in range(calls):
            h = call()
        hists[v] = h.cpu()
        seconds = time.perf_counter() - t0
        records[v] = {"variant": v, "img_per_sec": calls / seconds, "calls": calls,
                      "b1_launches": multiscale_argmax_hist.launches - before,
                      "device": name}
        print_fn(json.dumps(records[v]))
    checks = check(hists, tuple(gt.shape[1:]))
    print_fn(json.dumps({"checks": checks}))
    return {"records": records, "hists": hists, "checks": checks}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="eval head variants (PyTorch + CUDA)")
    p.add_argument("--smoke", action="store_true",
                   help="layers (1,1,1,1), float32, 64x128 + 80x160 -> 128x256")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """The three variants in this process (the port has no fault to isolate); exits 1
    if their histograms disagree."""
    args = build_parser().parse_args(argv)
    out = run(device=args.device, geometry=SMOKE if args.smoke else FULL)
    if not out["checks"]["ok"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
