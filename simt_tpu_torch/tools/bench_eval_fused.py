"""Times the eval head's kernel (B1) on one CUDA card at the eval path's shapes, on four
gt maps.

    python3 -m simt_tpu_torch.tools.bench_eval_fused --kernels
    python3 -m simt_tpu_torch.tools.bench_eval_fused --kernels --package-root build/parent
    python3 -m simt_tpu_torch.tools.bench_eval_fused --kernels --gt iid,regions

Shapes: logits 1x65x129x19 and 1x81x161x19 float32 (the stride-8 maps of the 512x1024
and 640x1280 inputs), gt 1x1024x2048. Gt maps (``--gt``):

  - ``iid``: every pixel's label drawn on its own from [0, 24) (5 of 24 outside the 19
    classes), 20% of the pixels 255; logits N(0, 3^2);
  - ``regions``: one class per 64x64-pixel cell, 10% of the cells 255: the structure of
    real ground truth, constant over regions of many pixels, on a grid aligned to the
    kernel's warps (32 columns); the same logits;
  - ``shifted``: the same cells with the grid moved down and across by 1-63 pixels
    (drawn from the seed, off the warps' columns), as a region's edge falls anywhere;
  - ``eval``: the gt and both scales' logits that ``evaluate`` hands the head for the
    synthetic fixture's first 2048x1024 image and the full-width model of
    ``chip_smoke.py`` (seeded random weights), captured without editing ``evaluate``.

For each map it prints ``ms``, the wrapper back to back (CUDA events), ``kernel_ms`` the
device time of the call's ``eval_fused`` kernel (profiler, held to the call's device
time by events: ``timing.checked_launches``), ``device_ops`` and ``per_launch``
(every device operation of one call in launch order: a fill would show here) and
``host_us``; and the bound from ``work()`` with the map's counted pixels and gt width.
This package is timed as the eval path calls it (uint8 gt, ``out=`` the running
histogram: one device operation) and with int32 gt; a package without ``out=`` (the first
port) as its JAX-shaped call with int32 gt. Timing is ``tools/timing.py``'s.

``--package-root DIR[,DIR...]`` times other checkouts' packages (for example the parent
commit unpacked under ``build/``, or copies with one part of the kernel changed) in turns
with this one on the same inputs: the others, this, this, the others in reverse order,
one JSON line each; a last line holds every package's histograms equal bit for bit on
every map (or the tool exits non-zero). ``--events`` times each call by CUDA events
alone (``timing.busy_ms``: the card kept busy, so the call's device time), which
is quick enough for many packages. Needs a card: it exits on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import inspect
import json
import tempfile
from typing import Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from ..ops.interp import interp_taps
from ..ops.kernels.fma import fma32
from ..ops.metrics import fast_hist
from .timing import busy_ms, time_launches
from .bench_fused_bottleneck import _HERE, package
from .bench_loss_fused import label_map

_ROOT = __package__.split(".")[0]  # this module's own package, run with -m too

C = 19
OUT_HW = (1024, 2048)
LOGIT_HW = ((65, 129), (81, 161))  # stride-8 maps of the 512x1024 and 640x1280 inputs
GT_MAPS = ("iid", "regions", "shifted", "eval")
CELL = 64  # pixels a side of one ``regions`` cell
KERNEL_WORD = "eval_fused"  # every kernel of csrc/eval_fused.cu is named eval_fused_*


def head_inputs(rng: np.random.Generator, batch: int = 1, hw_a=LOGIT_HW[0],
                hw_b=LOGIT_HW[1], out_hw=OUT_HW, c: int = C, zero_b: bool = False,
                gt: str = "iid", device="cuda"):
    """(la, lb, gt int32) from ``rng``: logits N(0, 3^2) (``zero_b``: the second scale 0,
    as warmup's eval hands it); gt as the map ``gt`` says (``iid``, ``regions`` or
    ``shifted``; see the module's docstring)."""
    la = torch.from_numpy((rng.standard_normal((batch, *hw_a, c)) * 3)
                          .astype(np.float32)).to(device)
    lb = torch.from_numpy((rng.standard_normal((batch, *hw_b, c)) * 3)
                          .astype(np.float32)).to(device)
    if zero_b:
        lb.zero_()
    if gt == "iid":
        g = label_map(rng, "iid", batch, *out_hw, classes=c + 5, ignore=0.2)
    else:
        g = label_map(rng, gt, batch, *out_hw, classes=c, ignore=0.1, cell=CELL)
    return la, lb, torch.from_numpy(g).to(device)


@functools.lru_cache(maxsize=2)
def eval_inputs(seed: int = 0):
    """(la, lb, gt) that ``evaluate(mode="simt")`` of this package hands the head for the
    synthetic fixture's first 2048x1024 image and the full-width open-set model with
    seeded random weights, on the card (made once a seed): ``multiscale_argmax_hist``
    is wrapped in ``evaluate``'s module to record its arguments."""
    from ..data.synthetic import make_cityscapes_fixture
    from ..models import deeplab_multi, init_weights

    ev = importlib.import_module(_ROOT + ".eval.evaluate")
    seen = {}
    head = ev.multiscale_argmax_hist

    def record(a, b, gt, **kw):
        seen.setdefault("args", (a.clone(), b.clone(), gt.clone()))
        return head(a, b, gt, **kw)

    model = init_weights(deeplab_multi(C, 15, openset=True),
                         torch.Generator().manual_seed(seed))
    with tempfile.TemporaryDirectory(prefix="bench_eval_fused_") as tmp, \
            mock.patch.object(ev, "multiscale_argmax_hist", record):
        paths = make_cityscapes_fixture(tmp, n_train=0, n_val=1,
                                        image_wh=(OUT_HW[1], OUT_HW[0]), seed=seed)
        ev.evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                    gt_dir=paths["gt_dir"], print_fn=lambda s: None, device="cuda")
    del model
    torch.cuda.empty_cache()
    return seen["args"]


def make_maps(names: Sequence[str], seed: int = 0) -> dict:
    """{map: (la, lb, gt int32)} on the card, each from ``seed``."""
    maps = {}
    for name in names:
        if name == "eval":
            la, lb, gt = eval_inputs(seed)
            maps[name] = (la, lb, gt.int())
        else:
            maps[name] = head_inputs(np.random.default_rng(seed), gt=name)
    return maps


def _taps(n_in: int, n_out: int, device) -> tuple:
    lo, hi, w0, w1 = interp_taps(n_in, n_out)
    return (torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(hi.astype(np.int64)).to(device),
            torch.from_numpy(w0.copy()).to(device), torch.from_numpy(w1.copy()).to(device))


def kernel_arithmetic(la: torch.Tensor, lb: torch.Tensor, gt: torch.Tensor, *,
                      out_hw: Tuple[int, int] = OUT_HW, num_classes: int = C,
                      row_range: Optional[Tuple[int, int]] = None,
                      chunk: int = 64) -> torch.Tensor:
    """The (C, C) int32 histogram that ``csrc/eval_fused.cu`` computes, by its own
    operations in PyTorch: per scale the H step ``fma(w1h, x_hi, w0h * x_lo)``, the W
    step ``fma(w1w, z_hi, w0w * z_lo)``, the float32 sum of the scales, the first index
    of the maximum (the first NaN if there is one). The kernel must equal it bit for bit;
    the plain version (matmuls) only within a near-tie flip. ``chunk`` output rows at a
    time."""
    la, lb, gt = (la[None], lb[None], gt[None]) if gt.dim() == 2 else (la, lb, gt)
    hh, ww = out_hw
    row0, rows = (0, hh) if row_range is None else row_range
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=la.device)
    taps = [(*_taps(x.shape[1], hh, x.device), *_taps(x.shape[2], ww, x.device))
            for x in (la, lb)]
    for r0 in range(row0, row0 + rows, chunk):
        rs = slice(r0, min(r0 + chunk, row0 + rows))
        pred = None
        for x, (lo_h, hi_h, w0_h, w1_h, lo_w, hi_w, w0_w, w1_w) in zip((la, lb), taps):
            z = fma32(w1_h[rs, None, None], x[:, hi_h[rs]],
                      w0_h[rs, None, None] * x[:, lo_h[rs]])
            out = fma32(w1_w[:, None], z[:, :, hi_w], w0_w[:, None] * z[:, :, lo_w])
            pred = out if pred is None else pred + out
        nan = torch.isnan(pred)
        arg = torch.where(nan.any(-1), nan.int().argmax(-1), pred.argmax(-1))
        hist += fast_hist(gt[:, rs], arg, num_classes)
    return hist


def head_calls(eval_fused, la, lb, gt) -> dict:
    """{form: call} of ``eval_fused`` (a package's wrapper module) on these inputs: with
    ``out=``, ``uint8`` (the eval path's call) and ``int32``; without it, ``int32``, the
    JAX-shaped call that returns a fresh histogram."""
    fn = eval_fused.multiscale_argmax_hist
    kw = dict(out_hw=OUT_HW, num_classes=C)
    gt32 = gt.int()
    if "out" not in inspect.signature(fn).parameters:
        return {"int32": lambda: fn(la, lb, gt32, **kw)}
    hist = torch.zeros((C, C), dtype=torch.int32, device=la.device)
    gt8 = gt.to(torch.uint8)
    return {"uint8": lambda: fn(la, lb, gt8, out=hist, **kw),
            "int32": lambda: fn(la, lb, gt32, out=hist, **kw)}


def bound(gt: torch.Tensor, gt_bytes: int, hw_a=LOGIT_HW[0], hw_b=LOGIT_HW[1]) -> dict:
    """The least time of one call on an H100 SXM: ``work()`` on this gt's batch, counted
    pixels and width and the logits' sizes, at the peaks of ``loss_fused.bound``."""
    from ..ops.kernels import eval_fused, loss_fused

    counted = int(((gt >= 0) & (gt < C)).sum())
    batch = gt.shape[0] if gt.dim() == 3 else 1
    nbytes, ops = eval_fused.work(*hw_a, *hw_b, OUT_HW, C, batch=batch,
                                  n_counted=counted, gt_bytes=gt_bytes)
    ms, by, _ = loss_fused.bound(nbytes, ops, 0)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "counted": counted}


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", action="store_true",
                   help="time B1 alone, launch by launch (what this tool does)")
    p.add_argument("--package-root", default=_HERE,
                   help="comma-separated other checkouts' packages to time in turns "
                        "with this one")
    p.add_argument("--events", action="store_true",
                   help="time each call by CUDA events only (no profiler readings)")
    p.add_argument("--gt", default=",".join(GT_MAPS),
                   help="comma-separated gt maps: iid, regions, shifted, eval")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_eval_fused: needs a CUDA card")
    names = [n for n in args.gt.split(",") if n]
    for n in names:
        if n not in GT_MAPS:
            raise SystemExit(f"bench_eval_fused: unknown gt map {n!r}")
    maps = make_maps(names, args.seed)
    own = package(_HERE)
    others = [q for q in (package(r) for r in args.package_root.split(",") if r)
              if q.root != own.root]
    turns = [*others, own, own, *others[::-1]] if others else [own]
    results, hists = [], {}
    for pkg in turns:
        res = {"package": pkg.root, "device": torch.cuda.get_device_name(0),
               "iters": args.iters, "times": {}}
        for name, (la, lb, gt) in maps.items():
            calls = head_calls(pkg.eval_fused, la, lb, gt)
            for form in calls:  # a fresh histogram of each form
                fresh = pkg.eval_fused.multiscale_argmax_hist(
                    la, lb, gt.to(getattr(torch, form)), out_hw=OUT_HW, num_classes=C)
                hists.setdefault(name, []).append(fresh.cpu())
            res["times"][name] = (
                {form: {"busy_ms": busy_ms(call, args.iters)} for form, call in calls.items()}
                if args.events else time_launches(calls, KERNEL_WORD, args.iters))
            for form, r in res["times"][name].items():
                r.update(bound(gt, 1 if form == "uint8" else 4))
        results.append(res)
        print(json.dumps(res))
    equal = {name: all(torch.equal(h, hs[0]) for h in hs) for name, hs in hists.items()}
    print(json.dumps({"hist_equal": equal, "forms_and_turns": len(next(iter(hists.values())))}))
    if not all(equal.values()):
        raise SystemExit(f"bench_eval_fused: histograms differ between packages or gt "
                         f"widths: {equal}")
    return results


if __name__ == "__main__":
    main()
