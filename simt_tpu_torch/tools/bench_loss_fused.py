"""Times the SimT loss core's kernels (B2 forward, B3 backward) on one CUDA card, launch
by launch, on four label maps at the main path's shapes.

    python3 -m simt_tpu_torch.tools.bench_loss_fused --kernels
    python3 -m simt_tpu_torch.tools.bench_loss_fused --kernels --package-root build/parent
    python3 -m simt_tpu_torch.tools.bench_loss_fused --kernels --labels iid,shifted

Shapes: xcat 1x65x129x68 float32 (both heads' stride-8 logits, 19 known + 15 open
classes), labels 1x512x1024, T 2x34x19. Label maps (``--labels``):

  - ``iid``: every pixel's class drawn on its own, 10% of the pixels 255;
  - ``regions``: one class per 16x16-pixel cell, 10% of the cells 255: the structure of
    a real pseudo-label, constant over regions of many pixels. The cells start at
    multiples of 16, so each warp's 16 pixels (a lane pair a pixel) lie in one cell;
  - ``shifted``: the same cells with the grid moved down and across by 1-15 pixels
    (drawn from the seed), so every warp's 16 pixels straddle two cells, as a region's
    edge falls at any column in a real pseudo-label;
  - ``step``: the xcat, label, teacher labels, T1, T2 and sums cotangent that one
    full-width SimT step (``tools/train_simt.py``'s model, seeded random weights, a
    synthetic batch) hands to ``SimTLossCore``, captured without editing the step.

For each map and each of ``loss_core_fwd`` / ``loss_core_bwd`` it prints ``ms``, the
wrapper back to back (CUDA events: allocations, fills and the host's pace included);
``kernel_ms``, the device time of the call's ``loss_`` kernels (profiler, held to the
call's device time by events, ``busy_ms``: ``timing.checked_launches``);
``launches``, those kernels a call; ``per_launch``, every device operation of one call
in launch order with its device ms (fills and copies included); and ``host_us``, the
host cost of a call; and the device time of the package's full-width SimT step a step (profiler), with
its loss core kernels' share. Timing is
``tools/timing.py``'s. One JSON line a package timed.

``--package-root DIR`` times another checkout's package (for example the parent commit
unpacked under ``build/``) in turns with this one on the same inputs: DIR, this, this,
DIR, one JSON line each. Needs a card: it exits on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import json
import os
import tempfile
from types import SimpleNamespace
from typing import Optional, Sequence
from unittest import mock

import numpy as np
import torch

from .timing import profile_kernels, short, time_launches
from .bench_fused_bottleneck import _HERE, package

_ROOT = __package__.split(".")[0]  # this module's own package, run with -m too

C, O = 19, 15
LOGIT_HW = (65, 129)  # stride-8 map of a 512x1024 crop
OUT_HW = (512, 1024)
LABEL_MAPS = ("iid", "regions", "shifted", "step")
CELL = 16  # pixels a side of one ``regions`` cell
KERNEL_WORD = "loss_"  # every kernel of csrc/loss_fused.cu is named loss_*
THRESHOLD_HIGH = 0.8


def loss_inputs(rng: np.random.Generator, batch: int, h8: int, w8: int, hh: int, ww: int,
                labels: str = "iid", device="cuda"):
    """(xcat, label, conf, t1, t2) from ``rng``: xcat N(0, 2^2), the teacher labels
    ``conf`` thresholded from a random stride-8 teacher posterior (``teacher_conf``),
    T1/T2 row softmaxes; ``label`` as ``labels`` says (``iid``, ``regions`` or
    ``shifted``)."""
    from ..ops.fused_losses import teacher_conf

    tot = C + O
    xcat = torch.from_numpy((rng.standard_normal((batch, h8, w8, 2 * tot)) * 2)
                            .astype(np.float32)).to(device)
    tp = torch.softmax(torch.from_numpy((rng.standard_normal((batch, h8, w8, C)) * 3)
                                        .astype(np.float32)), -1).to(device)
    label = label_map(rng, labels, batch, hh, ww)
    conf = teacher_conf(tp, (hh, ww), num_classes=C, threshold_high=THRESHOLD_HIGH,
                        threshold_low=0.2)
    t1, t2 = (torch.softmax(torch.from_numpy(rng.standard_normal((tot, C))
                                             .astype(np.float32)), -1).to(device)
              for _ in range(2))
    return xcat, torch.from_numpy(label).to(device), conf, t1, t2


def label_map(rng: np.random.Generator, labels: str, batch: int, hh: int, ww: int, *,
              classes: int = C, ignore: float = 0.1, cell: int = CELL) -> np.ndarray:
    """(batch, hh, ww) int32 labels from ``rng``: ``iid`` draws each pixel's class in
    [0, classes) and sets a share ``ignore`` of the pixels to 255; ``regions`` draws one
    class a ``cell`` x ``cell`` cell on a grid from the origin and sets that share of the
    cells to 255; ``shifted`` moves that grid down and across by 1 to cell-1 pixels (drawn
    first)."""
    if labels == "iid":
        label = rng.integers(0, classes, (batch, hh, ww)).astype(np.int32)
        label[rng.random((batch, hh, ww)) < ignore] = 255
        return label
    if labels not in ("regions", "shifted"):
        raise ValueError(f"unknown label map {labels!r} (iid, regions or shifted)")
    dy, dx = rng.integers(1, cell, 2) if labels == "shifted" else (0, 0)
    ch, cw = -(-(hh + dy) // cell), -(-(ww + dx) // cell)
    cells = rng.integers(0, classes, (batch, ch, cw)).astype(np.int32)
    cells[rng.random((batch, ch, cw)) < ignore] = 255
    return np.repeat(np.repeat(cells, cell, 1), cell, 2)[:, dy:dy + hh, dx:dx + ww].copy()


def simt_step(root: str, seed: int = 0):
    """(step, state, batch) of the full-width SimT step of the package named ``root``
    (``tools/train_simt.py``'s preset simt_bapa_lr25, seeded random weights, a uniform
    class prior, one synthetic 512x1024 batch) on the card."""
    train_simt = importlib.import_module(root + ".tools.train_simt")
    train = importlib.import_module(root + ".train")
    args = train_simt.build_parser().parse_args(
        ["--synthetic", "--preset", "simt_bapa_lr25", "--num-steps-stop", "1"])
    cfg = train_simt.build_config(args)
    with tempfile.TemporaryDirectory(prefix="bench_loss_fused_") as tmp:
        cd = os.path.join(tmp, "cd_uniform.npy")
        np.save(cd, (np.ones(C) / C).astype(np.float32))
        cfg = cfg.replace(simt=dataclasses.replace(cfg.simt, class_dist=cd),
                          random_seed=seed)
        student, teacher = train_simt.build_models(cfg)
        state = train.create_simt_state(student, teacher, cfg,
                                        torch.Generator().manual_seed(seed + 2), "cuda")
    batch = train_simt.synthetic_batches(cfg, 1, torch.device("cuda"))[0]
    return train.make_simt_step(cfg), state, batch


@functools.lru_cache(maxsize=2)
def step_inputs(seed: int = 0):
    """(xcat, label, conf, t1, t2, g) of one full-width SimT step's loss core call on
    the card (made once a seed; callers do not write to them): ``simt_step`` of this
    package runs once with ``SimTLossCore``'s ``apply`` and ``backward`` wrapped to
    record their arguments."""
    from ..ops.kernels import loss_fused

    seen = {}
    core = loss_fused.SimTLossCore
    apply, backward = core.apply, core.backward

    def record_apply(xcat, t1, t2, label, conf, *rest):
        seen["fwd"] = (xcat, label, conf, t1, t2)
        return apply(xcat, t1, t2, label, conf, *rest)

    def record_backward(ctx, g, *rest):
        seen["g"] = g
        return backward(ctx, g, *rest)

    step, state, batch = simt_step(_ROOT, seed)
    with mock.patch.object(core, "apply", record_apply), \
            mock.patch.object(core, "backward", staticmethod(record_backward)):
        step(state, batch)
    torch.cuda.synchronize()
    del step, state
    torch.cuda.empty_cache()
    xcat, label, conf, t1, t2 = (v.detach().clone() for v in seen["fwd"])
    return xcat, label, conf, t1, t2, seen["g"].detach().float().clone()


def step_device_ms(pkg: SimpleNamespace, seed: int = 0, steps: int = 3) -> dict:
    """Device time of ``pkg``'s full-width SimT step (``simt_step``), profiler, mean
    over ``steps`` steps after 3 warm-up steps: ``device_ms`` every kernel's, ``launches``
    a step, and the loss core's kernels' ms (``loss_ms``, by name in ``loss_kernels``)."""
    step, state, batch = simt_step(pkg.kernels.__name__.split(".")[0], seed)
    by_name = profile_kernels(lambda: step(state, batch), steps)
    del step, state
    torch.cuda.empty_cache()
    ours = {short(n): ms / steps for n, (_, ms) in by_name.items() if KERNEL_WORD in n}
    return {"device_ms": sum(ms for _, ms in by_name.values()) / steps,
            "launches": sum(n for n, _ in by_name.values()) / steps,
            "loss_ms": sum(ours.values()), "loss_kernels": ours}


def make_maps(names: Sequence[str], seed: int = 0) -> dict:
    """{map: (xcat, label, conf, t1, t2, g)} on the card, each from ``seed``; ``g`` is
    the sums cotangent (the step's own for ``step``, else N(0, 1))."""
    maps = {}
    for name in names:
        if name == "step":
            maps[name] = step_inputs(seed)
            continue
        rng = np.random.default_rng(seed)
        inputs = loss_inputs(rng, 1, *LOGIT_HW, *OUT_HW, labels=name)
        g = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).cuda()
        maps[name] = (*inputs, g)
    return maps


def loss_calls(loss_fused, xcat, label, conf, t1, t2, g) -> dict:
    """{"fwd": B2's wrapper call, "bwd": B3's} on these inputs; ``loss_fused`` is the
    wrapper module of the package timed."""
    kw = dict(num_classes=C, threshold_high=THRESHOLD_HIGH)
    return {"fwd": lambda: loss_fused.loss_core_fwd(xcat, label, conf, t1, t2, **kw),
            "bwd": lambda: loss_fused.loss_core_bwd(g, xcat, label, conf, t1, t2, **kw)}


def time_loss(calls: dict, iters: int = 20) -> dict:
    """{op: times} of ``loss_calls``: ``timing.time_launches`` on the call's
    ``loss_`` kernels."""
    return time_launches(calls, KERNEL_WORD, iters)


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", action="store_true",
                   help="time B2/B3 alone, launch by launch (what this tool does)")
    p.add_argument("--package-root", default=_HERE,
                   help="another checkout's package to time in turns with this one")
    p.add_argument("--labels", default=",".join(LABEL_MAPS),
                   help="comma-separated label maps: iid, regions, shifted, step")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_loss_fused: needs a CUDA card")
    names = [n for n in args.labels.split(",") if n]
    for n in names:
        if n not in LABEL_MAPS:
            raise SystemExit(f"bench_loss_fused: unknown label map {n!r}")
    maps = make_maps(names, args.seed)
    own = package(_HERE)
    other = package(args.package_root)
    turns = [own] if other.root == own.root else [other, own, own, other]
    results = []
    for pkg in turns:
        res = {"package": pkg.root, "device": torch.cuda.get_device_name(0),
               "iters": args.iters, "times": {}}
        for name, inputs in maps.items():
            res["times"][name] = time_loss(loss_calls(pkg.loss_fused, *inputs), args.iters)
        results.append(res)
    # The steps after every kernel timing: a long profiled step made later short
    # profiler sessions drop kernel records.
    for pkg, res in zip(turns, results):
        res["simt_step"] = step_device_ms(pkg, args.seed)
        print(json.dumps(res))
    return results


if __name__ == "__main__":
    main()
