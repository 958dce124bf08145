"""Where the card's ms go: one ``torch.profiler`` session over a few calls of the SimT
step (or a part of it), its kernels grouped by family (counterpart of the JAX package's
``tools/profile_trace.py``, whose groups are XLA's ``hlo_category``).

    python -m simt_tpu_torch.tools.profile_trace [--what step|fwdbwd|fwd|teacher|trunk]
        [--top 40] [--reps 3] [--batch-size N]
    python -m simt_tpu_torch.tools.profile_trace --device cpu --layers 1,1,1,1 --hw 64,128

``--what`` (on the bench's SimT setup, ``profile_step.setup``; ``trunk`` on
``profile_trunk``'s): ``step`` the full train step, ``fwdbwd`` the student's forward
and backward of the dummy loss, ``fwd`` its forward, ``teacher`` the teacher's forward
and softmax, ``trunk`` ``Trunk34``'s forward and backward. One call first (cuDNN's
plans, the allocator), then ``timing.device_reading`` over ``--reps`` calls (3 more
warm-up calls, a primed session whose primer records do not count). Prints the device
total in ms a call and the launches a call; a table by family (``family``: ms a call,
launches a call, share of the total; the families partition the total); the ``--top``
kernels by ms a call; then one JSON line last. On the CPU nothing is traced: the device
numbers are null, not measured.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from . import profile_step, profile_trunk
from .bench import RESNET101, TRAIN_HW
from .profile_step import geometry_args, ints
from .timing import card, device_reading, short

WHATS = ("step", "fwdbwd", "fwd", "teacher", "trunk")

# (family, words): a kernel's family is the first whose words one of appears in its
# name, lower-cased; "other" if none does. The port's own kernels first, by name; then
# cuDNN's convolutions by direction before the GEMMs (its implicit GEMMs hold "gemm");
# BatchNorm before the reductions and element-wise kernels its names also match; the
# copies and fills before the element-wise kernels that implement them.
FAMILIES = (
    ("B1 eval_fused", ("eval_fused",)),
    ("B2 loss_fwd", ("loss_fwd",)),
    ("B3 loss_bwd", ("loss_bwd",)),
    ("B5 conv3x3 wgrad", ("conv3x3_wgrad",)),
    ("B4 conv3x3 fwd/dx", ("conv3x3_fwd",)),
    ("B6/B7 bneck", ("bneck_",)),
    ("conv dgrad (cuDNN)", ("dgrad",)),
    ("conv wgrad (cuDNN)", ("wgrad",)),
    ("conv fprop (cuDNN)", ("fprop", "convolve", "conv2d", "implicit_gemm", "cudnn",
                            "nchwtonhwc", "nhwctonchw")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("GEMM (cuBLAS/nvjet/cutlass)", ("gemm", "nvjet", "cutlass", "cublas", "gemv",
                                     "splitkreduce", "xmma")),
    ("optimizer", ("multi_tensor_apply", "fused_adam", "fused_sgd")),
    ("NCCL", ("nccl",)),
    ("copy / memset", ("memcpy", "memset", "copy_kernel", "direct_copy", "catarray",
                       "fillfunctor", "fill_kernel")),
    ("reduction", ("reduce", "softmax", "max_pool", "avg_pool", "scan", "argmax",
                   "cunn_", "norm_kernel")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index_put", "where")),
)
OTHER = "other"


def family(name: str) -> str:
    """The family of a kernel (or memory operation) by its name on the card."""
    low = name.lower()
    for fam, words in FAMILIES:
        if any(w in low for w in words):
            return fam
    return OTHER


def target(what: str, dev: torch.device, batch_size: int = 1,
           hw: Tuple[int, int] = TRAIN_HW,
           layers: Sequence[int] = RESNET101) -> Callable[[], object]:
    """The call ``--what`` names, built on ``dev``."""
    if what not in WHATS:
        raise ValueError(f"unknown target {what!r}; one of {WHATS}")
    if what == "trunk":
        return profile_trunk.setup(dev, hw, layers).rows["trunk34 fwd+bwd"]
    return profile_step.setup(dev, batch_size, hw, layers).rows[what]


def by_family(by_name: dict, calls: int) -> Tuple[dict, list]:
    """({family: {"ms", "launches", "share"}} a call, largest first; the kernels
    [name, family, ms a call, launches a call], largest first) of a session's
    {kernel name: (launches, device ms)} over ``calls`` calls."""
    total = sum(ms for _, ms in by_name.values())
    fams = {}
    for name, (n, ms) in by_name.items():
        f = fams.setdefault(family(name), {"ms": 0.0, "launches": 0.0})
        f["ms"] += ms / calls
        f["launches"] += n / calls
    for f in fams.values():
        f["share"] = f["ms"] * calls / total if total else 0.0
    fams = dict(sorted(fams.items(), key=lambda kv: -kv[1]["ms"]))
    kernels = sorted(([name, family(name), ms / calls, n / calls]
                      for name, (n, ms) in by_name.items()), key=lambda k: -k[2])
    return fams, kernels


def trace(fn: Callable[[], object], dev: torch.device, reps: int = 3, top: int = 40,
          print_fn=print) -> dict:
    """One call, then ``reps`` calls under the profiler (``device_reading``); prints and
    returns the device ms and launches a call, the families and the top kernels."""
    fn()
    out = {"reps": reps, "calls": 1, "device_ms": None, "launches": None,
           "families": {}, "top": [], "other": []}
    if dev.type != "cuda":
        print_fn("device ms: not measured (CPU run: nothing to trace)")
        return out
    got = device_reading(fn, reps)
    fams, kernels = by_family(got["by_name"], reps)
    out.update(calls=1 + 3 + reps, device_ms=got["device_ms"], launches=got["launches"],
               families=fams, top=[[short(k[0])[:120], *k[1:]] for k in kernels[:top]],
               other=[short(k[0])[:160] for k in kernels if k[1] == OTHER])
    print_fn(f"device total: {got['device_ms']:.3f} ms a call over {got['launches']:.0f} "
             f"launches a call ({reps} calls profiled)")
    print_fn("by family (ms a call, launches a call, share):")
    for fam, f in fams.items():
        print_fn(f"  {fam:32s} {f['ms']:9.3f} ms  {f['launches']:7.0f}  {f['share']:6.3f}")
    print_fn(f"top {top} kernels: {'ms/call':>8s} {'n/call':>7s}  family  name")
    for name, fam, ms, n in kernels[:top]:
        print_fn(f"  {ms:8.3f} {n:7.0f}  {fam}  {short(name)[:110]}")
    if out["other"]:
        print_fn("in other: " + "; ".join(out["other"]))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = geometry_args(argparse.ArgumentParser(description="the SimT step's device time "
                                                          "by kernel family"), n=None)
    p.add_argument("--what", default="fwdbwd", choices=WHATS)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=1)
    return p


def run(args, print_fn=print) -> dict:
    dev = resolve_device(args.device)
    hw, layers = ints(args.hw), ints(args.layers)
    info = card(dev)
    print_fn(f"profile_trace --what {args.what}, bs{args.batch_size} {hw[0]}x{hw[1]}, "
             f"layers {layers}, {info['card']} ({info['power_limit_w']} W)")
    fn = target(args.what, dev, args.batch_size, hw, layers)
    out = trace(fn, dev, args.reps, args.top, print_fn)
    return {"metric": f"profile_trace_{args.what}_bs{args.batch_size}_{hw[0]}x{hw[1]}",
            **out, **info}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
