"""Isolated benchmark: the fused train-mode bottleneck (kernels B6/B7,
``ops/bottleneck.py``) against the port's composed ``Bottleneck`` module, at one trunk
geometry (counterpart of experiments/pallas_bottleneck/bench_fused_bottleneck.py); and,
with ``--kernels``, B6/B7 alone at the four trunk geometries, launch by launch.

  python -m simt_tpu_torch.tools.bench_fused_bottleneck            # card, layer3
  python -m simt_tpu_torch.tools.bench_fused_bottleneck --device cpu \\
      --geometry 9,13,8,32,2 --reps 1
  python -m simt_tpu_torch.tools.bench_fused_bottleneck --kernels [--package-root DIR]

``--geometry h,w,planes,trunk,dilation`` defaults to layer3 of a 512x1024 crop
(65x129, 256 planes, 1024 trunk channels, dilation 2). Weights are random from
``--seed`` (conv weights N(0, 0.05^2), BN scale 1, bias 0, as the JAX script). Four
chains of ``--reps`` calls, each after one warm-up call, as the JAX script's scans:

  - the composed module in train mode under bf16 autocast, ``channels_last`` (conv1
    and conv3 on cuDNN, conv2 on the port's dilated conv, B4/B5 on a card), forward;
  - the same, forward + backward of sum(out^2) for the input and the three conv
    weights, the input gradient feeding the next call;
  - ``fused_bottleneck`` forward, and forward + backward as above.

Prints ms per call and TFLOP/s (from CUDA events on a card; from the host clock on the
CPU, which says nothing of a card). The module's and the fused op's outputs from the
same input are compared (``agree_rel``: max |fused - module| over max |module|).
``main(argv)`` returns the numbers. Launches of one ``main``: B6 2*reps + 2, B7
reps + 1; through the module B4 3*reps + 3 (forwards and input gradients) and B5
reps + 1.

``--kernels`` (a card only) times ``bottleneck_fwd`` and ``bottleneck_bwd`` at the four
trunk identity-block geometries of a 512x1024 crop (``BNECK``), ``--iters`` calls each,
with ``tools/bench_conv3x3.py``'s clocks (``time_bneck``): ``ms``, the wrapper back to
back by CUDA events (weight packing and the host's pace included); ``kernel_ms``, the
device time of the call's ``bneck_`` kernels (profiler); the launches a call, and every
launch's device ms in launch order (``per_launch``). It prints one JSON line.
``chip_smoke.py`` times B6/B7 with the same function. ``--package-root DIR`` takes the
package from another checkout (for example the parent commit unpacked under
``build/``), imported under another name beside this one; the timing code is this
file's either way, so two versions are compared in turns within one call (parent,
change, change, parent).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from .bench_conv3x3 import cuda_ms, profile_kernels

# (name, H, W, trunk channels Ct, planes P, dilation) of the trunk's identity blocks at
# a 512x1024 crop.
BNECK = (("layer1", 129, 257, 256, 64, 1), ("layer2", 65, 129, 512, 128, 1),
         ("layer3", 65, 129, 1024, 256, 2), ("layer4", 65, 129, 2048, 512, 4))
KERNEL_WORD = "bneck_"  # every kernel of csrc/bottleneck.cu is named bneck_*
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fused bottleneck (B6/B7) vs the composed "
                                            "block (PyTorch + CUDA)")
    p.add_argument("--geometry", default="65,129,256,1024,2",
                   help="h,w,planes,trunk,dilation")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kernels", action="store_true",
                   help="time B6/B7 alone, launch by launch, at the four trunk geometries")
    p.add_argument("--iters", type=int, default=20, help="calls a timing (--kernels)")
    p.add_argument("--package-root", default=_HERE,
                   help="directory holding the simt_tpu_torch package to time")
    return p


def package(root: str) -> SimpleNamespace:
    """The modules of the ``simt_tpu_torch`` under ``root`` that this tool calls: this
    process's own package, or another checkout's imported under another name (its
    imports are relative, so it never mixes with this one; its kernels build into its
    own ``build/kernels``)."""
    root = os.path.abspath(root)
    if root == _HERE:
        name = __package__.split(".")[0]  # this module's own package, run with -m too
    else:
        name = "simt_tpu_torch_at_" + str(abs(hash(root)))
        if name not in sys.modules:
            init = os.path.join(root, "simt_tpu_torch", "__init__.py")
            spec = importlib.util.spec_from_file_location(
                name, init, submodule_search_locations=[os.path.dirname(init)])
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
    return SimpleNamespace(
        root=root, kernels=importlib.import_module(name + ".ops.kernels.bottleneck"),
        op=importlib.import_module(name + ".ops.bottleneck"),
        layers=importlib.import_module(name + ".models.layers"))


def make_block(layers, planes: int, trunk: int, d: int, seed: int, device: torch.device):
    """The identity block of ``layers`` (a package's ``models.layers``) in train mode,
    channels_last, seeded random conv weights."""
    if trunk != 4 * planes:
        raise ValueError(f"an identity bottleneck has trunk = 4 * planes, got {trunk} "
                         f"and {planes}")
    block = layers.Bottleneck(trunk, planes, dilation=d)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.05)
    return block.to(device, memory_format=torch.channels_last).train()


def bneck_inputs(h: int, w: int, ct: int, p: int, gen: torch.Generator,
                 device="cuda"):
    """x (1, Ct, H, W) bf16 channels_last, OIHW float32 weights N(0, 0.05^2) (the JAX
    benchmark's scale), BN scale 1 + N(0, 0.1^2) and bias N(0, 0.1^2)."""
    x = torch.randn(1, ct, h, w, device=device, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ws = [torch.randn(*shape, device=device, generator=gen) * 0.05
          for shape in ((p, ct, 1, 1), (p, p, 3, 3), (ct, p, 1, 1))]
    vecs = []
    for i, n in enumerate((p, p, p, p, ct, ct)):
        r = torch.randn(n, device=device, generator=gen) * 0.1
        vecs.append(1.0 + r if i % 2 == 0 else r)
    return x, ws, vecs


def bneck_calls(kernels, x, ws, vecs, d: int) -> dict:
    """{"fwd": B6's call, "bwd": B7's call} on these inputs, B7 on B6's saved tensors
    and the cotangent 2*out of sum(out^2); ``kernels`` is the wrapper module."""
    out, h1raw, h2raw, sp, st = kernels.bottleneck_fwd(x, *ws, *vecs, d)
    dy = (2.0 * out.float()).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return {"fwd": lambda: kernels.bottleneck_fwd(x, *ws, *vecs, d),
            "bwd": lambda: kernels.bottleneck_bwd(dy, x, *ws, *vecs, h1raw, h2raw, sp, st,
                                                  d)}


def time_bneck(calls: dict, iters: int = 20) -> dict:
    """{op: times} of ``bneck_calls``: ``ms`` (CUDA events, the wrapper back to back),
    ``kernel_ms`` (profiler, the call's ``bneck_`` kernels), ``launches`` of those a
    call, and ``per_launch``: [kernel name, device ms] of every launch of one call in
    launch order (the mean over ``iters`` calls)."""
    out = {}
    for op, call in calls.items():
        seq = profile_kernels(call, iters, ordered=True)
        ours = [ms for n, ms in seq if KERNEL_WORD in n]
        out[op] = {"ms": cuda_ms(call, iters), "kernel_ms": sum(ours),
                   "launches": len(ours), "per_launch": [[n, ms] for n, ms in seq]}
    return out


def kernel_times(pkg: SimpleNamespace, iters: int, seed: int) -> dict:
    """``time_bneck`` at every BNECK geometry, with the variant each call took where
    the package's wrappers count variants."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = {}
    for name, h, w, ct, p, d in BNECK:
        calls = bneck_calls(pkg.kernels, *bneck_inputs(h, w, ct, p, gen), d)
        res[name] = time_bneck(calls, iters)
        for op in ("fwd", "bwd"):
            fn = getattr(pkg.kernels, "bottleneck_" + op)
            if hasattr(fn, "variants"):
                res[name][op]["variants"] = dict(fn.variants)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pkg = package(args.package_root)
    if args.kernels:
        if device.type != "cuda":
            raise SystemExit("bench_fused_bottleneck --kernels: needs a CUDA card")
        out = {"package": pkg.root, "device": torch.cuda.get_device_name(0),
               "iters": args.iters, "times": kernel_times(pkg, args.iters, args.seed)}
        print(json.dumps(out))
        return out
    h, w, planes, trunk, d = (int(v) for v in args.geometry.split(","))
    reps = args.reps
    bf16 = torch.bfloat16
    block = make_block(pkg.layers, planes, trunk, d, args.seed, device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(1, trunk, h, w, generator=gen).to(bf16).to(device).contiguous(
        memory_format=torch.channels_last)
    fargs = pkg.op.block_args(block)
    weights = tuple(fargs[:3])  # the conv weights: parameters that need a gradient
    autocast = torch.autocast(device.type, dtype=bf16)
    gflop = 2 * h * w * (trunk * planes + 9 * planes * planes + planes * trunk) / 1e9
    print(f"device={device} geometry=({h},{w},{trunk}) planes={planes} d={d} reps={reps}")

    def fused_fwd(c):
        return pkg.op.fused_bottleneck(c, *fargs)[0]

    def module_fwd(c):
        with autocast:
            return block(c).to(bf16)

    def fwd_chain(step, n):
        c = x
        with torch.no_grad():
            for _ in range(n):
                c = step(c)
        return c

    def fwdbwd_chain(step, n):
        c = x
        for _ in range(n):
            c = c.detach().requires_grad_(True)
            y = step(c)
            grads = torch.autograd.grad((y.float() ** 2).sum(), (c, *weights))
            c = grads[0].to(bf16)
        return c

    def elapsed_ms(fn) -> float:
        """ms that ``fn()`` takes: CUDA events on a card, the host clock on the CPU."""
        if device.type == "cuda":
            return cuda_ms(fn, iters=1, warmup=0)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    results = {"device": str(device), "geometry": (h, w, planes, trunk, d), "reps": reps,
               "gflop": gflop}
    first = {}
    chains = (("module_fwd", module_fwd, fwd_chain, 1),
              ("module_fwdbwd", module_fwd, fwdbwd_chain, 3),
              ("fused_fwd", fused_fwd, fwd_chain, 1),
              ("fused_fwdbwd", fused_fwd, fwdbwd_chain, 3))
    for name, step, chain, passes in chains:
        first[name] = chain(step, 1)  # warm-up: cuDNN plans, the kernels' first load
        out = {}
        ms = elapsed_ms(lambda: out.setdefault("c", chain(step, reps))) / reps
        results[f"{name}_ms"] = ms
        results[f"{name}_finite"] = bool(torch.isfinite(out["c"].float()).all())
        tfs = passes * gflop / ms if ms > 0 else 0.0
        print(f"  {name:24s} {ms:9.4f} ms per call   {tfs:7.2f} TFLOP/s")
    a, b = first["fused_fwd"].float(), first["module_fwd"].float()
    results["agree_rel"] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    results["finite"] = results["fused_fwd_finite"] and results["fused_fwdbwd_finite"]
    print(f"fused vs module output (one call, same input): max abs diff "
          f"{results['agree_rel']:.3e} of the module's max; fused outputs finite: "
          f"{results['finite']}")
    return results


if __name__ == "__main__":
    main()
