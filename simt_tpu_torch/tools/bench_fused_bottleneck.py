"""Isolated benchmark: the fused train-mode bottleneck (kernels B6/B7,
``ops/bottleneck.py``) against the port's composed ``Bottleneck`` module, at one trunk
geometry (counterpart of experiments/pallas_bottleneck/bench_fused_bottleneck.py).

  python -m simt_tpu_torch.tools.bench_fused_bottleneck            # card, layer3
  python -m simt_tpu_torch.tools.bench_fused_bottleneck --device cpu \\
      --geometry 9,13,8,32,2 --reps 1

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
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from ..models.layers import Bottleneck
from ..ops.bottleneck import block_args, fused_bottleneck


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="fused bottleneck (B6/B7) vs the composed "
                                            "block (PyTorch + CUDA)")
    p.add_argument("--geometry", default="65,129,256,1024,2",
                   help="h,w,planes,trunk,dilation")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_block(planes: int, trunk: int, d: int, seed: int,
               device: torch.device) -> Bottleneck:
    """The identity block in train mode, channels_last, seeded random conv weights."""
    if trunk != 4 * planes:
        raise ValueError(f"an identity bottleneck has trunk = 4 * planes, got {trunk} "
                         f"and {planes}")
    block = Bottleneck(trunk, planes, dilation=d)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.05)
    return block.to(device, memory_format=torch.channels_last).train()


def _elapsed_ms(fn, device: torch.device) -> float:
    """ms that ``fn()`` takes: CUDA events on a card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    h, w, planes, trunk, d = (int(v) for v in args.geometry.split(","))
    reps = args.reps
    bf16 = torch.bfloat16
    block = make_block(planes, trunk, d, args.seed, device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(1, trunk, h, w, generator=gen).to(bf16).to(device).contiguous(
        memory_format=torch.channels_last)
    fargs = block_args(block)
    weights = tuple(fargs[:3])  # the conv weights: parameters that need a gradient
    autocast = torch.autocast(device.type, dtype=bf16)
    gflop = 2 * h * w * (trunk * planes + 9 * planes * planes + planes * trunk) / 1e9
    print(f"device={device} geometry=({h},{w},{trunk}) planes={planes} d={d} reps={reps}")

    def fused_fwd(c):
        return fused_bottleneck(c, *fargs)[0]

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
        ms = _elapsed_ms(lambda: out.setdefault("c", chain(step, reps)), device) / reps
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
