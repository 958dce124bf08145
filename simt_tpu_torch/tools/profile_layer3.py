"""The layer3 bottleneck's cost, three ways (counterpart of the JAX package's
``tools/profile_layer3.py``).

    python -m simt_tpu_torch.tools.profile_layer3 [--reps 20] [--hw 65,129]
        [--dilation 2] [--planes 256]
    python -m simt_tpu_torch.tools.profile_layer3 --device cpu --hw 9,13 --planes 16 \
        --reps 2

layer3 runs 23 identity bottlenecks of 256 planes and 1024 trunk channels, dilation 2,
on the 65x129 map of a 512x1024 crop. Each variant, bf16 on the card, forward (batch
statistics) and forward + backward of sum(y^2) for the input and the conv weights, the
input gradient feeding the next rep; ``--reps`` reps chained in one call:

  module  the port's ``Bottleneck`` (``models/layers.py``) in train mode under bf16
          autocast, channels_last: conv1 and conv3 on cuDNN, conv2 through
          ``ops/conv.py::dilated_conv3x3`` (B4/B5) as on the model's path;
  gemm    the pure-GEMM floor, a measurement and no port of a kernel: conv1 and conv3
          as ``torch.matmul``, conv2 as nine tap matmuls on the padded map, ReLUs and
          the residual, no BatchNorm;
  fused   the fused bottleneck (``ops/bottleneck.py``, B6/B7) on the same weights.

For each: ms a rep by the wall (CUDA events around a call of the chain, after warm-up)
and by the device (the profiler's kernels; ``timing.time_rows``, the wall windows first),
and TFLOP/s from ``flops.count`` of the module variant's rep on a CPU twin (the same
work whichever variant runs it). On the CPU the device numbers and rates are not
measured. Prints a table, then one JSON line last.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import layers as layers_lib
from ..ops.bottleneck import block_args, fused_bottleneck
from . import flops
from .bench_fused_bottleneck import make_block
from .profile_model import table
from .profile_step import ints
from .timing import card, time_rows

def gemm_block(x: torch.Tensor, w1, w2, w3, d: int) -> torch.Tensor:
    """The pure-GEMM bottleneck on NHWC ``x`` (1, H, W, Ct): ``w1`` (Ct, P), ``w2``
    (3, 3, P, P), ``w3`` (P, Ct); float32 accumulation, bf16 between the convs."""
    _, h, w, ct = x.shape
    p = w1.shape[1]
    flat = x.reshape(h * w, ct)
    h1 = torch.relu(torch.matmul(flat, w1).float()).to(x.dtype).reshape(h, w, p)
    h1p = F.pad(h1, (0, 0, d, d, d, d))
    acc = torch.zeros(h * w, p, dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            tap = h1p[kh * d:kh * d + h, kw * d:kw * d + w].reshape(h * w, p)
            acc = acc + torch.matmul(tap, w2[kh, kw]).float()
    h2 = torch.relu(acc).to(x.dtype)
    out = torch.matmul(h2, w3).float() + flat.float()
    return torch.relu(out).to(x.dtype).reshape(1, h, w, ct)


def variants(dev: torch.device, h: int, w: int, planes: int, d: int,
             reps: int) -> dict:
    """{"<variant> fwd" / "<variant> fwd+bwd": a chain of ``reps`` reps} of the module,
    gemm and fused variants on ``dev`` (bf16 on the card, float32 on the CPU)."""
    trunk = 4 * planes
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    block = make_block(layers_lib, planes, trunk, d, 0, dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, trunk, h, w, generator=gen).to(dtype).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    fargs = block_args(block)
    weights = tuple(fargs[:3])
    gws = [(torch.randn(*s, generator=gen) * 0.01).to(dtype).to(dev).requires_grad_(True)
           for s in ((trunk, planes), (3, 3, planes, planes), (planes, trunk))]
    autocast = torch.autocast(dev.type, dtype=torch.bfloat16, enabled=dev.type == "cuda")

    def module(c):
        with autocast:
            return block(c).to(dtype)

    def fused(c):
        return fused_bottleneck(c, *fargs)[0].to(dtype)

    def gemm(c):  # NCHW channels_last in and out, as the other two
        y = gemm_block(c.permute(0, 2, 3, 1), *gws, d)
        return y.permute(0, 3, 1, 2)

    params = {"module": weights, "fused": weights, "gemm": tuple(gws)}

    def fwd_chain(one):
        def run():
            c = x
            with torch.no_grad():
                for _ in range(reps):
                    c = one(c)
            return c
        return run

    def fwdbwd_chain(one, ws, n=reps):
        def run():
            c = x
            for _ in range(n):
                leaf = c.detach().requires_grad_(True)
                # A view into the block, not the leaf: FlopCounterMode's module hooks
                # cannot see a leaf input under autograd.grad.
                y = one(leaf.view_as(leaf))
                grads = torch.autograd.grad((y.float() ** 2).sum(), (leaf, *ws))
                c = grads[0].to(dtype)
            return c
        return run

    rows = {}
    for name, one in (("module", module), ("gemm", gemm), ("fused", fused)):
        rows[f"{name} fwd"] = fwd_chain(one)
        rows[f"{name} fwd+bwd"] = fwdbwd_chain(one, params[name])
    return rows


def module_work(h: int, w: int, planes: int, d: int) -> dict:
    """``flops.count`` of one rep of the module variant, forward and forward+backward,
    on a CPU twin at this geometry: {"fwd": count, "fwd+bwd": count}."""
    cpu = variants(torch.device("cpu"), h, w, planes, d, reps=1)
    return {"fwd": flops.count(cpu["module fwd"]),
            "fwd+bwd": flops.count(cpu["module fwd+bwd"])}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the layer3 bottleneck: module, GEMM floor, "
                                            "fused")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--reps", type=int, default=20, help="bottlenecks chained in a call")
    p.add_argument("--n", type=int, default=3, help="timed calls of the chain a row")
    p.add_argument("--hw", default="65,129")
    p.add_argument("--dilation", type=int, default=2)
    p.add_argument("--planes", type=int, default=256)
    return p


def run(args, print_fn=print) -> dict:
    dev = resolve_device(args.device)
    (h, w), d, planes, reps = ints(args.hw), args.dilation, args.planes, args.reps
    rows = time_rows(variants(dev, h, w, planes, d, reps), args.n, dev, warm=1)
    work = module_work(h, w, planes, d)
    for name, r in rows.items():
        kind = name.split(" ")[1]
        r["wall_ms_per_rep"] = r["wall_ms"] / reps
        r["device_ms_per_rep"] = None if r["device_ms"] is None else r["device_ms"] / reps
        r["tflops"] = (None if r["device_ms"] is None
                       else work[kind]["flops"] / (r["device_ms_per_rep"] / 1e3) / 1e12)
    info = card(dev)
    table(f"layer3 bottleneck ({h},{w},{4 * planes}) planes={planes} dilation={d}, "
          f"{reps} reps a call, {args.n} calls a row, {info['card']} "
          f"({info['power_limit_w']} W); ms a call:", rows, print_fn)
    print_fn(f"  work of one rep (module variant, CPU twin): fwd "
             f"{work['fwd']['flops'] / 1e9:.3f} GFLOP, fwd+bwd "
             f"{work['fwd+bwd']['flops'] / 1e9:.3f} GFLOP")
    for name, r in rows.items():
        rate = "not measured" if r["tflops"] is None else f"{r['tflops']:.1f} TFLOP/s"
        dev_ms = ("not measured" if r["device_ms_per_rep"] is None
                  else f"{r['device_ms_per_rep']:.3f}")
        print_fn(f"  {name:16s} {r['wall_ms_per_rep']:8.3f} ms/rep wall, {dev_ms} ms/rep "
                 f"device, {rate}")
    return {"metric": f"layer3_bottleneck_{h}x{w}_p{planes}_d{d}", "reps": reps,
            "rows": rows, "gflop_per_rep": {k: v["flops"] / 1e9 for k, v in work.items()},
            **info}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
