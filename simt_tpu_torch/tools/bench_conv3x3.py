"""Times the trunk conv's kernels (B4 forward and dx, B5) on one CUDA card, beside cuDNN's
calls of the same functions (a yardstick the package never calls).

    python3 simt_tpu_torch/tools/bench_conv3x3.py [--iters N] [--package-root DIR]
    python3 simt_tpu_torch/tools/bench_conv3x3.py --sweep

At the four trunk geometries of a 512x1024 crop (batch 1, bf16, NHWC) it prints, as one
JSON line, what ``time_conv`` measures for each call: ``ms``, the wrapper's time back to
back (CUDA events: the weight permute and the host's pace included); ``kernel_ms``, the
device time of its kernels (torch.profiler; every launch whose name holds ``conv3x3_``,
so a second reduce launch counts too); the same two for cuDNN's call (``library_ms``,
``library_kernel_ms``); and the host cost of a call (``host_us``, ``library_host_us``).
``chip_smoke.py`` times B4/B5 with the same functions; the clocks are ``timing.py``'s.

``--package-root`` imports ``simt_tpu_torch`` from another checkout, for example the
parent commit unpacked under ``build/``. Times of one call on the card differ from
another's by up to 2x (a shared host, clocks), so two versions of the kernels are
compared by timing both in turns within one call (parent, change, change, parent); the
timing code is this file's either way. ``--sweep`` times the wgmma kernels at every tile
width B4 can take (at the 640x1280 eval scale's geometries too) and at every B5 tile and
a range of split counts, beside the ones ``fwd_tiles`` and ``wgrad_tiles`` choose.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

if __package__:
    from .timing import cuda_ms, host_us, kernel_ms
else:  # run as a script: sys.path[0] is this directory, whichever package is timed
    from timing import cuda_ms, host_us, kernel_ms

# (name, H, W, channels, dilation) of the trunk's stages at a 512x1024 crop.
TRUNK = (("layer1", 129, 257, 64, 1), ("layer2", 65, 129, 128, 1),
         ("layer3", 65, 129, 256, 2), ("layer4", 65, 129, 512, 4))
TRUNK_640 = (("eval640_layer1", 161, 321, 64, 1), ("eval640_layer2", 81, 161, 128, 1),
             ("eval640_layer3", 81, 161, 256, 2), ("eval640_layer4", 81, 161, 512, 4))
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 11, 14)
KERNEL_WORD = "conv3x3_"  # every kernel of csrc/conv3x3.cu is named conv3x3_*


def conv_calls(conv3x3, x, wt, g, d) -> dict:
    """{op: (the wrapper's call, cuDNN's call of the same function)} for B4's forward and
    input gradient and B5 on ``x``, ``wt``, ``g``; ``conv3x3`` is the wrapper module."""
    pad = [d, d]
    return {
        "fwd": (lambda: conv3x3.conv3x3_fwd(x, wt, d),
                lambda: torch.nn.functional.conv2d(x, wt, padding=pad, dilation=d)),
        "dx": (lambda: conv3x3.conv3x3_fwd(g, wt, d, flip=True),
               lambda: torch.ops.aten.convolution_backward(
                   g, x, wt, None, [1, 1], pad, [d, d], False, [0, 0], 1,
                   [True, False, False])),
        "wgrad": (lambda: conv3x3.conv3x3_wgrad(x, g, d),
                  lambda: torch.ops.aten.convolution_backward(
                      g, x, wt, None, [1, 1], pad, [d, d], False, [0, 0], 1,
                      [False, True, False])),
    }


def time_conv(calls: dict, iters: int = 20, host: bool = True) -> dict:
    """{op: times} of ``conv_calls``: the wrapper's and cuDNN's call by CUDA events
    (``ms``, ``library_ms``) and their kernels by the profiler (``kernel_ms``; every
    kernel of cuDNN's call for ``library_kernel_ms``); with ``host``, their host cost
    (``host_us``, ``library_host_us``)."""
    out = {}
    for op, (call, lib) in calls.items():
        r = {"ms": cuda_ms(call, iters), "kernel_ms": kernel_ms(call, iters, KERNEL_WORD),
             "library_ms": cuda_ms(lib, iters),
             "library_kernel_ms": kernel_ms(lib, iters, None)}
        if host:
            r.update(host_us=host_us(call), library_host_us=host_us(lib))
        out[op] = r
    return out


def inputs(h: int, w: int, c: int, gen: torch.Generator):
    """x (ReLU'd, as conv2's input is), the OIHW weight and the cotangent g: bf16 on the
    card, activations channels_last."""
    x = torch.relu(torch.randn(1, c, h, w, device="cuda", generator=gen))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = (torch.randn(c, c, 3, 3, device="cuda", generator=gen) * 0.01).to(torch.bfloat16)
    g = torch.randn(1, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    return x, wt, g.contiguous(memory_format=torch.channels_last)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="directory holding the simt_tpu_torch package to time")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sweep", action="store_true",
                   help="time every tile width and split instead (wgmma kernels only)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv3x3: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.package_root))
    from simt_tpu_torch.ops.kernels import conv3x3

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": os.path.abspath(conv3x3.__file__),
           "device": torch.cuda.get_device_name(0), "times": {}}
    for name, h, w, c, d in TRUNK + (TRUNK_640 if args.sweep else ()):
        calls = conv_calls(conv3x3, *inputs(h, w, c, gen), d)
        if args.sweep:
            out["times"][name] = sweep(conv3x3, calls, h * w, c, args.iters,
                                       wgrad=(name, h, w, c, d) in TRUNK)
        else:
            out["times"][name] = time_conv(calls, args.iters)
    print(json.dumps(out))
    return out


def sweep(conv3x3, calls, pixels: int, c: int, iters: int, wgrad: bool) -> dict:
    """Kernel ms of B4 forward at each tile width and of B5 at each tile and split
    count, the schedule functions swapped for fixed choices while each runs."""
    chosen_f, chosen_w = conv3x3.fwd_tiles, conv3x3.wgrad_tiles
    res = {"fwd_chosen": chosen_f(pixels, c).bn, "fwd": {}, "wgrad": {}}
    try:
        for bn in conv3x3.FWD_BN:
            if bn <= max(64, c):
                conv3x3.fwd_tiles = lambda p, n, bn=bn: conv3x3.FwdTiles(
                    bn, -(-p // conv3x3.FWD_BM), -(-n // bn))
                res["fwd"][bn] = kernel_ms(calls["fwd"][0], iters, KERNEL_WORD)
        if wgrad:
            t = chosen_w(pixels, c, c)
            res["wgrad_chosen"] = f"{t.bc}x{t.bo} s{t.splits}"
            chunks = -(-pixels // conv3x3.WGRAD_PIX)
            for bc, bo in conv3x3.WGRAD_TILES:
                if bc != t.bc:
                    continue
                for want in SWEEP_SPLITS:
                    per = -(-chunks // want)
                    fixed = conv3x3.WgradTiles(bc, bo, -(-chunks // per),
                                               per * conv3x3.WGRAD_PIX, -(-c // bc),
                                               -(-c // bo))
                    conv3x3.wgrad_tiles = lambda p, c_, o_, t=fixed: t
                    res["wgrad"][f"{bc}x{bo} s{fixed.splits}"] = kernel_ms(
                        calls["wgrad"][0], iters, KERNEL_WORD)
    finally:
        conv3x3.fwd_tiles, conv3x3.wgrad_tiles = chosen_f, chosen_w
    return res


if __name__ == "__main__":
    main()
