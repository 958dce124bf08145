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
``chip_smoke.py`` times B4/B5 with the same functions.

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
import time

import torch

# (name, H, W, channels, dilation) of the trunk's stages at a 512x1024 crop.
TRUNK = (("layer1", 129, 257, 64, 1), ("layer2", 65, 129, 128, 1),
         ("layer3", 65, 129, 256, 2), ("layer4", 65, 129, 512, 4))
TRUNK_640 = (("eval640_layer1", 161, 321, 64, 1), ("eval640_layer2", 81, 161, 128, 1),
             ("eval640_layer3", 81, 161, 256, 2), ("eval640_layer4", 81, 161, 512, 4))
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 11, 14)
KERNEL_WORD = "conv3x3_"  # every kernel of csrc/conv3x3.cu is named conv3x3_*
PROFILE_PAD_S = 0.05  # host wait at each end of a profiler session (profile_kernels)
# A profiled call's launches must sum to its device time by events (busy_ms) within
# PROFILE_TOL of it plus PROFILE_TOL_MS (the gaps between launches), or the reading is
# taken again, up to PROFILE_READINGS times (checked_launches).
PROFILE_TOL, PROFILE_TOL_MS, PROFILE_READINGS = 0.15, 0.01, 3
SPIN_CYCLES = 50_000_000  # ~25 ms at 1.98 GHz: longer than the host takes to issue a timing


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


def busy_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` by CUDA events, every device operation of a call
    included but not the host's pace: a spin kernel keeps the card busy while the host
    issues the ``iters`` calls, so they run back to back on the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def checked_launches(fn, iters: int) -> dict:
    """One call's launches in order, [(name, device ms)], from
    ``profile_kernels(ordered=True)``, held to ``busy_ms``: a reading whose launches do
    not sum to the events' time (PROFILE_TOL, PROFILE_TOL_MS) is taken again, up to
    PROFILE_READINGS readings (the profiler can drop a kernel's record or cut its time
    short). Returns ``seq`` (the first reading that agrees, else the one with the most
    launches), ``busy_ms``, ``readings`` taken and ``agrees``."""
    busy = busy_ms(fn, iters)
    best = None
    for reading in range(1, PROFILE_READINGS + 1):
        seq = profile_kernels(fn, iters, ordered=True)
        agrees = abs(sum(ms for _, ms in seq) - busy) <= PROFILE_TOL * busy + PROFILE_TOL_MS
        if best is None or len(seq) > len(best):
            best = seq
        if agrees:
            best = seq
            break
    return {"seq": best, "busy_ms": busy, "readings": reading, "agrees": agrees}


def profile_kernels(fn, iters: int, ordered: bool = False):
    """{kernel name: (launches, device ms)} of ``iters`` calls of ``fn`` under
    torch.profiler, after 3 warm-up calls. With ``ordered``, the list of one call's
    launches in launch order instead, [(name, device ms)], each the mean over the calls
    at that position: one profiler session a call, and only the calls with the most
    launches recorded count (the profiler can drop a kernel's record; a call with a gap
    would shift every later position). Each session waits PROFILE_PAD_S on the host
    before and after its calls: late in a long process, sessions that ended right after
    the synchronize lost the records of their last kernels, a whole short call's at
    times."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(calls: int) -> list:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        return sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation), key=lambda e: e.time_range.start)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if ordered:
        runs = [kernels(1) for _ in range(iters)]
        n = max(len(r) for r in runs)
        full = [r for r in runs if len(r) == n]
        return [(full[0][i].name,
                 sum(r[i].time_range.elapsed_us() for r in full) / len(full) / 1e3)
                for i in range(n)]
    out = {}
    for e in kernels(iters):
        n, ms = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def profile_steps(step, state, batches, n: int = 3, report: bool = True,
                  ours=("loss_fwd", "loss_bwd", "conv3x3"), print_fn=print) -> float:
    """Kernel time per step from torch.profiler over ``n`` more calls of
    ``step(state, batches[i % len(batches)])``; with ``report``, prints (through
    ``print_fn``) the kernels that take the most of it and those of this package (names
    containing ``ours``). ``chip_smoke.py`` and ``tools/bench.py`` time steps with it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)  # keeps the last kernels' records (profile_kernels)
    # Device-side events, without the annotation spans that enclose kernels.
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    total = sum(by_name.values())
    if not report:
        return total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print_fn(f"train step kernels (profiler, ms per step, {len(kernels) / n:.0f} launches "
             f"per step, total {total:.3f}): "
             + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    mine = {k: v for k, v in by_name.items() if any(o in k for o in ours)}
    print_fn("this package's kernels in the step (ms per step): "
             + "; ".join(f"{k[:60]} {v:.4f}" for k, v in mine.items())
             + f"; sum {sum(mine.values()):.3f}")
    return total


def kernel_ms(fn, iters: int, word: str | None = KERNEL_WORD) -> float:
    """Device ms per call of ``fn``'s kernels whose name holds ``word`` (all, for None).
    A reading with no such launch, or with a count that is no whole multiple of
    ``iters`` (the profiler dropped a record), is taken again, up to PROFILE_READINGS
    readings; raises if none has one."""
    for _ in range(PROFILE_READINGS):
        got = [(n, ms) for name, (n, ms) in profile_kernels(fn, iters).items()
               if word is None or word in name]
        launches = sum(n for n, _ in got)
        if launches and launches % iters == 0:
            break
    if not launches:
        raise RuntimeError(f"no {word or 'device'} kernel in {PROFILE_READINGS} profiler "
                           "readings")
    return sum(ms for _, ms in got) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` issued back to back (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def short(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def time_launches(calls: dict, word: str, iters: int = 20) -> dict:
    """{name: times} of each call in ``calls``: ``ms`` (CUDA events, the wrapper back to
    back), ``kernel_ms`` and ``launches`` (the call's kernels whose name holds ``word``),
    ``device_ops`` (every device operation of a call, fills and copies included),
    ``per_launch`` ([name, device ms] in launch order, the mean over ``iters`` calls) and
    ``host_us``. The launches are ``checked_launches``' (its ``busy_ms``, ``readings`` and
    ``agrees`` beside them): where no profiler reading agreed with the events and the call
    is its one kernel, ``kernel_ms`` is the events' device time (``kernel_ms_by``)."""
    out = {}
    for op, call in calls.items():
        got = checked_launches(call, iters)
        seq = got.pop("seq")
        ours = [ms for n, ms in seq if word in n]
        by_events = not got["agrees"] and len(ours) == len(seq) == 1
        out[op] = {"ms": cuda_ms(call, iters),
                   "kernel_ms": got["busy_ms"] if by_events else sum(ours),
                   "kernel_ms_by": "events" if by_events else "profiler",
                   "launches": len(ours), "device_ops": len(seq),
                   "per_launch": [[short(n), ms] for n, ms in seq],
                   "host_us": host_us(call, 100), **got}
    return out


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
        r = {"ms": cuda_ms(call, iters), "kernel_ms": kernel_ms(call, iters),
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
                res["fwd"][bn] = kernel_ms(calls["fwd"][0], iters)
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
                        calls["wgrad"][0], iters)
    finally:
        conv3x3.fwd_tiles, conv3x3.wgrad_tiles = chosen_f, chosen_w
    return res


if __name__ == "__main__":
    main()
