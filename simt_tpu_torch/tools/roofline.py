"""Whole-step roofline of the SimT train step on one card (counterpart of the JAX
package's ``tools/roofline.py``): is the whole step at the speed of light?

    python -m simt_tpu_torch.tools.roofline [--batch-size N] [--n 30]
    python -m simt_tpu_torch.tools.roofline --device cpu --layers 1,1,1,1 --hw 64,128 --n 2

The step's work is ``flops.step_work("step")``: FLOPs and computed bytes counted on a
float32 CPU twin at the same geometry, its ops dispatched on fake tensors (the plain
versions' aten ops; the card's kernels are invisible to a counter), the same whatever
implements the step. The bytes are the sum of every aten op's operand and result
bytes, an upper bound on an unfused program's traffic, not a reading of HBM traffic (as
XLA's "bytes accessed" is for the JAX tool).

The time comes from the bench's SimT setup (``tools/bench.py::simt_setup``, one resident
synthetic batch of ``--batch-size``): after 3 warm-up steps, ``--n`` steps back to back
between CUDA events, the last one waited for (``ms_per_step``); then, after the wall
window (a profiler session leaves later steps slower), ``--n`` more steps under the
profiler (``device_ms_per_step``, the kernels' time). From these, against the card's
dense peaks (``device.py``: bf16 989 TFLOP/s, 3.35 TB/s): ``achieved_tflops``, ``mfu``
(FLOPs over wall time over the bf16 peak), ``mfu_device`` (the same over device time),
``busy`` (device over wall), ``achieved_gbs`` and ``hbm_frac`` (the computed bytes over
wall time over the memory rate: it may exceed 1, the bytes being an upper bound), the
floors (``floor_ms_compute``: FLOPs at the bf16 peak; ``floor_ms_bytes``: the computed
bytes at the memory rate, no floor of the real traffic for the same reason) and
``headroom_x`` (wall over the larger floor, as the JAX tool's). An ``mfu``,
``mfu_device`` or ``busy`` above ``MAX_SHARE`` is a fault in the count or the clock, and
the tool raises.

Prints one human block and one JSON line (last; metric
``simt_step_roofline_bs{N}_{H}x{W}``), with the card's name and power limit, the peak
device memory over the wall window and the process's host RAM peak (the count's twin
included). On the CPU the wall time is the host clock and every rate, share and device
number is null: not measured.
"""

from __future__ import annotations

import argparse
import json
import resource
from typing import Optional, Sequence

import torch

from ..device import PEAK_BF16_FLOP_S, PEAK_BYTES_S, resolve_device
from . import flops
from .profile_step import geometry_args, ints, setup
from .timing import card, device_reading, wall_ms

WARM = 3  # warm-up steps before the wall window
MAX_SHARE = 1.05  # above this a share is a fault in the count or the clock


def roofline(flop: float, nbytes: float, ms: float,
             device_ms: Optional[float] = None) -> dict:
    """The roofline of one step of ``flop`` FLOPs and ``nbytes`` computed bytes that
    took ``ms`` of wall time and ``device_ms`` of device time (None: not measured), at
    the card's peaks. Raises ValueError if ``mfu``, ``mfu_device`` or ``busy`` exceeds
    MAX_SHARE."""
    s = ms / 1e3
    floor_c = flop / PEAK_BF16_FLOP_S * 1e3
    floor_b = nbytes / PEAK_BYTES_S * 1e3
    out = {"ms_per_step": ms, "device_ms_per_step": device_ms,
           "steps_per_sec": 1.0 / s, "busy": None if device_ms is None else device_ms / ms,
           "tflop_per_step": flop / 1e12, "gb_per_step_computed": nbytes / 1e9,
           "achieved_tflops": flop / s / 1e12, "mfu": flop / s / PEAK_BF16_FLOP_S,
           "mfu_device": (None if device_ms is None
                          else flop / (device_ms / 1e3) / PEAK_BF16_FLOP_S),
           "achieved_gbs": nbytes / s / 1e9, "hbm_frac": nbytes / s / PEAK_BYTES_S,
           "floor_ms_compute": floor_c, "floor_ms_bytes": floor_b,
           "headroom_x": ms / max(floor_c, floor_b)}
    for key in ("mfu", "mfu_device", "busy"):
        if out[key] is not None and out[key] > MAX_SHARE:
            raise ValueError(f"roofline: {key} {out[key]:.3f} above {MAX_SHARE}: the count "
                             f"or the clock is wrong ({out})")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = geometry_args(argparse.ArgumentParser(description="SimT step roofline"), n=30)
    p.add_argument("--batch-size", type=int, default=1)
    return p


def run(args, print_fn=print) -> dict:
    dev = resolve_device(args.device)
    hw, layers, bs, n = ints(args.hw), ints(args.layers), args.batch_size, args.n
    on_card = dev.type == "cuda"
    step = setup(dev, bs, hw, layers).rows["step"]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ms = wall_ms(step, n, dev, warm=WARM)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    device_ms = device_reading(step, n)["device_ms"] if on_card else None
    work = flops.step_work("step", layers=layers, hw=hw, batch_size=bs)
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    info = card(dev)
    r = roofline(work["flops"], work["bytes"], ms, device_ms)
    if not on_card:  # a CPU's clock: no rate or share of the card
        r.update({k: None for k in ("steps_per_sec", "achieved_tflops", "mfu",
                                    "achieved_gbs", "hbm_frac", "headroom_x")})

    def f(v, spec=".3f"):
        return "not measured" if v is None else format(v, spec)

    print_fn(f"step: bs{bs} {hw[0]}x{hw[1]}, layers {layers}, {info['card']} "
             f"({info['power_limit_w']} W): {ms:.3f} ms/step wall ({f(r['steps_per_sec'])} "
             f"steps/s), {f(device_ms)} device ms/step, busy {f(r['busy'])}, peak device "
             f"memory {f(peak_gib)} GiB")
    print_fn(f"work (float32 CPU twin on fake tensors, FlopCounterMode; host RAM peak "
             f"{rss_gib:.2f} GiB): {r['tflop_per_step']:.4f} TFLOP, "
             f"{r['gb_per_step_computed']:.3f} GB computed (operand + result bytes of "
             f"every aten op: an upper bound, not HBM traffic), "
             f"{work['flops'] / max(work['bytes'], 1):.1f} FLOP/B; by op: "
             + ", ".join(f"{op} {v['flops'] / 1e12:.4f}"
                         for op, v in work["by_op"].items()))
    print_fn(f"achieved: {f(r['achieved_tflops'], '.2f')} TFLOP/s, mfu "
             f"{f(r['mfu'], '.4f')} of the bf16 peak ({PEAK_BF16_FLOP_S / 1e12:.0f}), "
             f"mfu_device {f(r['mfu_device'], '.4f')}; {f(r['achieved_gbs'], '.1f')} GB/s "
             f"computed, {f(r['hbm_frac'], '.4f')} of {PEAK_BYTES_S / 1e9:.0f}")
    print_fn(f"floors: compute {r['floor_ms_compute']:.3f} ms, bytes "
             f"{r['floor_ms_bytes']:.3f} ms -> headroom {f(r['headroom_x'], '.1f')} x")
    return {"metric": f"simt_step_roofline_bs{bs}_{hw[0]}x{hw[1]}", **r,
            "peak_memory_gib": peak_gib, "host_ram_peak_gib": rss_gib, **info}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
