"""Soak run of the port (counterpart of the JAX package's ``tools/soak.py``): the SimT
train step for hundreds of steps on one resident batch.

The bench's 20 timed steps cannot catch a kernel built late, a growing device pool or
a host-side drift. This drives the bench's state and step (``bench.simt_setup``: 19 + 15
classes, seeded ResNet-101 student and teacher, bf16 autocast on the card) on the
synthetic batch of seed 0 for ``--steps`` steps (default 600) after 3 warm-up steps,
reads every metric back on the host at the end of each window of ``--window`` steps
(default 100; a synchronize too) and checks that

  - every windowed metric is finite;
  - no kernel is built after the warm-up (``ops/kernels/_build.py::compiles``, where
    JAX counts its jit cache misses);
  - ``torch.cuda.memory_reserved`` does not grow after the warm-up (the largest growth
    read at a window's end, in bytes; 0 passes);
  - the slowest window holds the floor: ``--min-rate`` steps/s, or by default 0.9 x
    the steps/s that ``timing.timed_steps`` reads on the same state just before the
    soak (3 warm-up and 20 timed steps). No TPU number serves as the floor.

Run it in a process where no profiler session has run yet: after one, CUPTI stays
attached and every step is slower and its rate noisier (``tools/host_probe.py``).

On the CPU no floor is read and no device memory is reserved: ``floor`` (unless
``--min-rate`` is given) and ``reserved_growth_bytes`` are null, and those checks pass.

Prints ONE JSON line on stdout:
  {"metric": "simt_soak_steps_per_sec_min_window", "value": ..., "unit": "steps/s",
   "windows": [...], "steps": N, "finite": true, "kernel_builds_after_warmup": 0,
   "reserved_growth_bytes": 0, "floor": ..., "pass": true}
and, on stderr, the profiler's device ms a step from one session after the soak
(``bench.device_report``). Exits 1 when the run does not pass.

    python -m simt_tpu_torch.tools.soak [--steps 600] [--window 100] [--min-rate R]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from typing import Optional, Sequence, Tuple

import torch

from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..ops.kernels import _build
from . import bench
from .timing import sync, timed_steps

WARM = 3  # warm-up steps before the soak (the JAX tool's)
BENCH_WARM, BENCH_STEPS = 3, 20  # the bench's resident measure, read for the floor
FLOOR_SHARE = 0.9


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SimT soak run (PyTorch + CUDA)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--window", type=int, default=100)
    p.add_argument("--min-rate", type=float, default=None,
                   help="absolute floor in steps/s (default: 0.9 x the bench's steps/s "
                        "read on the same state just before the soak)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def run(args, *, layers: Sequence[int] = bench.RESNET101,
        hw: Tuple[int, int] = bench.TRAIN_HW) -> dict:
    """The soak of ``args`` at ``layers`` and ``hw`` (ResNet-101 at 512x1024 by
    default); returns the JSON line's object."""
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    _, state, step = bench.simt_setup(dev, layers=layers)
    raw = synthetic_batch(batch_size=1, hw=hw, num_classes=19, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}

    floor = args.min_rate
    if floor is None and cuda:
        wall_ms = timed_steps(step, state, lambda: batch, BENCH_WARM, BENCH_STEPS,
                              dev, "loss")
        floor = FLOOR_SHARE * 1e3 / wall_ms
        bench.log(f"soak floor: {FLOOR_SHARE} x the bench's {1e3 / wall_ms:.3f} steps/s "
                  f"({BENCH_WARM} warm-up + {BENCH_STEPS} timed steps) = {floor:.3f}")

    for _ in range(WARM):
        metrics = step(state, batch)
    float(metrics["loss"])
    sync(dev)
    builds = _build.compiles
    reserved = torch.cuda.memory_reserved(dev) if cuda else None
    growth = 0 if cuda else None

    windows = []
    finite = True
    n_done = 0
    seconds = 0.0
    while n_done < args.steps:
        n = min(args.window, args.steps - n_done)
        t0 = time.perf_counter()
        for _ in range(n):
            metrics = step(state, batch)
        vals = {k: float(v) for k, v in metrics.items()}  # the readback syncs
        sync(dev)
        dt = time.perf_counter() - t0
        seconds += dt
        windows.append(round(n / dt, 2))
        finite = finite and all(math.isfinite(v) for v in vals.values())
        if cuda:
            growth = max(growth, torch.cuda.memory_reserved(dev) - reserved)
        n_done += n
    builds = _build.compiles - builds

    bench.device_report(step, state, [batch], seconds / args.steps * 1e3, dev)
    value = min(windows)
    ok = (finite and builds == 0 and not growth
          and (floor is None or value >= floor))
    return {
        "metric": "simt_soak_steps_per_sec_min_window",
        "value": value,
        "unit": "steps/s",
        "windows": windows,
        "steps": args.steps,
        "finite": finite,
        "kernel_builds_after_warmup": builds,
        "reserved_growth_bytes": growth,
        "floor": floor,
        "pass": bool(ok),
    }


def main(argv: Optional[Sequence[str]] = None, **kw) -> dict:
    """Runs the soak (``kw``: ``layers``, ``hw``); its JSON line is the only line on
    stdout. Exits 1 when the run does not pass."""
    args = build_parser().parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args, **kw)
    print(json.dumps(out), flush=True)
    if not out["pass"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
