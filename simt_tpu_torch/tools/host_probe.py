"""How steady is the host that drives the SimT step, and what does one profiler session
leave behind in the process?

  python -m simt_tpu_torch.tools.host_probe [--rounds 8] [--device cuda|cpu]

The port's SimT step is bound by the host (its busy share is the profiler's device ms
over the wall ms), so its steps/s follow the speed of the host CPU. This builds the
bench's state and step (``bench.simt_setup``: ResNet-101, 19 + 15 classes, bf16 autocast
on the card) on the synthetic batch of seed 0 and, ``--rounds`` times, times a fixed
pure-Python loop (no torch call) and 20 steps (``timing.timed_steps``, 1 warm-up step);
then one profiler session (``bench.device_report``) and the same rounds again. A loop
whose time varies as the steps' rate does shows the host's own speed varying; rates
that drop after the session show what the session left behind.

Prints ONE JSON line on stdout: ``python_loop_s`` and ``steps_per_sec``, each
``{"before": [...], "after": [...]}`` by round, and ``device`` (the card's name, or
"cpu"). The function takes ``layers=``, ``hw=``, ``loop_n=`` and ``steps=`` so that a
test can run it small.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional, Sequence, Tuple

import torch

from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from . import bench
from .timing import timed_steps

LOOP_N = 3_000_000  # ~0.2-0.4 s of the host's Python a round
STEPS = 20  # the bench's timed steps


def python_loop(n: int = LOOP_N) -> float:
    """Seconds for a fixed pure-Python loop."""
    t0 = time.perf_counter()
    s = 0
    for i in range(n):
        s += i * i % 7
    return time.perf_counter() - t0


def run(args, *, layers: Sequence[int] = bench.RESNET101,
        hw: Tuple[int, int] = bench.TRAIN_HW, loop_n: int = LOOP_N,
        steps: int = STEPS) -> dict:
    """The rounds of ``args`` at ``layers`` and ``hw`` (ResNet-101 at 512x1024 by
    default); returns the JSON line's object."""
    dev = resolve_device(args.device)
    _, state, step = bench.simt_setup(dev, layers=layers)
    raw = synthetic_batch(batch_size=1, hw=hw, num_classes=19, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    loops = {"before": [], "after": []}
    rates = {"before": [], "after": []}
    for when in ("before", "after"):
        if when == "after":
            bench.device_report(step, state, [batch], 1e3 / rates["before"][-1], dev)
        for _ in range(args.rounds):
            loops[when].append(round(python_loop(loop_n), 4))
            ms = timed_steps(step, state, lambda: batch, 1, steps, dev, "loss")
            rates[when].append(round(1e3 / ms, 3))
            bench.log(f"{when}: python loop {loops[when][-1]} s, {rates[when][-1]} steps/s")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"python_loop_s": loops, "steps_per_sec": rates, "device": name}


def main(argv: Optional[Sequence[str]] = None, **kw) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args, **kw)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
