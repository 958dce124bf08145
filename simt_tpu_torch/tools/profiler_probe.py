"""Does ``torch.profiler`` still record CUDA activity in this process after child
processes exit?

  python -m simt_tpu_torch.tools.profiler_probe [--children 8] [--torch-children]
      [--sessions 40]

Runs ``--sessions`` short profiler sessions, each around one small kernel, then starts
``--children`` spawned processes (each importing torch with ``--torch-children``; the
loader's workers do, since they re-import the parent's main script) and waits for them
to exit, then runs the sessions again. Prints one JSON line: the sessions that recorded
no CUDA event, before and after, and the card's name. ``chip_smoke.py`` and the bench
tools read kernel times and device operations from such sessions. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import time
from typing import Optional, Sequence


def _child(import_torch: bool) -> None:
    if import_torch:
        import torch  # noqa: F401

    time.sleep(2.0)


def empty_sessions(n: int, pad_s: float = 0.05) -> int:
    """How many of ``n`` profiler sessions around one small kernel record no CUDA event
    (``bench_conv3x3.profile_kernels``'s session: a host wait at each end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    empty = 0
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            x.mul(2)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        empty += not any(e.device_type == torch.autograd.DeviceType.CUDA
                         for e in prof.events())
    return empty


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--children", type=int, default=8)
    p.add_argument("--torch-children", action="store_true")
    p.add_argument("--sessions", type=int, default=40)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe: needs a CUDA card")
    before = empty_sessions(args.sessions)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(args.torch_children,))
             for _ in range(args.children)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(timeout=120)
    after = empty_sessions(args.sessions)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "children": args.children, "torch_children": args.torch_children,
           "sessions": args.sessions, "empty_before": before, "empty_after": after}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
