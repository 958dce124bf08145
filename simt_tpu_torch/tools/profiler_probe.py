"""Does ``torch.profiler`` still record CUDA activity in this process after child
processes exit, or after a while?

  python -m simt_tpu_torch.tools.profiler_probe [--children 8] [--torch-children]
      [--sessions 40] [--wait 30]

Runs ``--sessions`` short profiler sessions, each around one small kernel, then starts
``--children`` spawned processes (each importing torch with ``--torch-children``; the
loader's workers do, since they re-import the parent's main script) and waits for them
to exit and ``--wait`` seconds more, then runs the sessions again, without and with the
primer that opens ``timing.py``'s sessions (``prime_session``). Prints one JSON
line: the sessions that recorded no CUDA event of the kernel, before and after, and the
card's name.
``chip_smoke.py`` and the bench tools read kernel times and device operations from such
sessions. Needs a card.
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


def empty_sessions(n: int, pad_s: float = 0.05, primer: bool = False) -> int:
    """How many of ``n`` profiler sessions around one small kernel record no CUDA event
    of it (``timing.profile_kernels``'s session: a host wait at each end; with
    ``primer``, its primer of spin kernels first, whose records do not count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .timing import kernel_events, prime_session

    x = torch.ones(1024, device="cuda")
    empty = 0
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if primer:
                prime_session()
            time.sleep(pad_s)
            x.mul(2)
            torch.cuda.synchronize()
            time.sleep(pad_s)
        empty += not kernel_events(prof)
    return empty


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--children", type=int, default=8)
    p.add_argument("--torch-children", action="store_true")
    p.add_argument("--sessions", type=int, default=40)
    p.add_argument("--wait", type=float, default=0.0,
                   help="seconds to wait after the children, before the second sessions")
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
    time.sleep(args.wait)
    after = empty_sessions(args.sessions)
    primed = empty_sessions(args.sessions, primer=True)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "children": args.children, "torch_children": args.torch_children,
           "wait_s": args.wait, "sessions": args.sessions, "empty_before": before,
           "empty_after": after, "empty_after_primed": primed}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
