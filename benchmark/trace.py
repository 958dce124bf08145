"""A ``torch.profiler`` session over a few calls of the timed path, reduced to plain
records: the device operations (name, start, length), the host's operations, and the
session's window, all in one clock (microseconds).

The session is primed (``frozen.timing.prime_session``: CUPTI drops a session's first
records late in a process) and padded on the host at each end. The calls and the
closing synchronize run inside one ``record_function`` range.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

from .frozen.timing import PRIMER_WORD, kernel_events, prime_session

PAD_S = 0.05  # host wait at each end of the session
WINDOW = "benchmark_window"
ATTRIBUTED_GAPS = 200  # the longest idle gaps named by the host's operation


def session(call: Callable[[int], None], calls: int, host: bool = False) -> dict:
    """Profile ``call(i)`` for i < ``calls``; returns {"calls", "window_us", "ops":
    [(name, start_us, dur_us)] of the device in launch order, "host": [(name, start_us,
    dur_us)] of the host's operations}, times from the window's start. With ``host`` the
    host's operations are recorded and the window is the ``record_function`` range;
    without, none is, and the window runs from the first device operation of the calls
    to the end of the last. Recording the host's operations slows the host by tens of
    ms a train step, so the device's busy share is read from a session without them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        prime_session()
        time.sleep(PAD_S)
        with record_function(WINDOW):
            for i in range(calls):
                call(i)
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = prof.events()
    kernels = kernel_events(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device operation")
    if host:
        win = [e for e in events if e.name == WINDOW
               and e.device_type == torch.autograd.DeviceType.CPU]
        if not win:
            raise RuntimeError(f"the profiler recorded no {WINDOW!r} range")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    else:  # no host range recorded: the window spans the calls' device operations
        w0 = min(e.time_range.start for e in kernels)
        w1 = max(e.time_range.end for e in kernels)
    ops = [(e.name, e.time_range.start - w0, e.time_range.elapsed_us()) for e in kernels]
    host_ops = [(e.name, e.time_range.start - w0, e.time_range.elapsed_us())
                for e in events if host and e.device_type == torch.autograd.DeviceType.CPU
                and e.name != WINDOW and PRIMER_WORD not in e.name]
    return {"calls": calls, "window_us": w1 - w0, "ops": ops, "host": host_ops}


def busy_intervals(ops: List[Tuple[str, float, float]], window_us: float):
    """The union of the device operations' intervals inside [0, window_us], merged."""
    spans = sorted((max(0.0, s), min(window_us, s + d)) for _, s, d in ops)
    merged: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(rec: dict) -> float:
    return sum(b - a for a, b in busy_intervals(rec["ops"], rec["window_us"]))


def idle_gaps(rec: dict) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation, [(start_us, end_us)]."""
    gaps, t = [], 0.0
    for a, b in busy_intervals(rec["ops"], rec["window_us"]):
        if a > t:
            gaps.append((t, a))
        t = b
    if rec["window_us"] > t:
        gaps.append((t, rec["window_us"]))
    return gaps


def host_at(rec: dict, t_us: float) -> str:
    """The innermost host operation running at ``t_us``, or "host outside any op"."""
    best = None
    for name, s, d in rec["host"]:
        if s <= t_us <= s + d and (best is None or d < best[1]):
            best = (name, d)
    return best[0] if best else "host outside any op"


def breakdown(rec: dict, host_rec: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took the most time in
    ``rec``, and the idle time of ``host_rec`` (a session that recorded the host's
    operations, whose overhead lengthens the gaps) by what the host was doing when each
    gap began, in seconds."""
    by_op, by_host = {}, {}
    for name, _, d in rec["ops"]:
        by_op[name] = by_op.get(name, 0.0) + d / 1e6
    gaps = sorted(idle_gaps(host_rec), key=lambda g: g[0] - g[1])
    for a, b in gaps[:ATTRIBUTED_GAPS]:
        what = host_at(host_rec, a)
        by_host[what] = by_host.get(what, 0.0) + (b - a) / 1e6
    rest = gaps[ATTRIBUTED_GAPS:]
    if rest:
        what = f"gaps of at most {rest[0][1] - rest[0][0]:.1f} us, not attributed"
        by_host[what] = sum(b - a for a, b in rest) / 1e6

    def first(d):
        return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(by_host)}
