"""The port's timing helpers, shared by its benchmarks, its profiling tools and
``chip_smoke.py``: CUDA-event clocks (``cuda_ms``, ``busy_ms``), ``torch.profiler``
readings of device time by kernel (``profile_kernels``, ``kernel_ms``,
``checked_launches``, ``profile_steps``) behind a primer that takes CUPTI's loss of a
session's first records (``prime_session``), the host's cost a call (``host_us``), and
the train steps' wall clock (``timed_steps``).

Every profiler reading here is of the card; none runs on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

PROFILE_PAD_S = 0.05  # host wait at each end of a profiler session (profile_kernels)
PRIMER_LAUNCHES = 16  # spin kernels that open every profiler session (prime_session)
PRIMER_WORD = "spin_kernel"  # torch.cuda._sleep's kernel
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


def prime_session() -> None:
    """Open a profiler session with PRIMER_LAUNCHES spin kernels and a synchronize. On
    the H100 machines, from ~25 s into a process on, CUPTI dropped the first 3 kernel
    records of every session (``tools/profiler_probe.py``: a one-kernel
    session recorded nothing, 100 kernels 97); the primer's records take that loss, and
    every reading leaves them out (PRIMER_WORD)."""
    for _ in range(PRIMER_LAUNCHES):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def kernel_events(prof) -> list:
    """The session's CUDA kernel and memory operations, without the annotation spans
    that enclose them and the primer's spin kernels, in launch order."""
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and PRIMER_WORD not in e.name),
                  key=lambda e: e.time_range.start)


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
            prime_session()
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        return kernel_events(prof)

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
        prime_session()
        for i in range(n):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)  # keeps the last kernels' records (profile_kernels)
    kernels = kernel_events(prof)
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


def kernel_ms(fn, iters: int, word: Optional[str] = None) -> float:
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


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_steps(step, state, next_batch: Callable[[], Dict], warm: int, steps: int,
                dev: torch.device, key: Optional[str], out: Optional[list] = None) -> float:
    """``warm`` steps, then the wall ms per step over ``steps`` more; each run ends with
    the host reading the last step's metric ``key`` (none for None) and a synchronize on
    the card. With ``out``, each timed step's metrics are appended to it."""
    metrics = None
    for _ in range(warm):
        metrics = step(state, next_batch())
    if key is not None and metrics is not None:
        float(metrics[key])
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, next_batch())
        if out is not None:
            out.append(metrics)
    if key is not None:
        float(metrics[key])
    sync(dev)
    return (time.perf_counter() - t0) / steps * 1e3


def wall_ms(fn, calls: int, dev: torch.device, warm: int = 2) -> float:
    """Wall ms per call of ``fn`` over ``calls`` calls back to back after ``warm``: CUDA
    events, the last one waited for, on the card (the host's pace included); the host
    clock on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn, calls, warm)
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def device_reading(fn, calls: int) -> dict:
    """One profiler session over ``calls`` calls of ``fn`` (``profile_kernels``: 3
    warm-up calls, the primer's records left out): ``device_ms`` and ``launches`` a call,
    and ``by_name``, {kernel name: (launches, device ms)} over the session."""
    by_name = profile_kernels(fn, calls)
    return {"device_ms": sum(ms for _, ms in by_name.values()) / calls,
            "launches": sum(n for n, _ in by_name.values()) / calls, "by_name": by_name}


def time_rows(rows: Dict[str, Callable], calls: int, dev: torch.device, warm: int = 2,
              walls: Optional[Dict[str, float]] = None) -> Dict[str, dict]:
    """{row: {"wall_ms", "device_ms", "launches", "busy"}} for each callable of ``rows``:
    every row's wall window first (``wall_ms``; ``walls`` holds rows the caller timed
    already), then every row's profiled one (``device_reading``; a profiler session
    leaves later calls slower), ``busy`` the device ms over the wall ms. On the CPU the
    device numbers are None: not measured."""
    walls = walls or {}
    out = {name: {"wall_ms": walls.get(name) or wall_ms(fn, calls, dev, warm)}
           for name, fn in rows.items()}
    for name, fn in rows.items():
        r = out[name]
        if dev.type != "cuda":
            r.update(device_ms=None, launches=None, busy=None)
            continue
        d = device_reading(fn, calls)
        r.update(device_ms=d["device_ms"], launches=d["launches"],
                 busy=d["device_ms"] / r["wall_ms"])
    return out


def card(dev: torch.device) -> dict:
    """``card`` and ``power_limit_w`` of the card, as ``nvidia-smi --query-gpu=name,
    power.limit`` reads them (the limit sets how fast a card runs under load); "cpu" and
    None on the CPU."""
    if dev.type != "cuda":
        return {"card": "cpu", "power_limit_w": None}
    import subprocess

    got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    name, limit = got[dev.index or 0].rsplit(",", 1)
    return {"card": name.strip(), "power_limit_w": float(limit.strip().split()[0])}
