"""The program's own ranges in the host-traced profiler session: the port's
``record_function`` ranges ``simt_tpu_torch.<name>`` around its step parts and kernel
wrappers, which the session records among the host's operations (``trace.session``,
``host=True``) on the clock of the device's operations.

Every idle gap of that session (all of them, not only the longest) goes to the step
part whose range holds the gap's start (from the range's start up to its end): the
rule of ``trace.breakdown``, among the program's parts alone (the innermost, if two
hold it), or to ``OUTSIDE``. A program that records no such range (a checkout before
the ranges) gives None, never 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .readers import kind
from .trace import busy_intervals, idle_gaps

PREFIX = "simt_tpu_torch."
# The step parts of each window's kind, as the program names its ranges.
PARTS = {"train": ("inner_w", "teacher", "student_forward", "forward", "backward",
                   "grad_sync", "optimizer"),
         "eval": ("eval_forward", "eval_head")}
OUTSIDE = "outside"


def host_session(rec: dict, want: str) -> Optional[dict]:
    """The host-traced session of a traced run whose window is of kind ``want``."""
    if kind(rec) != want:
        return None
    return rec.get("host_session")


def ranges(s: dict, names: Iterable[str]) -> List[Tuple[str, float, float]]:
    """[(name without the prefix, start_us, end_us)] of the session's program ranges
    named in ``names``."""
    names = set(names)
    return [(n[len(PREFIX):], a, a + d) for n, a, d in s["host"]
            if n.startswith(PREFIX) and n[len(PREFIX):] in names]


def idle_by_part(s: dict, parts: Iterable[str]) -> Optional[Dict[str, float]]:
    """Idle us of the session by the part of ``parts`` whose range held each gap's start
    (``OUTSIDE``: none did); the values sum to the session's idle. None when the session
    holds none of the parts' ranges."""
    parts = tuple(parts)
    held = ranges(s, parts)
    if not held:
        return None
    out = dict.fromkeys(parts + (OUTSIDE,), 0.0)
    for a, b in idle_gaps(s):
        inner = None
        for name, r0, r1 in held:
            if r0 <= a < r1 and (inner is None or r1 - r0 < inner[1]):
                inner = (name, r1 - r0)
        out[inner[0] if inner else OUTSIDE] += b - a
    return out


def idle_ms(rec: dict, want: str, parts: Tuple[str, ...]) -> Optional[float]:
    """Device idle ms a step (call) in gaps that begin inside the ranges of ``parts``,
    among all of the window kind's parts; None where the session holds none of
    ``parts``."""
    s = host_session(rec, want)
    if s is None or not ranges(s, parts):
        return None
    by_part = idle_by_part(s, PARTS[want])
    return sum(by_part[p] for p in parts) / 1e3 / s["calls"]


def host_ms(rec: dict, want: str, name: str) -> Optional[float]:
    """Host ms a step (call) inside the ranges ``name``: the union of their intervals,
    so that ranges of two threads that overlap count once. None where there is none."""
    s = host_session(rec, want)
    if s is None:
        return None
    held = ranges(s, (name,))
    if not held:
        return None
    union = busy_intervals([(n, a, b - a) for n, a, b in held], s["window_us"])
    return sum(b - a for a, b in union) / 1e3 / s["calls"]
