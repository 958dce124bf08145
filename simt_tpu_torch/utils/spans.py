"""Named ranges around the parts of the port's work, on the profiler's clock.

``with span(name, events):`` opens ``torch.profiler.record_function("simt_tpu_torch."
+ name)`` while a profiler records: the range lands on the host timeline around the
operations it encloses, on the clock of the device's kernels, and the profiler adds a
matching annotation on the device timeline. When ``events`` is a list, the span also
records a CUDA event at each end and appends ``(name, start, end)`` to it (read them
after a synchronize). With no profiler and no list it costs one check.

The names are fixed strings: a session's order of calls tells its steps apart.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch.profiler import record_function

PREFIX = "simt_tpu_torch."

Events = List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _on(name: str, events: Optional[Events], traced: bool):
    with record_function(PREFIX + name) if traced else _OFF:
        if events is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        events.append((name, start, end))


def span(name: str, events: Optional[Events] = None):
    """The range ``name`` (and its CUDA events, into ``events``) around a ``with``
    block; a no-op context when no profiler records and ``events`` is None."""
    traced = torch.autograd._profiler_enabled()
    if not traced and events is None:
        return _OFF
    return _on(name, events, traced)
