"""The work of one call, counted the same whatever implements it: the FLOPs and the
computed bytes of the SimT step and of the other targets the profiling tools time.

``step_work(what, layers=, hw=, batch_size=)`` builds a CPU twin of the bench's SimT
setup at that geometry (``profile_step.setup`` on the CPU, the models in float32 as the
CPU runs them) and dispatches one call of ``what`` on fake tensors under
``torch.utils.flop_counter.FlopCounterMode`` (``count``). On the CPU every kernel
wrapper takes its plain version, whose aten ops the counter sees (conv2's tap matmuls,
the loss core's upsample matmuls), so the count is the same work a card runs through
B2-B5, and the same whichever of the two runs. It is not counted on the card: B2-B5
launch through ``ctypes`` inside ``torch.autograd.Function``s, which the dispatcher
never sees, so a count there would miss conv2 and the loss core and would depend on the
implementation.

``what`` is one of ``profile_trace``'s targets: ``step`` (the full train step),
``fwd`` (the student's forward), ``fwdbwd`` (its forward and backward of the dummy
loss), ``teacher`` (the teacher's forward and softmax) and ``trunk``
(``profile_trunk.Trunk34``'s forward and backward). Each result is cached per key
within a process.

``bytes`` is the sum, over every aten op of the call but the views, of the bytes of its
tensor operands and results (``count``): the counterpart of XLA's "bytes accessed", a
computed upper bound on what an unfused program moves, not a reading of HBM traffic.
The twin's activations are float32, so it bounds the card's bf16 step from further
above still (a bf16 twin counts the same FLOPs and 13% fewer bytes at full width).

A full-width step (ResNet-101, 512x1024, batch 1) counts 2.925 TFLOP and 218.6 GB. On
fake tensors the count's time is the dispatch of the step's ops, whatever the
geometry: about 10 s of one CPU core for the full-depth step.
"""

from __future__ import annotations

import collections
import copy
import functools
from typing import Callable, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from . import profile_trace
from .bench import RESNET101, TRAIN_HW


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _Bytes(TorchDispatchMode):
    """Operand and result bytes of every aten op that is not a view, by op (``prim``
    ops, which fake tensors add to ask a tensor's device, move nothing)."""

    def __init__(self):
        super().__init__()
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.by_op[str(func.overloadpacket)] += _tensor_bytes((args, kwargs, out))
        return out


def count(fn: Callable[[], object]) -> dict:
    """{"flops", "bytes", "by_op"} of one call of ``fn``: the FLOPs ``FlopCounterMode``
    counts (the matmuls and convolutions and their backwards), the computed bytes
    (``_Bytes``) and, for each aten op that does FLOPs, its FLOPs and bytes. The call
    runs on fake tensors (``FakeTensorMode``; real tensors it reads are taken as fake
    ones, and what it writes in place is left as it was): every op is dispatched with
    its shapes and dtypes and none is computed, so a full-width step counts in seconds
    and in the memory of its weights."""
    with FakeTensorMode(allow_non_fake_inputs=True), \
            FlopCounterMode(display=False) as flops, _Bytes() as nbytes:
        fn()
    by_flops = {str(op): int(n) for op, n in flops.get_flop_counts()["Global"].items()}
    return {"flops": int(flops.get_total_flops()), "bytes": sum(nbytes.by_op.values()),
            "by_op": {op: {"flops": n, "bytes": nbytes.by_op[op]}
                      for op, n in sorted(by_flops.items())}}


@functools.lru_cache(maxsize=None)
def _work(what: str, layers: Tuple[int, ...], hw: Tuple[int, int],
          batch_size: int) -> dict:
    return count(profile_trace.target(what, torch.device("cpu"), batch_size, hw, layers))


def step_work(what: str = "step", *, layers: Sequence[int] = RESNET101,
              hw: Sequence[int] = TRAIN_HW, batch_size: int = 1) -> dict:
    """``count`` of one call of ``what`` (``profile_trace.WHATS``) on a float32 CPU
    twin of the bench's SimT setup at this geometry; cached per key in this process
    (each caller gets its own copy)."""
    return copy.deepcopy(_work(what, tuple(layers), tuple(hw), batch_size))
