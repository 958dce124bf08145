"""The profiler session's primer and its kernel-event reader.

Copied from ``simt_tpu_torch/tools/timing.py`` (``PRIMER_LAUNCHES``, ``PRIMER_WORD``,
``prime_session``, ``kernel_events``) at commit
57e0c1f20d09ebc147d8826943b2979c8e4667bf.
"""

import torch

PRIMER_LAUNCHES = 16  # spin kernels that open every profiler session (prime_session)
PRIMER_WORD = "spin_kernel"  # torch.cuda._sleep's kernel


def prime_session() -> None:
    """Open a profiler session with PRIMER_LAUNCHES spin kernels and a synchronize. On
    the H100 machines, from ~25 s into a process on, CUPTI dropped the first 3 kernel
    records of every session; the primer's records take that loss, and every reading
    leaves them out (PRIMER_WORD)."""
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
