"""Device selection shared by the entry points.

Entry points default to ``"cuda"``. Without a usable card they raise instead of
carrying on quietly on the CPU; the CPU runs only when the caller names it.
"""

from __future__ import annotations

from typing import Union

import torch

# Dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): bf16 tensor-core
# and float32 (non-tensor-core) flop/s, HBM3 bytes/s. The kernels' bounds, their
# schedules and the profiling tools' floors and MFU read these.
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')")
    return dev
