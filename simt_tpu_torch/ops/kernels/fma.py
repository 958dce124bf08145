"""float32 fused multiply-add in PyTorch, rounded once as the kernels' ``fmaf``: the
plain versions that hold a kernel's arithmetic bit for bit use it."""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn``: the product is exact in
    float64, the sum is rounded to odd there (TwoSum's error says which way), and the
    cast to float32 then rounds to nearest even as one rounding would."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    bits = s.view(torch.int64)
    to_odd = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    return torch.where(to_odd, (bits + step).view(torch.float64), s).float()
