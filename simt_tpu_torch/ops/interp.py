"""Bilinear resize with ``align_corners=True`` (counterpart of ``simt_tpu/ops/interp.py``).

The resize is a separable linear map: ``out = A_h @ x @ A_w^T`` with the row-stochastic
matrices of ``_interp_matrix`` (two non-zeros per row). The plain path applies them as
two ``torch.matmul``s, H first then W, as the JAX package does. The fused eval kernel
(``ops/kernels/eval_fused.py``) reads the same two non-zeros per row from
``interp_taps``, which is derived from the same matrices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic (out_size, in_size) align-corners linear interpolation matrix."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        a[:, 0] = 1.0
        return a
    if out_size == 1:
        # align_corners maps the single output point to source index 0.
        a[0, 0] = 1.0
        return a
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    a[rows, lo] = 1.0 - frac
    a[rows, lo + 1] = frac
    return a


@functools.lru_cache(maxsize=64)
def interp_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                        np.ndarray, np.ndarray]:
    """The two taps of each row of ``_interp_matrix(in_size, out_size)``.

    Returns int32 ``lo``, ``hi`` and float32 ``w0``, ``w1`` of length ``out_size`` with
    ``A[r] = w0[r] * e_lo[r] + w1[r] * e_hi[r]``. The weights are read out of the matrix,
    not recomputed; ``hi == lo`` carries ``w1 == 0`` (a source of size 1). Raises if a row
    of the matrix has another non-zero.
    """
    a = _interp_matrix(in_size, out_size)
    rows = np.arange(out_size)
    if in_size == 1 or out_size == 1:
        lo = np.zeros(out_size, np.int64)
    else:
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    hi = np.minimum(lo + 1, in_size - 1)
    w0 = a[rows, lo]
    w1 = np.where(hi != lo, a[rows, hi], np.float32(0.0)).astype(np.float32)
    rebuilt = np.zeros_like(a)
    rebuilt[rows, lo] += w0
    rebuilt[rows, hi] += w1
    if not np.array_equal(rebuilt, a):
        raise AssertionError(f"interp matrix ({in_size}->{out_size}) is not two-tap")
    taps = (lo.astype(np.int32), hi.astype(np.int32), w0, w1)
    for arr in taps:
        arr.setflags(write=False)  # cached: shared by every caller
    return taps


def upsample_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` with torch ``align_corners=True`` semantics.

    Two matmuls over the interpolation matrices, H then W, in ``x``'s dtype. On the card
    a float32 matmul is IEEE float32 unless ``torch.backends.cuda.matmul.allow_tf32``
    is set; the port's entry points leave it off.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    b, h_in, w_in, c = x.shape
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    a_h = torch.from_numpy(_interp_matrix(h_in, h_out)).to(x.device, x.dtype)
    a_w = torch.from_numpy(_interp_matrix(w_in, w_out)).to(x.device, x.dtype)
    # (h_out, h_in) @ (B, h_in, w_in*C) -> (B, h_out, w_in*C)
    y = torch.matmul(a_h, x.reshape(b, h_in, w_in * c))
    # (w_out, w_in) @ (B*h_out, w_in, C) -> (B*h_out, w_out, C)
    y = torch.matmul(a_w, y.reshape(b * h_out, w_in, c))
    return y.reshape(b, h_out, w_out, c)
