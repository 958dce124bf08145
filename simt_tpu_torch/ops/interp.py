"""Bilinear resizes (counterpart of ``simt_tpu/ops/interp.py``).

The align-corners resize (``align_corners=True``, the reference's logits upsample) is a
separable linear map: ``out = A_h @ x @ A_w^T`` with the row-stochastic matrices of
``_interp_matrix`` (two non-zeros per row). The plain path applies them as two
``torch.matmul``s, H first then W, as the JAX package does. The fused eval kernel
(``ops/kernels/eval_fused.py``) reads the same two non-zeros per row from
``interp_taps``, which is derived from the same matrices.

The half-pixel resize (``align_corners=False``) is DeepLabv3's in-model upsample; it is
``F.interpolate``, as the JAX package's is ``jax.image.resize``. On the spatial axis
(``parallel/mesh.py::spatial_rows``) ``upsample_bilinear_half_pixel_rows`` gives this
rank's block of the output rows from the window of source rows they read: the H
direction's two taps a row are ``half_pixel_taps`` (``F.interpolate``'s own float32
source coordinates), the W direction stays ``F.interpolate``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import RowSharding, fetch_rows, row_block


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


def upsample_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int],
                                    rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` with torch ``align_corners=True`` semantics;
    ``rows=(r0, r1)`` gives only the output rows [r0, r1) (the rows ``A_h[r0:r1]``).

    Two matmuls over the interpolation matrices, H then W, in ``x``'s dtype. On the card
    a float32 matmul is IEEE float32 unless ``torch.backends.cuda.matmul.allow_tf32``
    is set; the port's entry points leave it off.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    b, h_in, w_in, c = x.shape
    h_out, w_out = out_hw
    r0, r1 = (0, h_out) if rows is None else rows
    if (h_in, w_in) == (h_out, w_out):
        return x if rows is None else x[:, r0:r1]
    a_h = torch.from_numpy(_interp_matrix(h_in, h_out)[r0:r1]).to(x.device, x.dtype)
    a_w = torch.from_numpy(_interp_matrix(w_in, w_out)).to(x.device, x.dtype)
    # (rows, h_in) @ (B, h_in, w_in*C) -> (B, rows, w_in*C)
    y = torch.matmul(a_h, x.reshape(b, h_in, w_in * c))
    # (w_out, w_in) @ (B*rows, w_in, C) -> (B*rows, w_out, C)
    y = torch.matmul(a_w, y.reshape(b * (r1 - r0), w_in, c))
    return y.reshape(b, r1 - r0, w_out, c)


def upsample_bilinear_half_pixel(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of NHWC ``x`` to ``out_hw`` (torch
    ``align_corners=False``) in float32: DeepLabv3's in-model upsample
    (model/deeplabv3.py:102,137). It equals the JAX package's ``jax.image.resize(...,
    "linear")`` when upsampling; that one antialiases a downsample, this one does not.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=64)
def half_pixel_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                            np.ndarray, np.ndarray]:
    """The two source rows ``i0``, ``i1`` (int64) and weights ``l0``, ``l1`` (float32)
    of every output row of a half-pixel (``align_corners=False``) linear resize from
    ``in_size`` to ``out_size``, as ``F.interpolate`` computes them in float32: the
    source coordinate ``(in/out) * (r + 0.5) - 0.5`` clamped at 0, its floor and
    fraction, the second tap clamped at the last row."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = scale * (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) - np.float32(0.5)
    src = np.maximum(src, np.float32(0.0))
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    l1 = np.clip(src - i0.astype(np.float32), 0.0, 1.0).astype(np.float32)
    taps = (i0, np.minimum(i0 + 1, in_size - 1), (np.float32(1.0) - l1).astype(np.float32),
            l1)
    for arr in taps:
        arr.setflags(write=False)  # cached: shared by every caller
    return taps


def half_pixel_windows(size: int, in_size: int, out_size: int) -> List[Tuple[int, int]]:
    """Each of ``size`` ranks' window ``[lo, hi)`` of source rows for its ``row_block``
    of the ``out_size`` output rows (empty for an empty block); inside ``[0, in_size)``,
    since the taps are clamped at the image's edges."""
    i0, i1, _, _ = half_pixel_taps(in_size, out_size)
    out = []
    for r in range(size):
        lo, hi = row_block(out_size, r, size)
        out.append((int(i0[lo]), int(i1[hi - 1]) + 1) if hi > lo else (0, 0))
    return out


def upsample_bilinear_half_pixel_rows(x: torch.Tensor, rows: RowSharding, height: int,
                                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """``upsample_bilinear_half_pixel`` on this rank's rows, NCHW: ``x`` (B, C, n, w)
    holds this rank's ``rows.block(height)`` of a map of global ``height``; returns this
    rank's ``rows.block(out_hw[0])`` of the (B, C, H, W) float32 output. The source rows
    those output rows read are fetched (``fetch_rows``), the H step takes each row's
    two taps from that window and the W step is ``F.interpolate`` at the rows' own
    height (weights 1 and 0 on the H axis); equal to the whole call within float32
    rounding."""
    h_out, w_out = out_hw
    windows = half_pixel_windows(rows.size, height, h_out)
    win = fetch_rows(x, rows, height, windows).float()
    r0, r1 = rows.block(h_out)
    if r1 == r0:  # an empty window: the empty output, joined to the exchange's node
        return win[:, :, :, :1].expand(-1, -1, -1, w_out)
    lo = windows[rows.index][0]
    i0, i1, l0, l1 = (torch.tensor(t[r0:r1], device=win.device)
                      for t in half_pixel_taps(height, h_out))
    y = win[:, :, i0 - lo] * l0[:, None] + win[:, :, i1 - lo] * l1[:, None]
    return F.interpolate(y, size=(r1 - r0, w_out), mode="bilinear", align_corners=False)
