"""Stride-1 SAME dilated 3x3 conv with a hand-written backward (counterpart of
``simt_tpu/ops/conv.py::dilated_conv3x3_taps``, the conv2 of every bottleneck).

``dilated_conv3x3(x, w, d)`` is a ``torch.autograd.Function`` of the JAX package's
custom VJP (simt_tpu/ops/conv.py:104-130):

  - forward: the implicit GEMM, B4 (``ops/kernels/conv3x3.py::conv3x3_fwd``);
  - d_input: the same conv of the cotangent with the spatially flipped, io-transposed
    kernel (B4 with ``flip=True``);
  - d_weight: nine tap contractions over all pixels (B5, ``conv3x3_wgrad``).

A gradient is computed only where ``ctx.needs_input_grad`` asks for it, so a frozen
stage computes no d_weight and an input that needs no gradient gets no d_input. On CPU
tensors the same structure runs the plain versions (``conv3x3_taps``, ``wgrad_taps``).
Under a profiler each of the three calls is a range ``simt_tpu_torch.conv3x3``
(``utils/spans.py``); the backward's run on autograd's thread.

dtypes follow the JAX package: the operands are in the activation's dtype (the caller
casts the weight, as ``w2.astype(self.dtype)`` at simt_tpu/models/layers.py:162-164),
accumulation is float32, the output and d_input are in the activation's dtype and
d_weight is returned in the weight operand's dtype (``dw.astype(w.dtype)``). Autocast
does not act inside the Function.

On rows (the spatial axis, ``parallel/mesh.py::spatial_rows``): ``conv2d_rows``,
``max_pool_rows`` and ``dilated_conv3x3_rows`` take this rank's block of an activation
of a given global height, fetch the window their output block reads
(``parallel/mesh.py::fetch_rows``: zeros, or -inf for the pool, outside the image) and
run with no height padding, returning this rank's block of the output and the output's
global height. ``dilated_conv3x3_rows`` runs B4 SAME on the haloed window and keeps the
owned rows, so B4/B5 take no new argument. A rank with no output rows runs no kernel:
``no_rows`` gives its empty output, joined to the op's inputs so that every rank's
graph reaches the same collectives in its backward.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import RowSharding, fetch_rows, row_block
from ..utils.spans import span
from .kernels.conv3x3 import conv3x3_fwd, conv3x3_taps, conv3x3_wgrad, wgrad_taps

__all__ = ["DilatedConv3x3", "dilated_conv3x3", "conv3x3_taps", "wgrad_taps",
           "conv2d_rows", "max_pool_rows", "dilated_conv3x3_rows", "no_rows",
           "out_rows", "row_windows"]


class DilatedConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.d = d
        with span("conv3x3"):
            return conv3x3_fwd(x, w, d)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        d = ctx.d
        dx = dw = None
        with torch.autocast(x.device.type, enabled=False):
            g = _layout(g.to(x.dtype))
            if ctx.needs_input_grad[0]:
                with span("conv3x3"):
                    dx = conv3x3_fwd(g, w, d, flip=True)
            if ctx.needs_input_grad[1]:
                with span("conv3x3"):
                    dw = conv3x3_wgrad(x, g, d).to(w.dtype)
        return dx, dw, None


def _layout(t: torch.Tensor) -> torch.Tensor:
    """The kernels' NHWC layout on a card (a no-op when already channels_last)."""
    if t.device.type == "cuda":
        return t.contiguous(memory_format=torch.channels_last)
    return t


def dilated_conv3x3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv with dilation ``d``, no bias: ``x`` (B, C, H, W),
    ``w`` OIHW (O, C, 3, 3) in ``x``'s dtype -> (B, O, H, W) in ``x``'s dtype."""
    with torch.autocast(x.device.type, enabled=False):
        return DilatedConv3x3.apply(_layout(x), w, int(d))


# --------------------------------------------------------------------------------------
# The same ops on this rank's rows of a row-sharded activation
# --------------------------------------------------------------------------------------


def out_rows(height: int, k: int, stride: int, pad: int, dilation: int = 1,
             ceil_mode: bool = False) -> int:
    """Output rows of a window of ``k`` taps (``dilation`` apart) at ``stride`` over
    ``height`` rows padded by ``pad`` on each side, as ``F.conv2d`` / ``F.max_pool2d``
    count them (in ceil mode the last window starts inside the rows or the top pad)."""
    span = dilation * (k - 1) + 1
    if not ceil_mode:
        return (height + 2 * pad - span) // stride + 1
    n = -(-(height + 2 * pad - span) // stride) + 1
    return n - 1 if (n - 1) * stride >= height + pad else n


def row_windows(size: int, h_out: int, k: int, stride: int, pad: int,
                dilation: int = 1) -> List[Tuple[int, int]]:
    """Each rank's window ``[lo, hi)`` of input rows for its block of the ``h_out``
    output rows (empty for an empty block)."""
    out = []
    for r in range(size):
        lo, hi = row_block(h_out, r, size)
        out.append((lo * stride - pad, (hi - 1) * stride - pad + dilation * (k - 1) + 1)
                   if hi > lo else (0, 0))
    return out


class _NoRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shape, dtype, *inputs):
        ctx.specs = [(t.shape, t.dtype, t.device) for t in inputs]
        return torch.empty(shape, dtype=dtype, device=inputs[0].device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(torch.zeros(s, dtype=d, device=dev)
                              for s, d, dev in ctx.specs))


def no_rows(x: torch.Tensor, channels: int, width: int,
            params: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """The (B, ``channels``, 0, ``width``) output of an op on a rank with no output rows,
    in the op's dtype (autocast's where it is on), differentiable in ``x`` and
    ``params`` (zero gradients): the op's node is in the graph, so the collectives
    before it run in the backward on every rank."""
    dtype = (torch.get_autocast_dtype(x.device.type)
             if torch.is_autocast_enabled(x.device.type) else x.dtype)
    return _NoRows.apply((x.shape[0], channels, 0, width), dtype, x,
                         *(p for p in params if p is not None))


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                rows: RowSharding, height: int, *, stride: int = 1, padding: int = 0,
                dilation: int = 1) -> Tuple[torch.Tensor, int]:
    """``F.conv2d(x, weight, bias, stride, padding, dilation)`` on this rank's rows of
    an activation of global ``height``: (this rank's rows of the output, its global
    height). A 1x1 stride-1 conv reads no other rank's rows."""
    k = weight.shape[2]
    h_out = out_rows(height, k, stride, padding, dilation)
    if k > 1 or stride > 1:
        x = fetch_rows(x, rows, height,
                       row_windows(rows.size, h_out, k, stride, padding, dilation))
    w_out = out_rows(x.shape[3], weight.shape[3], stride, padding, dilation)
    if x.shape[2] == 0:
        return no_rows(x, weight.shape[0], w_out, (weight, bias)), h_out
    return F.conv2d(x, weight, bias, stride, (0, padding), dilation), h_out


def max_pool_rows(x: torch.Tensor, rows: RowSharding, height: int, kernel: int = 3,
                  stride: int = 2, padding: int = 1,
                  ceil_mode: bool = True) -> Tuple[torch.Tensor, int]:
    """``F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)`` on this rank's
    rows (by default the ResNet stem's 3x3/2 pad-1 ceil-mode pool,
    ``models/layers.py::max_pool_ceil``): its window is padded with -inf, its last
    window may run past the last row in ceil mode, and in floor mode the rows past the
    last whole window are read by no rank (an odd height's last row under a 2x2/2
    pool)."""
    h_out = out_rows(height, kernel, stride, padding, ceil_mode=ceil_mode)
    x = fetch_rows(x, rows, height, row_windows(rows.size, h_out, kernel, stride, padding),
                   -math.inf)
    if x.shape[2] == 0:
        w_out = out_rows(x.shape[3], kernel, stride, padding, ceil_mode=ceil_mode)
        return no_rows(x, x.shape[1], w_out), h_out
    return F.max_pool2d(x, kernel, stride, (0, padding), ceil_mode=ceil_mode), h_out


def dilated_conv3x3_rows(x: torch.Tensor, w: torch.Tensor, d: int, rows: RowSharding,
                         height: int) -> torch.Tensor:
    """``dilated_conv3x3`` on this rank's rows: B4 SAME on the window haloed by ``d``
    rows, of which the owned rows are kept (B4/B5 on a card, as unsharded)."""
    x = fetch_rows(x, rows, height, row_windows(rows.size, height, 3, 1, d, d))
    if x.shape[2] == 0:
        return no_rows(x, w.shape[0], x.shape[3], (w,))
    return dilated_conv3x3(x, w, d)[:, :, d:x.shape[2] - d]
