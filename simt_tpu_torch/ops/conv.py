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

dtypes follow the JAX package: the operands are in the activation's dtype (the caller
casts the weight, as ``w2.astype(self.dtype)`` at simt_tpu/models/layers.py:162-164),
accumulation is float32, the output and d_input are in the activation's dtype and
d_weight is returned in the weight operand's dtype (``dw.astype(w.dtype)``). Autocast
does not act inside the Function.
"""

from __future__ import annotations

import torch

from .kernels.conv3x3 import conv3x3_fwd, conv3x3_taps, conv3x3_wgrad, wgrad_taps

__all__ = ["DilatedConv3x3", "dilated_conv3x3", "conv3x3_taps", "wgrad_taps"]


class DilatedConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.d = d
        return conv3x3_fwd(x, w, d)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        d = ctx.d
        with torch.autocast(x.device.type, enabled=False):
            g = _layout(g.to(x.dtype))
            dx = conv3x3_fwd(g, w, d, flip=True) if ctx.needs_input_grad[0] else None
            dw = conv3x3_wgrad(x, g, d).to(w.dtype) if ctx.needs_input_grad[1] else None
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
