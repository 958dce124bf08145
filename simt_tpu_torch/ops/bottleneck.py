"""The fused train-mode bottleneck with a hand-written backward (counterpart of
``experiments/pallas_bottleneck/bottleneck.py::fused_bottleneck``).

``fused_bottleneck(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, d)`` is a
``torch.autograd.Function`` of the JAX custom VJP (bottleneck.py:375-406): a whole
identity bottleneck with batch-statistic BatchNorm on one image, its forward B6
(``ops/kernels/bottleneck.py::bottleneck_fwd``) and its backward B7
(``bottleneck_bwd``) from the saved raw conv outputs and statistics. It returns
``(out, (m1, v1, m2, v2, m3, v3))``; the statistics feed the running averages and
carry no gradient.

Like the JAX package, the port keeps it off the model's paths: ``models/layers.py::
Bottleneck`` stays the composed block (decision C4 of ROADMAP.md). Its callers are the
tests and ``tools/bench_fused_bottleneck.py``; ``block_args`` carries a port block's
weights (e.g. loaded by ``state_dict_from_flax``) to it.

Inputs use the port's layouts: ``x`` (1, Ct, H, W), ``channels_last`` on a card; the
OIHW weights of ``conv1`` (P, Ct, 1, 1), ``conv2`` (P, P, 3, 3) and ``conv3``
(Ct, P, 1, 1); the BN weight and bias vectors. x is cast to bf16 and the BN vectors to
float32, as ``_fwd_call`` does; the kernels read float32 or bf16 weights and round them
to bf16 themselves. Gradients come back in each input's dtype, and only for the inputs
that ``ctx.needs_input_grad`` marks: a frozen BN affine gets none. Autocast does not act
inside the Function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels.bottleneck import bottleneck_bwd, bottleneck_fwd

__all__ = ["FusedBottleneck", "fused_bottleneck", "block_args"]


def _layout(t: torch.Tensor) -> torch.Tensor:
    """The kernels' NHWC layout on a card (a no-op when already channels_last)."""
    if t.device.type == "cuda":
        return t.contiguous(memory_format=torch.channels_last)
    return t


class FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, g1, b1, g2, b2, g3, b3, d: int):
        xb = _layout(x.to(torch.bfloat16))
        vecs = [v.float() for v in (g1, b1, g2, b2, g3, b3)]
        out, h1raw, h2raw, sp, st = bottleneck_fwd(xb, w1, w2, w3, *vecs, d)
        ctx.save_for_backward(xb, w1, w2, w3, *vecs, h1raw, h2raw, sp, st)
        ctx.d = d
        ctx.dtypes = [t.dtype for t in (x, w1, w2, w3, g1, b1, g2, b2, g3, b3)]
        stats = (sp[0], sp[1], sp[2], sp[3], st[0], st[1])
        ctx.mark_non_differentiable(*stats)
        ctx.set_materialize_grads(False)  # no zero cotangents for the statistics
        return (out, *stats)

    @staticmethod
    def backward(ctx, dy, *_dstats):
        xb, w1, w2, w3, *rest = ctx.saved_tensors
        vecs, (h1raw, h2raw, sp, st) = rest[:6], rest[6:]
        need = ctx.needs_input_grad
        if dy is None:  # only the statistics were used: they carry no gradient
            return (None,) * 11
        dy = _layout(dy.to(torch.bfloat16))
        dx, dw1, dw2, dw3, dgb_p, dgb_t = bottleneck_bwd(
            dy, xb, w1, w2, w3, *vecs, h1raw, h2raw, sp, st, ctx.d, need=need[:4])
        grads = [dx, dw1, dw2, dw3, dgb_p[0], dgb_p[1], dgb_p[2], dgb_p[3], dgb_t[0],
                 dgb_t[1]]
        out = [g.to(dt) if n else None for g, dt, n in zip(grads, ctx.dtypes, need)]
        return (*out, None)


def fused_bottleneck(x, w1, w2, w3, g1, b1, g2, b2, g3, b3,
                     d: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Single-image fused bottleneck: x (1, Ct, H, W) -> (out (1, Ct, H, W) bf16,
    (m1, v1, m2, v2, m3, v3) float32 batch statistics). Raises ValueError for a batch
    other than 1, as the Pallas kernel takes a single image."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"the fused bottleneck takes x (1, Ct, H, W), got {tuple(x.shape)}")
    with torch.autocast(x.device.type, enabled=False):
        out, *stats = FusedBottleneck.apply(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, int(d))
    return out, tuple(stats)


def block_args(block) -> tuple:
    """The arguments after ``x`` of ``fused_bottleneck`` for a port ``Bottleneck``
    (``models/layers.py``) that is an identity block: no downsample, stride 1."""
    if block.downsample is not None or tuple(block.conv1.stride) != (1, 1):
        raise ValueError("the fused bottleneck is an identity block: no downsample, "
                         "stride 1")
    return (block.conv1.weight, block.conv2.weight, block.conv3.weight,
            block.bn1.weight, block.bn1.bias, block.bn2.weight, block.bn2.bias,
            block.bn3.weight, block.bn3.bias, block.dilation)
