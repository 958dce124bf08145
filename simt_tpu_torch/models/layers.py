"""Building blocks of DeepLabv2-ResNet-101 (counterpart of ``simt_tpu/models/layers.py``).

The math of the reference (model/deeplab_multi.py:57-167), in PyTorch's idiom: NCHW
``nn.Module``s whose names follow the reference, so its ``.pth`` files and the JAX
export load with plain ``load_state_dict``. The bottleneck's dilated 3x3 conv goes
through the port's own op, ``ops/conv.py::dilated_conv3x3`` (kernels B4/B5 on a card),
as the JAX package's goes through ``dilated_conv3x3_taps``; its other TPU formulations
(the W-folded stem, the 1x1 dots, the merged-N ASPP) are plain convolutions here.

BatchNorm affine parameters are frozen (``requires_grad=False``, as in the reference).
Evaluation normalises with the running statistics; training with the batch statistics,
updating the running ones as ``flax.linen.BatchNorm`` does (``BatchNorm2d``), over the
global batch of the ranks inside ``parallel.global_batch_stats``.

``bn_act`` runs a BatchNorm with its ReLU and the bottleneck's residual add. Where the
BatchNorm normalises with its running statistics, no autograd graph is recorded and the
activations are bfloat16 on a card (the frozen SimT teacher, every evaluation), that is
one pass of the port's kernel (``ops/kernels/bn_act.py``) on channels_last copies where
they are not; every other call (training, float32, the CPU) composes the modules.

Inside ``parallel.spatial_rows`` the ResNet trunk runs on this rank's rows
(``stem_rows``, ``stage_rows``, ``aspp_rows``): every conv and pool with
a height extent fetches its window from the other ranks (``ops/conv.py``'s ``*_rows``)
and runs with no height padding; each layer's global height follows from the input's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import (conv2d_rows, dilated_conv3x3, dilated_conv3x3_rows, max_pool_rows,
                        no_rows, row_windows)
from ..ops.kernels.bn_act import bn_act as fused_bn_act
from ..parallel.mesh import RowSharding, all_reduce_sum, batch_stats_group, fetch_rows


class _Moments(torch.autograd.Function):
    """Per-channel (sum, sum of squares) of an NCHW tensor in float32 (float64 for a
    float64 tensor), (2, C). The backward keeps only the input: d/dx = g_sum + 2 x
    g_sq."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx = g[0, None, :, None, None] + 2.0 * x.to(g.dtype) * g[1, None, :, None, None]
        return dx.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var`` uses the
    *biased* batch variance, as ``flax.linen.BatchNorm`` (``simt_tpu/models/layers.py:
    47-55``) and not the unbiased one torch uses: the port is held to the JAX package.

    torch's own update is ``rv = m*rv_old + (1-m)*var*N/(N-1)`` (``m = 1 - momentum``,
    ``N = B*H*W``); rescaling its increment by ``(N-1)/N`` gives flax's
    ``m*rv_old + (1-m)*var`` exactly, with no second pass over the activations. The
    normalisation itself (batch statistics in training, running ones in eval) and the
    state_dict keys are torch's.

    Inside ``parallel.global_batch_stats(group)`` (a data group of several ranks) the
    batch statistics are the global batch's, as under the JAX package's global
    program (``_global_forward``).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        group = batch_stats_group()
        if group is not None:
            return self._global_forward(x, group)
        # torch updates a copy (autograd keeps the tensor it updated), then
        # running_var takes the rescaled increment.
        rv_torch = self.running_var.clone()
        self.num_batches_tracked.add_(1)
        out = F.batch_norm(x, self.running_mean, rv_torch, self.weight, self.bias, True,
                           self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (rv_torch - keep) * ((n - 1) / n))
        return out

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        """Training mode over the ranks of ``group``: per-channel (sum, sum of squares,
        count) summed across them by a differentiable all-reduce, so that autograd
        gives the global batch's gradient (the trainable affine parameters of
        DeepLabv3 need it); flax's variance E[x^2] - E[x]^2 over the global batch, and
        its biased running-variance update with N the global count (decision C-d1)."""
        c = x.shape[1]
        moments = _Moments.apply(x)
        local = torch.cat([moments.reshape(-1),
                           x.new_full((1,), x.numel() // c, dtype=moments.dtype)])
        tot = all_reduce_sum(local, group)
        mean = tot[:c] / tot[2 * c]
        var = torch.clamp(tot[c:2 * c] / tot[2 * c] - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        shift = -mean * mul
        if self.bias is not None:
            shift = shift + self.bias
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        return (x * mul[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


def frozen_bn(channels: int) -> BatchNorm2d:
    """BatchNorm matching torch defaults (momentum 0.1, eps 1e-5), affine frozen."""
    bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1, affine=True)
    for p in bn.parameters():
        p.requires_grad_(False)
    return bn


def takes_kernel(bn: nn.BatchNorm2d, x: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> bool:
    """Whether ``bn_act`` runs ``bn`` (and its add and ReLU) as the fused kernel: ``bn``
    normalises with its running statistics, ``x`` is bfloat16 on a card, and no autograd
    graph is recorded for ``x``, the residual or ``bn``'s parameters."""
    if bn.training or bn.running_mean is None or not x.is_cuda or x.dtype != torch.bfloat16:
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or (residual is not None and residual.requires_grad)
        or any(p.requires_grad for p in (bn.weight, bn.bias) if p is not None)))


def bn_act(bn: nn.BatchNorm2d, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
           relu: bool = True) -> torch.Tensor:
    """``relu(bn(x) [+ residual])``, or ``bn(x)`` alone with ``relu=False``: where
    ``takes_kernel`` holds, one pass of the fused kernel on ``x`` and the residual in the
    kernel's channels_last layout (a no-op when they are in it already; the kernel
    raises on anything else it cannot take), else the modules composed (the ReLU in
    place, as ``nn.ReLU(inplace=True)``)."""
    if takes_kernel(bn, x, residual):
        cl = torch.channels_last
        return fused_bn_act(x.contiguous(memory_format=cl), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, bn.eps, relu=relu,
                            residual=None if residual is None
                            else residual.contiguous(memory_format=cl))
    out = bn(x)
    if residual is not None:
        out = out + residual
    return torch.relu_(out) if relu else out


def max_pool_ceil() -> nn.MaxPool2d:
    """The 3x3/2 pad-1 ceil-mode max pool after the stem (deeplab_multi.py:133)."""
    return nn.MaxPool2d(kernel_size=3, stride=2, padding=1, ceil_mode=True)


class Bottleneck(nn.Module):
    """ResNet bottleneck with optional dilation (deeplab_multi.py:57-101).

    The stride sits on the 1x1 ``conv1`` (the DeepLab variant), not on the 3x3.
    """

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.dilation = dilation
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = frozen_bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = frozen_bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = frozen_bn(planes * 4)
        self.downsample: Optional[nn.Sequential] = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                frozen_bn(planes * 4),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = bn_act(self.bn1, self.conv1(x))
        # conv2 through the port's own conv op (B4/B5 on a card), as the JAX package
        # routes it through dilated_conv3x3_taps; ``conv2`` keeps the parameter.
        out = dilated_conv3x3(out, self.conv2.weight.to(out.dtype), self.dilation)
        out = self.conv3(bn_act(self.bn2, out))
        residual = x
        if self.downsample is not None:
            residual = bn_act(self.downsample[1], self.downsample[0](x), relu=False)
        return bn_act(self.bn3, out, residual)

    def forward_rows(self, x: torch.Tensor, rows: RowSharding,
                     height: int) -> Tuple[torch.Tensor, int]:
        """``forward`` on this rank's rows of an input of global ``height``: (its rows
        of the output, the output's global height). The strided 1x1 ``conv1`` and
        ``downsample`` of layer2's first block and the dilated 3x3 fetch their windows."""
        s = self.conv1.stride[0]
        out, h = conv2d_rows(x, self.conv1.weight, None, rows, height, stride=s)
        out = bn_act(self.bn1, out)
        out = dilated_conv3x3_rows(out, self.conv2.weight.to(out.dtype), self.dilation,
                                   rows, h)
        out = conv2d_rows(bn_act(self.bn2, out), self.conv3.weight, None, rows, h)[0]
        residual = x
        if self.downsample is not None:
            residual = bn_act(self.downsample[1],
                              conv2d_rows(x, self.downsample[0].weight, None, rows, height,
                                          stride=s)[0], relu=False)
        return bn_act(self.bn3, out, residual), h


def res_stage(inplanes: int, planes: int, blocks: int, *, stride: int,
              dilation: int) -> nn.Sequential:
    """One ResNet stage (``_make_layer``, deeplab_multi.py:152-167).

    Projection on the first block iff stride != 1, a channel change, or dilation in
    {2, 4} (the reference's dilated stages always get one, :154).
    """
    has_ds = stride != 1 or inplanes != planes * 4 or dilation in (2, 4)
    layers = [Bottleneck(inplanes, planes, stride, dilation, downsample=has_ds)]
    layers += [Bottleneck(planes * 4, planes, dilation=dilation) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ClassifierModule(nn.Module):
    """ASPP classifier (``Classifier_Module``, deeplab_multi.py:104-119).

    Four dilated 3x3 convs with bias (dilations 6/12/18/24) are created, for checkpoint
    compatibility; the first ``effective_branches`` are summed. The multi-head and VGG
    models sum two, the reference's early-return quirk (:115-119); Res_Deeplab sums all
    four (deeplab.py:112-116). The branch sum is taken in float32, then rounded to the
    activations' dtype, as the JAX package's ``ASPPHead`` does.
    """

    def __init__(self, inplanes: int, num_classes: int, effective_branches: int = 2):
        super().__init__()
        if not 1 <= effective_branches <= 4:
            raise ValueError(f"effective_branches must be in 1..4, got {effective_branches}")
        self.effective_branches = effective_branches
        self.conv2d_list = nn.ModuleList(
            nn.Conv2d(inplanes, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in (6, 12, 18, 24)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x).float()
        for conv in self.conv2d_list[1:self.effective_branches]:
            out = out + conv(x).float()
        return out.to(x.dtype)

    @property
    def halo(self) -> int:
        """The most rows above or below an output row that the summed branches read."""
        return max(c.dilation[0] for c in self.conv2d_list[:self.effective_branches])

    def forward_window(self, win: torch.Tensor, halo: int) -> torch.Tensor:
        """``forward``'s rows for a window haloed by ``halo`` (>= ``self.halo``) rows on
        each side: each branch reads its own dilation's part of it, with no height
        padding. An empty window gives the empty output."""
        n = max(win.shape[2] - 2 * halo, 0)
        out = None
        for conv in self.conv2d_list[:self.effective_branches]:
            d = conv.dilation[0]
            if n:
                y = F.conv2d(win[:, :, halo - d:halo + n + d], conv.weight, conv.bias, 1,
                             (0, d), d)
            else:
                y = no_rows(win, conv.out_channels, win.shape[3], (conv.weight, conv.bias))
            out = y.float() if out is None else out + y.float()
        return out.to(win.dtype)


# --------------------------------------------------------------------------------------
# The ResNet trunk and the ASPP heads on this rank's rows (``parallel.spatial_rows``)
# --------------------------------------------------------------------------------------


def stem_rows(model: nn.Module, x: torch.Tensor,
              rows: RowSharding) -> Tuple[torch.Tensor, int]:
    """``model``'s stem (``conv1`` 7x7/2 pad 3, ``bn1``, ``relu``, the ceil-mode
    ``maxpool``) on this rank's rows of an image batch of ``rows.height`` rows: (its
    rows of the pool's output, the output's global height)."""
    c = model.conv1
    x, h = conv2d_rows(x, c.weight, c.bias, rows, rows.height, stride=c.stride[0],
                       padding=c.padding[0])
    return max_pool_rows(bn_act(model.bn1, x), rows, h)


def stage_rows(stage: nn.Sequential, x: torch.Tensor, rows: RowSharding,
               height: int) -> Tuple[torch.Tensor, int]:
    """A ``res_stage`` of bottlenecks on this rank's rows."""
    for block in stage:
        x, height = block.forward_rows(x, rows, height)
    return x, height


def aspp_rows(heads: Sequence[ClassifierModule], x: torch.Tensor, rows: RowSharding,
              height: int) -> torch.Tensor:
    """The ASPP heads that read ``x`` (the known head and the open one), concatenated on
    channels, on this rank's rows: one window with the largest halo any of their
    branches reads, fetched once for all of them."""
    halo = max(h.halo for h in heads)
    win = fetch_rows(x, rows, height, row_windows(rows.size, height, 3, 1, halo, halo))
    outs = [h.forward_window(win, halo) for h in heads]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

