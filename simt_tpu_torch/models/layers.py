"""Building blocks of DeepLabv2-ResNet-101 (counterpart of ``simt_tpu/models/layers.py``).

The math of the reference (model/deeplab_multi.py:57-167), in PyTorch's idiom: NCHW
``nn.Module``s whose names follow the reference, so its ``.pth`` files and the JAX
export load with plain ``load_state_dict``. The JAX package's TPU formulations (the
W-folded stem, the tap GEMMs, the merged-N ASPP) are plain convolutions here.

BatchNorm affine parameters are frozen (``requires_grad=False``, as in the reference);
evaluation normalises with the running statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def frozen_bn(channels: int) -> nn.BatchNorm2d:
    """BatchNorm matching torch defaults (momentum 0.1, eps 1e-5), affine frozen."""
    bn = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, affine=True)
    for p in bn.parameters():
        p.requires_grad_(False)
    return bn


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
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = frozen_bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = frozen_bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = frozen_bn(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample: Optional[nn.Sequential] = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                frozen_bn(planes * 4),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


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
    compatibility; only the first two are summed, the reference's early-return quirk
    (:115-119). The branch sum is taken in float32, then rounded to the activations'
    dtype, as the JAX package does.
    """

    def __init__(self, inplanes: int, num_classes: int):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            nn.Conv2d(inplanes, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in (6, 12, 18, 24)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x).float() + self.conv2d_list[1](x).float()
        return out.to(x.dtype)
