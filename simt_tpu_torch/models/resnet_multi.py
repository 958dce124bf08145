"""DeepLabv2-ResNet101 multi-head (counterpart of ``simt_tpu/models/resnet_multi.py``).

``ResNetMulti`` / ``DeeplabMulti`` of the reference (model/deeplab_multi.py:122-242):

  - 7x7/2 stem + ceil-mode 3x3/2 max pool (:127-133);
  - layer1 (3 blocks), layer2 (4 blocks, stride 2), layer3 (23 blocks, dilation 2),
    layer4 (3 blocks, dilation 4): output stride 8 (:134-137);
  - ``layer5`` ASPP on layer3 features (1024 ch), ``layer6`` on layer4 (2048 ch), with
    the 2-branch sum quirk (``aspp_effective_branches``, as the JAX model's);
  - optional open-set heads ``layer5_1`` / ``layer6_1`` concatenated on channels
    (:140-142, 182-190).

Input: NCHW float32, mean-subtracted BGR. Returns ``(x1, x2)`` float32 NCHW logits at
stride 8. ``dtype=torch.bfloat16`` runs the forward under autocast (bf16 convs, f32
heads' sums), the counterpart of the JAX package's bf16 compute; ``torch.float32``
runs it in float32.

Inside ``parallel.spatial_rows`` the input is this rank's rows of the images; the trunk
and heads run on rows (``layers.py``'s ``*_rows``) and the logits come back gathered,
whole, on every rank of the spatial group (``parallel.gather_rows``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.mesh import RowSharding, gather_rows, row_sharding
from .layers import (ClassifierModule, aspp_rows, bn_act, frozen_bn, max_pool_ceil,
                     res_stage, stage_rows, stem_rows)


class ResNetMulti(nn.Module):
    def __init__(self, num_classes: int = 19, open_classes: int = 0, openset: bool = False,
                 layers: Sequence[int] = (3, 4, 23, 3), dtype: torch.dtype = torch.bfloat16,
                 aspp_effective_branches: int = 2):
        super().__init__()
        self.dtype = dtype
        self.openset = openset
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = frozen_bn(64)
        self.maxpool = max_pool_ceil()
        self.layer1 = res_stage(64, 64, layers[0], stride=1, dilation=1)
        self.layer2 = res_stage(256, 128, layers[1], stride=2, dilation=1)
        self.layer3 = res_stage(512, 256, layers[2], stride=1, dilation=2)
        self.layer4 = res_stage(1024, 512, layers[3], stride=1, dilation=4)
        eff = aspp_effective_branches
        self.layer5 = ClassifierModule(1024, num_classes, eff)
        self.layer6 = ClassifierModule(2048, num_classes, eff)
        self.layer5_1: Optional[ClassifierModule] = None
        self.layer6_1: Optional[ClassifierModule] = None
        if openset:
            self.layer5_1 = ClassifierModule(1024, open_classes, eff)
            self.layer6_1 = ClassifierModule(2048, open_classes, eff)

    def _head(self, x: torch.Tensor, known: nn.Module, open_: Optional[nn.Module]):
        out = known(x)
        if open_ is not None:
            out = torch.cat([out, open_(x)], dim=1)
        return out

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = row_sharding()
        if rows is not None:
            return self._forward_rows(x, rows)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = self.maxpool(bn_act(self.bn1, self.conv1(x)))
            x = self.layer3(self.layer2(self.layer1(x)))
            x1 = self._head(x, self.layer5, self.layer5_1)
            x = self.layer4(x)
            x2 = self._head(x, self.layer6, self.layer6_1)
        return x1.float(), x2.float()

    def _forward_rows(self, x: torch.Tensor,
                      rows: RowSharding) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` on this rank's rows; the logits gathered."""
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x, h = stem_rows(self, x, rows)
            for stage in (self.layer1, self.layer2, self.layer3):
                x, h = stage_rows(stage, x, rows, h)
            x1 = aspp_rows([m for m in (self.layer5, self.layer5_1) if m is not None], x,
                           rows, h)
            x, h = stage_rows(self.layer4, x, rows, h)
            x2 = aspp_rows([m for m in (self.layer6, self.layer6_1) if m is not None], x,
                           rows, h)
        return gather_rows(x1.float(), rows, h), gather_rows(x2.float(), rows, h)


def deeplab_multi(num_classes: int = 19, open_classes: int = 0, openset: bool = False,
                  *, dtype: torch.dtype = torch.bfloat16,
                  aspp_effective_branches: int = 2) -> ResNetMulti:
    """Factory matching ``DeeplabMulti`` (model/deeplab_multi.py:240-242): ResNet-101."""
    return ResNetMulti(num_classes, open_classes, openset, layers=(3, 4, 23, 3),
                       dtype=dtype, aspp_effective_branches=aspp_effective_branches)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded reference init (deeplab_multi.py:143-150): conv weights N(0, 0.01), conv
    biases 0, BN weight 1, bias 0, running mean 0, running var 1. In place; returns
    ``model``. Draws on the CPU, so call it before moving the model to the card."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.01, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
