"""DeepLab single-head ResNet-101 (``Res_Deeplab``; counterpart of
``simt_tpu/models/deeplab_single.py``, reference model/deeplab.py).

The trunk of ``ResNetMulti`` (``res_stage``, so every bottleneck's dilated 3x3 conv runs
on the port's own op, kernels B4/B5 on a card) with ONE classifier, ``layer5``, on the
layer4 features, whose ASPP sums all four branches (deeplab.py:112-116 returns outside
the loop, unlike the multi-head quirk). ``forward`` returns the logits twice, ``(x,
x)`` (deeplab.py:166-177), as float32 NCHW at stride 8. The reference uses it as an
alternative eval model (evaluate_cityscapes.py:12). Inside ``parallel.spatial_rows`` it
runs on this rank's rows and returns the gathered logits, as ``ResNetMulti`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..parallel.mesh import gather_rows, row_sharding
from .layers import (ClassifierModule, aspp_rows, bn_act, frozen_bn, max_pool_ceil,
                     res_stage, stage_rows, stem_rows)


class DeeplabSingle(nn.Module):
    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = frozen_bn(64)
        self.maxpool = max_pool_ceil()
        self.layer1 = res_stage(64, 64, layers[0], stride=1, dilation=1)
        self.layer2 = res_stage(256, 128, layers[1], stride=2, dilation=1)
        self.layer3 = res_stage(512, 256, layers[2], stride=1, dilation=2)
        self.layer4 = res_stage(1024, 512, layers[3], stride=1, dilation=4)
        self.layer5 = ClassifierModule(2048, num_classes, effective_branches=4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = row_sharding()
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            if rows is None:
                x = self.maxpool(bn_act(self.bn1, self.conv1(x)))
                x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
                out = self.layer5(x)
            else:
                x, h = stem_rows(self, x, rows)
                for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                    x, h = stage_rows(stage, x, rows, h)
                out = aspp_rows([self.layer5], x, rows, h)
        out = out.float() if rows is None else gather_rows(out.float(), rows, h)
        return out, out


def res_deeplab(num_classes: int = 19, *, dtype: torch.dtype = torch.bfloat16
                ) -> DeeplabSingle:
    """Factory matching ``Res_Deeplab`` (deeplab.py:223): ResNet-101, single head."""
    return DeeplabSingle(num_classes, layers=(3, 4, 23, 3), dtype=dtype)
