"""DeepLab-VGG16 (``DeeplabVGG``; counterpart of ``simt_tpu/models/deeplab_vgg.py``,
reference model/deeplab_vgg.py).

The reference file is Python-2-only (``range(23)+range(24,30)`` at deeplab_vgg.py:34),
so this is its repaired intent, as in the JAX package: the VGG16 features with pool4
and pool5 removed, the conv5 block dilated 2, fc6/fc7 as dilation-4 3x3 convs of 1024
channels, and the ASPP ``classifier`` summing 2 branches (the same early-return quirk,
deeplab_vgg.py:17-21). Output stride 8; ``forward`` returns ``(x, x)`` as float32 NCHW.

``features`` is an ``nn.Sequential`` whose indices are the reference's after the pool
removal: convs at ``_VGG_CONVS``' indices, a ReLU after each, floor-mode 2x2/2 max
pools after the ReLUs of convs 2, 7 and 14, so ``features.29`` is fc6 and the JAX
export's ``features_{i}`` land on the same modules. The convs are cuDNN's, as the JAX
package's are ``nn.Conv``. No torchvision weights are read (they would need a
download): weights come from ``init_weights``, a JAX export or a ``.pth``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import ClassifierModule, refuse_rows

# (Sequential index, out channels, dilation) of every conv of the trimmed stack.
_VGG_CONVS = (
    (0, 64, 1), (2, 64, 1),
    (5, 128, 1), (7, 128, 1),
    (10, 256, 1), (12, 256, 1), (14, 256, 1),
    (17, 512, 1), (19, 512, 1), (21, 512, 1),
    (23, 512, 2), (25, 512, 2), (27, 512, 2),  # conv5, dilated (deeplab_vgg.py:36-38)
    (29, 1024, 4), (31, 1024, 4),  # fc6 / fc7 (deeplab_vgg.py:40-41)
)
_POOL_AFTER = (2, 7, 14)  # the old pools 4/9/16 follow these convs' ReLUs


def vgg_features() -> nn.Sequential:
    layers = []
    in_ch = 3
    for idx, ch, dil in _VGG_CONVS:
        assert len(layers) == idx
        layers += [nn.Conv2d(in_ch, ch, 3, padding=dil, dilation=dil, bias=True),
                   nn.ReLU(inplace=True)]
        if idx in _POOL_AFTER:
            layers.append(nn.MaxPool2d(2, 2))
        in_ch = ch
    return nn.Sequential(*layers)


class DeeplabVGG(nn.Module):
    def __init__(self, num_classes: int = 19, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.features = vgg_features()
        self.classifier = ClassifierModule(1024, num_classes, effective_branches=2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        refuse_rows(type(self).__name__)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.classifier(self.features(x))
        out = out.float()
        return out, out


def deeplab_vgg(num_classes: int = 19, *, dtype: torch.dtype = torch.bfloat16
                ) -> DeeplabVGG:
    return DeeplabVGG(num_classes, dtype=dtype)
