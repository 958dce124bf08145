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

Inside ``parallel.spatial_rows`` the input is this rank's rows of the images
(``_forward_rows``): each 3x3 of ``features`` and each floor-mode pool fetches its
window (``ops/conv.py``'s ``conv2d_rows``, ``max_pool_rows``), the classifier one
window with its largest halo (``layers.py::aspp_rows``), and the stride-8 logits come
back gathered, whole, on every rank of the spatial group (``parallel.gather_rows``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.conv import conv2d_rows, max_pool_rows
from ..parallel.mesh import RowSharding, gather_rows, row_sharding
from .layers import ClassifierModule, aspp_rows

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
        rows = row_sharding()
        if rows is not None:
            return self._forward_rows(x, rows)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.classifier(self.features(x))
        out = out.float()
        return out, out

    def _forward_rows(self, x: torch.Tensor,
                      rows: RowSharding) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` on this rank's rows; the logits gathered."""
        h = rows.height
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    x, h = conv2d_rows(x, m.weight, m.bias, rows, h, padding=m.padding[0],
                                       dilation=m.dilation[0])
                elif isinstance(m, nn.MaxPool2d):
                    x, h = max_pool_rows(x, rows, h, m.kernel_size, m.stride, m.padding,
                                         m.ceil_mode)
                else:
                    x = m(x)
            out = aspp_rows([self.classifier], x, rows, h)
        out = gather_rows(out.float(), rows, h)
        return out, out


def deeplab_vgg(num_classes: int = 19, *, dtype: torch.dtype = torch.bfloat16
                ) -> DeeplabVGG:
    return DeeplabVGG(num_classes, dtype=dtype)
