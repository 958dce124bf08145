"""DeepLabv3-ASPP on a ResNet-50 trunk (``DeepLabv3``; counterpart of
``simt_tpu/models/deeplabv3.py``, reference model/deeplabv3.py).

The TPAMI-variant backbone: torchvision's ResNet-50 cut after layer3 (output stride
16, 1024 channels; deeplabv3.py:9-21), a 5-branch ASPP named ``assp`` (1x1, dilations
6/12/18, a second 1x1; each conv + BN + ReLU, concatenated, then a 1x1 fuse;
:23-108), the 1x1 classifier ``conv`` with the optional open-set ``conv_1``, and the
in-model half-pixel bilinear upsample to the input size (:129-138,
``align_corners=False``). Returns one float32 NCHW map at the input's size.

Unlike the DeepLabv2 trunk, BatchNorm follows torchvision: the affine parameters are
trainable (``BatchNorm2d``, the port's biased-variance running update, not
``frozen_bn``) and the stride sits on each bottleneck's 3x3 ``conv2``. These 3x3s are
plain convolutions (cuDNN), as the JAX model's are ``nn.Conv``, not the trunk taps op.

Inside ``parallel.spatial_rows`` the input is this rank's rows of the images and the
output this rank's rows of the input-size logits (``_forward_rows``): every conv and
pool with a height extent fetches its window (``ops/conv.py``'s ``*_rows``, the strided
3x3s and the floor-mode pool included), the ASPP fetches one window with its largest
halo for its three dilated branches, and the half-pixel upsample reads the stride-16
rows its output rows need (``ops/interp.py::upsample_bilinear_half_pixel_rows``). Its
logits are the rank's band of the label's rows, so they are not gathered.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv2d_rows, max_pool_rows, no_rows, row_windows
from ..ops.interp import upsample_bilinear_half_pixel, upsample_bilinear_half_pixel_rows
from ..parallel.mesh import RowSharding, fetch_rows, row_sharding
from .layers import BatchNorm2d, stage_rows


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1, affine=True)


class BottleneckV3(nn.Module):
    """torchvision-style bottleneck: the stride on ``conv2``, the 3x3."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)

    def forward_rows(self, x: torch.Tensor, rows: RowSharding,
                     height: int) -> Tuple[torch.Tensor, int]:
        """``forward`` on this rank's rows of an input of global ``height``: (its rows
        of the output, the output's global height). The strided 3x3 ``conv2`` and the
        strided 1x1 ``downsample`` fetch their windows; the other 1x1s are local."""
        s = self.conv2.stride[0]
        out = self.relu(self.bn1(conv2d_rows(x, self.conv1.weight, None, rows, height)[0]))
        out, h = conv2d_rows(out, self.conv2.weight, None, rows, height, stride=s,
                             padding=1)
        out = self.relu(self.bn2(out))
        out = self.bn3(conv2d_rows(out, self.conv3.weight, None, rows, h)[0])
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv2d_rows(x, self.downsample[0].weight, None,
                                                      rows, height, stride=s)[0])
        return self.relu(out + residual), h


class ASPPv3(nn.Module):
    """The 5-branch ASPP with concatenation and a 1x1 fuse (``ASSP``,
    deeplabv3.py:23-108). The reference resizes branch 5 to branch 4's size (:102), a
    no-op after a 1x1 conv."""

    SPECS = ((1, 1), (3, 6), (3, 12), (3, 18), (1, 1))  # (kernel, dilation) a branch

    def __init__(self, in_channels: int):
        super().__init__()
        for i, (k, d) in enumerate(self.SPECS, start=1):
            pad = d if k == 3 else 0
            setattr(self, f"conv{i}", nn.Conv2d(in_channels, 256, k, padding=pad,
                                                dilation=d, bias=False))
            setattr(self, f"bn{i}", _bn(256))
        self.convf = nn.Conv2d(256 * len(self.SPECS), 256, 1, bias=False)
        self.bnf = _bn(256)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
                    for i in range(1, len(self.SPECS) + 1)]
        return self.relu(self.bnf(self.convf(torch.cat(branches, dim=1))))

    def forward_rows(self, x: torch.Tensor, rows: RowSharding,
                     height: int) -> torch.Tensor:
        """``forward`` on this rank's rows: one window with the largest dilation's halo
        is fetched once, each dilated branch reads its own part of it with no height
        padding, the 1x1 branches, the concatenation and the fuse are local."""
        halo = max(d for k, d in self.SPECS if k == 3)
        win = fetch_rows(x, rows, height, row_windows(rows.size, height, 3, 1, halo, halo))
        n = x.shape[2]
        branches = []
        for i, (k, d) in enumerate(self.SPECS, start=1):
            conv = getattr(self, f"conv{i}")
            if k == 1:
                y = conv2d_rows(x, conv.weight, None, rows, height)[0]
            elif n:
                y = F.conv2d(win[:, :, halo - d:halo + n + d], conv.weight, None, 1, (0, d),
                             d)
            else:
                y = no_rows(win, conv.out_channels, win.shape[3], (conv.weight,))
            branches.append(self.relu(getattr(self, f"bn{i}")(y)))
        y = conv2d_rows(torch.cat(branches, dim=1), self.convf.weight, None, rows, height)[0]
        return self.relu(self.bnf(y))


class DeepLabv3(nn.Module):
    def __init__(self, num_classes: int = 19, open_classes: int = 0,
                 openset: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)  # floor mode (torchvision)
        inplanes = 64
        for idx, (planes, blocks, stride) in enumerate(((64, 3, 1), (128, 4, 2),
                                                        (256, 6, 2)), start=1):
            stage = [BottleneckV3(inplanes, planes, stride, downsample=True)]
            stage += [BottleneckV3(planes * 4, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{idx}", nn.Sequential(*stage))
            inplanes = planes * 4
        self.assp = ASPPv3(inplanes)
        self.conv = nn.Conv2d(256, num_classes, 1, bias=True)
        self.conv_1 = nn.Conv2d(256, open_classes, 1, bias=True) if openset else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) mean-subtracted BGR -> (B, C (+O), H, W) float32 logits."""
        rows = row_sharding()
        if rows is not None:
            return self._forward_rows(x, rows)
        h, w = x.shape[2:]
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.assp(self.layer3(self.layer2(self.layer1(x))))
            out = self.conv(x)
            if self.conv_1 is not None:
                out = torch.cat([out, self.conv_1(x)], dim=1)
        return upsample_bilinear_half_pixel(out.permute(0, 2, 3, 1), (h, w)).permute(
            0, 3, 1, 2)

    def _forward_rows(self, x: torch.Tensor, rows: RowSharding) -> torch.Tensor:
        """``forward`` on this rank's rows: its ``rows.block(H)`` of the logits."""
        w = x.shape[3]
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            c, m = self.conv1, self.maxpool
            x, h = conv2d_rows(x, c.weight, None, rows, rows.height, stride=c.stride[0],
                               padding=c.padding[0])
            x, h = max_pool_rows(self.relu(self.bn1(x)), rows, h, m.kernel_size, m.stride,
                                 m.padding, m.ceil_mode)
            for stage in (self.layer1, self.layer2, self.layer3):
                x, h = stage_rows(stage, x, rows, h)
            x = self.assp.forward_rows(x, rows, h)
            heads = [m for m in (self.conv, self.conv_1) if m is not None]
            out = torch.cat([conv2d_rows(x, m.weight, m.bias, rows, h)[0] for m in heads],
                            dim=1)
        return upsample_bilinear_half_pixel_rows(out, rows, h, (rows.height, w))


def deeplabv3(num_classes: int = 19, open_classes: int = 0, openset: bool = False, *,
              dtype: torch.dtype = torch.bfloat16) -> DeepLabv3:
    return DeepLabv3(num_classes, open_classes, openset, dtype=dtype)
