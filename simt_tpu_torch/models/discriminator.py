"""PatchGAN discriminator (``FCDiscriminator``; counterpart of
``simt_tpu/models/discriminator.py``, reference model/discriminator.py:5-34).

Five 4x4 stride-2 convs over class-probability maps (64 -> 512 -> 1 channels), each but
the last followed by LeakyReLU(0.2). The reference ships it unused; the adversarial
warmup (``train/adversarial.py``) trains it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        chans = (num_classes, 64, 128, 256, 512)
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(chans[i], chans[i + 1], 4, stride=2,
                                                    padding=1))
        self.classifier = nn.Conv2d(512, 1, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) maps -> (B, 1, H/32, W/32) float32 logits."""
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            for i in range(1, 5):
                x = F.leaky_relu(getattr(self, f"conv{i}")(x), negative_slope=0.2)
            x = self.classifier(x)
        return x.float()
