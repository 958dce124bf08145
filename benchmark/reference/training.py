"""What the plain training references share: tensors as leaves, the optimizers of the
reference trainers, the masked means, the per-image upsample, and the readings the
comparison takes of the first step (its loss, and by leaf its gradient and the change
it makes). The first step's rate is the poly schedule's base rate.

SGD (momentum 0.9, weight decay 5e-4, the heads at 10x) for the model and Adam (betas
0.9 / 0.999, eps 1e-8) for the noise transition matrices are ``torch.optim``'s, as the
reference trainers use them (``trainV2_simt.py:270-297``, ``trainV1_warmup.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from . import network

IGNORE = 255
MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)


def leaves(weights: Dict[str, torch.Tensor], stage: str, branches: int):
    """(P, groups): fresh float32 copies of ``weights`` (the trainable ones requiring
    grad) and {"1x": [...], "10x": [...]} of (name, tensor)."""
    P, groups = {}, {"1x": [], "10x": []}
    for name, t in weights.items():
        kind = network.trainable(name, stage=stage, branches=branches)
        P[name] = t.detach().clone()
        if kind != "frozen":
            P[name].requires_grad_(True)
            groups[kind].append((name, P[name]))
    return P, groups


def sgd(groups, optim: dict) -> torch.optim.SGD:
    """SGD at the first step's rate, the heads at 10x."""
    lr = optim["learning_rate"]
    return torch.optim.SGD([{"params": [p for _, p in groups["1x"]], "lr": lr},
                            {"params": [p for _, p in groups["10x"]], "lr": 10 * lr}],
                           lr=lr, momentum=optim["momentum"],
                           weight_decay=optim["weight_decay"])


def adam(p: torch.Tensor, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def image_nchw(image: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) BGR -> mean-subtracted float32 NCHW."""
    mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=image.device)
    return (image.float() - mean).permute(0, 3, 1, 2)


def upsample(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear resize with ``align_corners=True`` (the reference's
    ``nn.Upsample(..., align_corners=True)``)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


def ce_sum(logits: torch.Tensor, label: torch.Tensor):
    """(sum of the softmax CE over pixels whose label is not IGNORE, their count);
    ``logits`` (B, K, H, W), ``label`` (B, H, W) integer."""
    valid = label != IGNORE
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -torch.gather(F.log_softmax(logits, 1), 1, safe[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum().float()


def mean(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``s / n``, 0 where nothing counted."""
    return torch.where(n > 0, s / n.clamp(min=1.0), torch.zeros_like(s))


def readings(named: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             start: Dict[str, torch.Tensor], parts: Dict[str, float]) -> dict:
    """The comparison's readings of one side's first step: its loss and loss terms
    (``parts``), the norm of each leaf's gradient and of each leaf's change from
    ``start``."""
    return {"loss": parts["loss"], "parts": parts,
            "grad": {k: float(g.double().norm()) for k, g in grads.items()},
            "change": {k: float((named[k].detach().double() - start[k].double()).norm())
                       for k in start}}


def batch_slice(batch: dict, half: bool) -> dict:
    """The batch, or (``half``: a planted fault) its first half alone."""
    if not half:
        return batch
    n = max(1, batch["label"].shape[0] // 2)
    return {k: v[:n] for k, v in batch.items()}


@contextlib.contextmanager
def ieee_fp32():
    """IEEE float32 matmuls and convolutions on the card, the flags as they were after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
