"""Plain reference of the warmup stage (``tools/trainV1_warmup.py:204-232``) on the
DeepLabv2-ResNet-101 of ``network.py``, in float32 (TF32 off), with its own state.

A step: both heads' stride-8 logits in training mode (batch statistics); each head
upsampled to the crop with ``align_corners=True`` and its softmax CE averaged over the
labelled pixels; ``loss = l2 + lambda_seg * l1``; one SGD step at the poly schedule's
first rate, every conv trained (the heads at 10x), BatchNorm's tensors and the ASPP
branches past the summed two frozen. The CE is summed image by image, each under a checkpoint, so that
no (B, C, H, W) tensor of the batch is held.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from . import network, training


def _head_sums(x1, x2, label):
    """((sum, count) of head 1, of head 2) over one image."""
    hw = label.shape[1:]
    return (*training.ce_sum(training.upsample(x1, hw), label),
            *training.ce_sum(training.upsample(x2, hw), label))


def losses(x1, x2, label):
    """(l1, l2): the masked CE means of both heads over the batch."""
    tot = None
    for b in range(label.shape[0]):
        s = torch.stack(checkpoint(_head_sums, x1[b:b + 1], x2[b:b + 1], label[b:b + 1],
                                   use_reentrant=False))
        tot = s if tot is None else tot + s
    return training.mean(tot[0], tot[1]), training.mean(tot[2], tot[3])


@torch.no_grad()
def loss_terms(cfg: dict, own: Dict[str, torch.Tensor], batch: dict, ntm=None,
               precision: str = "fp32") -> Dict[str, float]:
    """Both heads' CE of a first step computed from given stride-8 logits (``own``:
    ``x1``, ``x2`` NCHW): the check of the loss on the program's own logits.
    ``precision`` "bf16" rounds the upsampled logits to bf16 (the control)."""
    dev = batch["label"].device
    x1, x2 = (own[k].to(dev).float() for k in ("x1", "x2"))
    if precision == "bf16":
        x1, x2 = x1.bfloat16().float(), x2.bfloat16().float()
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    l1, l2 = losses(x1, x2, batch["label"].long())
    return {"loss_seg1": float(l1), "loss_seg2": float(l2)}


def train(cfg: dict, weights: Dict[str, torch.Tensor], ntm, batch: dict, *,
          precision: str = "fp32", half_batch: bool = False) -> dict:
    """The reference's first step on ``batch`` from ``weights``: its loss, by leaf its
    gradient and the change it makes (``training.readings``), its activations
    (``network.tap``) and its stride-8 logits (``own``)."""
    model = cfg["model"]
    branches = model["aspp_effective_branches"]
    P, groups = training.leaves(weights, "warmup", branches)
    named = dict(groups["1x"] + groups["10x"])
    start = {k: p.detach().clone() for k, p in named.items()}
    opt = training.sgd(groups, cfg["optim"])
    batch = training.batch_slice(batch, half_batch)
    taps = {}
    x1, x2 = network.forward(P, training.image_nchw(batch["image"]),
                             layers=model["layers"], openset=model["openset"], train=True,
                             precision=precision, branches=branches, taps=taps)
    network.tap(taps, "logits1", x1)
    network.tap(taps, "logits2", x2)
    own = {"x1": x1.detach().cpu(), "x2": x2.detach().cpu()}
    l1, l2 = losses(x1, x2, batch["label"].long())
    loss = l2 + cfg["simt"]["lambda_seg"] * l1
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in named.items()}
    opt.step()
    parts = {"loss": float(loss.detach()), "loss_seg1": float(l1.detach()),
             "loss_seg2": float(l2.detach())}
    return {**training.readings(named, grads, start, parts), "taps": taps, "own": own}
