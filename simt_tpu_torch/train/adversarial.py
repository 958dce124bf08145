"""Adversarial warmup (counterpart of ``simt_tpu/train/adversarial.py``; an extension
beyond the reference, which ships ``FCDiscriminator`` unused: its import is commented
out at trainV2_simt.py:19).

The AdaptSegNet output-space scheme the discriminator was built for: the discriminator
tells the segmenter's softmax maps from one-hot label maps, and the segmenter earns a
bonus for fooling it. One call of the step, as the JAX step:

  - the segmenter's forward in train mode; each head's logits upsampled to the crop
    (align corners, ``ops/interp.py``) and the masked CE (``cross_entropy_2d``);
    ``loss = l2 + lambda_seg * l1 + LAMBDA_ADV * BCE(D(softmax(p2)), 1)``; one SGD
    step over the warmup groups at the poly rate (a single-output model counts as
    both heads);
  - the discriminator's loss ``BCE(D(onehot), 1) + BCE(D(p2.detach()), 0)``, where
    ``onehot`` maps ignored pixels to class 0 (the JAX package's quirk, kept), and one
    Adam step (lr 1e-4, betas 0.9/0.99, constant rate) from D's parameters as they
    were before the step. The segmenter's backward leaves no gradient in D's
    parameters: they do not require one while it runs.

The step never waits for the card: the metrics come back as 0-d tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipeline import normalize_image, normalize_label
from ..ops.interp import upsample_bilinear_align_corners
from ..ops.losses import cross_entropy_2d
from ..ops.schedules import poly_lr
from ..utils.spans import Events, span
from .state import WarmupState

D_LR = 1e-4
LAMBDA_ADV = 1e-3


@dataclasses.dataclass
class DiscriminatorState:
    """The discriminator and its Adam."""

    model: nn.Module
    opt: torch.optim.Adam


def create_discriminator_state(disc: nn.Module, device=torch.device("cuda")
                               ) -> DiscriminatorState:
    """``disc`` on ``device`` (in ``channels_last`` on a card) and Adam(``D_LR``,
    betas 0.9/0.99, eps 1e-8), AdaptSegNet's convention."""
    device = torch.device(device)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    disc.to(device=device, memory_format=fmt).train()
    opt = torch.optim.Adam(disc.parameters(), lr=D_LR, betas=(0.9, 0.99), eps=1e-8)
    return DiscriminatorState(disc, opt)


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


@contextlib.contextmanager
def _no_grad_for(params: List[nn.Parameter]):
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


class AdversarialWarmupStep:
    """``step(state, d_state, batch) -> metrics`` {loss_seg1, loss_seg2, loss_adv, lr},
    updating both states in place. ``batch`` as the warmup step's, without a leading
    ``iter_size`` axis (the JAX step takes one sub-batch).

    ``spans``: None (default) or a list to which each call appends ``(name, start,
    end)`` CUDA events around its parts (forward, backward, optimizer, discriminator);
    under a profiler each part is also a range (``utils/spans.py``).
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.spans: Optional[Events] = None

    def __call__(self, st: WarmupState, d: DiscriminatorState,
                 batch: Dict) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        ignore = cfg.ignore_label
        dev = next(st.model.parameters()).device
        lr = poly_lr(cfg.optim.learning_rate, st.step, cfg.optim.num_steps, cfg.optim.power)
        for group in st.model_opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        image = normalize_image(torch.as_tensor(batch["image"], device=dev),
                                cfg.data.mean_bgr)
        label = normalize_label(torch.as_tensor(batch["label"], device=dev))
        hw = tuple(image.shape[1:3])
        classes = torch.arange(cfg.model.num_classes, device=dev)
        # Ignored pixels become class 0; a label outside the classes, all zeros
        # (jax.nn.one_hot).
        onehot = (torch.where(label == ignore, 0, label)[..., None] == classes).float()

        st.model_opt.zero_grad(set_to_none=True)
        with _no_grad_for(list(d.model.parameters())):
            with span("forward", self.spans):
                ys = st.model(image.permute(0, 3, 1, 2))
                x1, x2 = ys if isinstance(ys, tuple) else (ys, ys)
                p1 = upsample_bilinear_align_corners(x1.permute(0, 2, 3, 1), hw)
                p2 = upsample_bilinear_align_corners(x2.permute(0, 2, 3, 1), hw)
                l1 = cross_entropy_2d(p1, label, ignore_label=ignore)
                l2 = cross_entropy_2d(p2, label, ignore_label=ignore)
                prob2 = torch.softmax(p2, dim=-1)
                adv = _bce(d.model(prob2.permute(0, 3, 1, 2)), 1.0)  # fool D: "real"
                loss = l2 + cfg.simt.lambda_seg * l1 + LAMBDA_ADV * adv
            with span("backward", self.spans):
                loss.backward()
        with span("optimizer", self.spans):
            st.model_opt.step()

        with span("discriminator", self.spans):
            d.opt.zero_grad(set_to_none=True)
            real = d.model(onehot.permute(0, 3, 1, 2))
            fake = d.model(prob2.detach().permute(0, 3, 1, 2))
            (_bce(real, 1.0) + _bce(fake, 0.0)).backward()
            d.opt.step()
        st.step += 1
        return {"loss_seg1": l1.detach(), "loss_seg2": l2.detach(),
                "loss_adv": adv.detach(), "lr": torch.tensor(lr)}


def make_adversarial_warmup_step(cfg) -> AdversarialWarmupStep:
    """The adversarial warmup step for ``cfg`` (a ``TrainConfig``)."""
    return AdversarialWarmupStep(cfg)
