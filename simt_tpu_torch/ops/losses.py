"""Segmentation / SimT loss functions (counterpart of ``simt_tpu/ops/losses.py``).

  - masked 2-D cross entropy (reference utils/loss.py:6-40), on logits and on
    already-normalised probabilities (the noisy-posterior loss);
  - entropy loss (utils/loss.py:42-49);
  - the open-set placeholder loss (tools/trainV2_simt.py:202-230);
  - the NTM volume regulariser log sqrt |det(T^T T)| (trainV2_simt.py:417-421) and its
    non-finite -> 0 guard; ``mse_sum``.

Layout as in the JAX package: logits NHWC (..., C), labels (...) integer. The train
step uses ``mse_sum`` and ``volume_loss``; the others are the unfused forms the tests
hold the streamed loss block against.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed import ProcessGroup

from ..parallel.mesh import all_reduce_


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 group: Optional[ProcessGroup] = None) -> torch.Tensor:
    """Mean of ``values`` over the float ``mask``; 0 when the mask is empty. (The
    reference's ``CrossEntropyLoss(ignore_index=255)`` gives NaN on an all-ignored
    batch; 0 keeps the step finite, as in the JAX package.) With a data ``group``, the
    local sum over the count summed across its ranks: the ranks' results sum to the
    global batch's mean."""
    count = all_reduce_(mask.sum(), group)
    total = (values * mask).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       torch.zeros_like(total))


def _valid_and_safe(labels: torch.Tensor, ignore_label: int):
    valid = (labels >= 0) & (labels != ignore_label)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    return valid, safe


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor, *,
                     ignore_label: int = 255,
                     class_weight: Optional[torch.Tensor] = None,
                     group: Optional[ProcessGroup] = None) -> torch.Tensor:
    """Masked softmax cross entropy, mean over valid pixels
    (``CrossEntropyLoss(ignore_index=255)``, trainV2_simt.py:303). ``group``: this
    rank's share of the mean over the data group's global batch (``_masked_mean``;
    not with ``class_weight``)."""
    logits = logits.float()
    valid, safe = _valid_and_safe(labels, ignore_label)
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, safe[..., None])[..., 0]
    vf = valid.to(nll.dtype)
    if class_weight is not None:
        w = class_weight[safe]
        # torch's weighted CE divides by the sum of the valid targets' weights.
        return (_masked_mean(nll * w, vf) * vf.sum()
                / torch.clamp((w * vf).sum(), min=1.0))
    return _masked_mean(nll, vf, group)


def nll_from_probs_2d(probs: torch.Tensor, labels: torch.Tensor, *,
                      ignore_label: int = 255, eps: float = 0.0) -> torch.Tensor:
    """``log`` + NLL on already-normalised probabilities, mean over valid pixels
    (``CrossEntropy2d(is_softmax=False)``, utils/loss.py:38-39), in float32."""
    probs = probs.float()
    valid, safe = _valid_and_safe(labels, ignore_label)
    p = torch.gather(probs, -1, safe[..., None])[..., 0]
    return _masked_mean(-torch.log(p + eps), valid.to(probs.dtype))


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel Shannon entropy of the channel softmax (utils/loss.py:42-49)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-(logp.exp() * logp).sum(dim=-1)).mean()


def placeholder_loss(logits: torch.Tensor, *, num_classes: int, open_classes: int,
                     lambda_place: float, threshold: Optional[float] = None,
                     ignore_label: int = 255, suppress_value: float = 0.0) -> torch.Tensor:
    """Open-set placeholder supervision (tools/trainV2_simt.py:202-230), logits
    (B, H, W, C+O).

    Known part: CE against the per-pixel argmax where it is a known class (and the
    softmax max exceeds ``threshold``). Unknown part: the argmax channel set to
    ``suppress_value``; the label is the argmax over a tensor whose known channels are
    0, so a known channel wins when every open logit is negative (the reference's
    ``torch.zeros_like`` at :220); ignored where the known label is. The reference
    means -1000 but computes ``-1000. * torch.zeros_like(...)`` (:208-209): the argmax
    channel is 0 in every published run, the default here.
    """
    total = num_classes + open_classes
    logits32 = logits.float()
    pseudo = torch.argmax(logits32, dim=-1)
    channel = torch.arange(total, device=logits.device)
    onehot = channel == pseudo[..., None]
    predict = torch.where(onehot, torch.full_like(logits32, suppress_value), logits32)

    ignore = torch.full_like(pseudo, ignore_label)
    pseudo1 = torch.where(pseudo < num_classes, pseudo, ignore)
    if threshold is not None:
        pred_max = torch.softmax(logits32, dim=-1).amax(dim=-1)
        pseudo1 = torch.where(pred_max > threshold, pseudo1, ignore)
    loss_known = cross_entropy_2d(logits32, pseudo1, ignore_label=ignore_label)

    predict_open = torch.where(channel >= num_classes, predict,
                               torch.zeros_like(predict))
    place_y = torch.argmax(predict_open, dim=-1)
    place_y = torch.where(pseudo1 == ignore_label, ignore, place_y)
    loss_unknown = cross_entropy_2d(predict, place_y, ignore_label=ignore_label)
    return loss_known + lambda_place * loss_unknown


def volume_loss(t: torch.Tensor) -> torch.Tensor:
    """log sqrt |det(T^T T)| in float32 (trainV2_simt.py:417-421), as 0.5 log|det| from
    ``slogdet``: the same value, and finite for near-singular Gram matrices whose
    float32 determinant underflows. Callers sum both heads and apply
    :func:`finite_or_zero` (the reference guards the sum)."""
    t = t.float()
    _, logabsdet = torch.linalg.slogdet(t.T @ t)
    return 0.5 * logabsdet


def finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``isinf/isnan -> 0`` guard (trainV2_simt.py:420-421), without a
    host sync."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``MSELoss(reduction='sum')`` (trainV2_simt.py:305) in float32."""
    d = a.float() - b.float()
    return (d * d).sum()
