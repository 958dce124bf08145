"""Train state and the reference's optimizer families (counterpart of
``simt_tpu/train/state.py``).

  - model: ``torch.optim.SGD`` (momentum 0.9, weight decay 5e-4, no Nesterov) over two
    groups, the backbone at 1x and the classifier heads at 10x the poly-decayed rate
    (model/deeplab_multi.py:235-237, trainV2_simt.py:296-297). In the SimT stage the
    stem, ``bn1``, ``layer1`` and ``layer2`` are frozen (deeplab_multi.py:203-209); the
    warmup stage trains them at 1x (``warmup=True``). Every BatchNorm's affine
    parameters (requires_grad=False in the reference) and the ASPP branches past
    ``aspp_effective_branches`` are frozen in both stages. DeepLab-VGG trains everything
    at 1x, its ``classifier`` included (deeplab_vgg.py:53-54); DeepLabv3 has its own
    groups (``param_label``). Frozen parameters get ``requires_grad=False`` and no
    optimizer.
  - NTM T1/T2 and W1/W2: four ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8, no weight
    decay; trainV2_simt.py:270-280).

The learning rate follows the *outer* iteration (trainV2_simt.py:315,321-324) though W's
Adam steps ``inner_w_steps`` times per iteration, so the step sets each group's lr from
``poly_lr`` explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

LABEL_1X = "backbone_1x"
LABEL_10X = "head_10x"
LABEL_FROZEN = "frozen"

_HEADS = ("layer5", "layer6", "layer5_1", "layer6_1")
_STEM = ("conv1", "bn1", "layer1", "layer2")  # trained in the warmup stage only


def param_label_v3(name: str) -> str:
    """LR group of one DeepLabv3 parameter (deeplabv3.py:140-166; JAX
    ``param_label_v3``): ``layer3`` at 1x, the ASPP ``assp`` and the classifiers
    ``conv`` / ``conv_1`` at 10x, the stem and layers 1-2 in no group (frozen).
    torchvision's BatchNorm affine parameters train inside the grouped modules."""
    top = name.split(".")[0]
    if top in ("assp", "conv", "conv_1"):
        return LABEL_10X
    return LABEL_1X if top == "layer3" else LABEL_FROZEN


def param_label(name: str, *, warmup: bool = False, aspp_effective_branches: int = 2,
                arch: str = "deeplab_multi") -> str:
    """LR group of one parameter, by its ``named_parameters`` name, in the SimT stage
    or (``warmup``) the warmup stage: the rules of the JAX package's ``param_label``
    (simt_tpu/train/state.py:60-92) on the reference's module names."""
    if arch == "deeplabv3":
        return param_label_v3(name)
    parts = name.split(".")
    mods = parts[:-1]
    if mods and (mods[-1].startswith("bn") or mods[-2:] == ["downsample", "1"]):
        return LABEL_FROZEN  # BatchNorm affine
    # Branches past the summed ones get no gradient in the reference, so no update.
    if (len(mods) >= 2 and mods[-2] == "conv2d_list"
            and int(mods[-1]) >= aspp_effective_branches):
        return LABEL_FROZEN
    if parts[0] in _HEADS:
        return LABEL_10X
    if parts[0] == "classifier":
        return LABEL_1X  # DeeplabVGG's one base-LR group (deeplab_vgg.py:53-54)
    if parts[0] in _STEM:
        return LABEL_1X if warmup else LABEL_FROZEN
    return LABEL_1X  # layer3 / layer4 (and VGG's features)


def param_groups(model: nn.Module, *, warmup: bool = False,
                 aspp_effective_branches: int = 2,
                 arch: str = "deeplab_multi") -> Dict[str, List[nn.Parameter]]:
    """The model's parameters listed by ``param_label``, in ``named_parameters`` order."""
    groups: Dict[str, List[nn.Parameter]] = {LABEL_1X: [], LABEL_10X: [], LABEL_FROZEN: []}
    for name, p in model.named_parameters():
        groups[param_label(name, warmup=warmup, arch=arch,
                           aspp_effective_branches=aspp_effective_branches)].append(p)
    return groups


def make_model_optimizer(model: nn.Module, momentum: float, weight_decay: float, *,
                         warmup: bool = False, aspp_effective_branches: int = 2,
                         arch: str = "deeplab_multi") -> torch.optim.SGD:
    """SGD over the 1x and 10x groups (``param_groups[i]["lr_mult"]`` 1 and 10) of the
    SimT stage or (``warmup``) the warmup stage; frozen parameters are set
    ``requires_grad=False``. The caller sets each group's ``lr``."""
    groups = param_groups(model, warmup=warmup, arch=arch,
                          aspp_effective_branches=aspp_effective_branches)
    for p in groups[LABEL_FROZEN]:
        p.requires_grad_(False)
    return torch.optim.SGD(
        [{"params": groups[LABEL_1X], "lr_mult": 1.0},
         {"params": groups[LABEL_10X], "lr_mult": 10.0}],
        lr=0.0, momentum=momentum, weight_decay=weight_decay, nesterov=False)


def make_adam(param: torch.Tensor) -> torch.optim.Adam:
    """torch Adam (the reference's, trainV2_simt.py:270-280); the step sets its lr."""
    return torch.optim.Adam([param], lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


@dataclasses.dataclass
class NTMState:
    """One NTM/W parameter and its Adam optimizer."""

    param: nn.Parameter
    opt: torch.optim.Adam


@dataclasses.dataclass
class WarmupState:
    """What a warmup step reads and updates; ``step`` is a host integer."""

    model: nn.Module
    model_opt: torch.optim.SGD
    step: int = 0


@dataclasses.dataclass
class SimTState:
    """Everything a SimT step reads and updates. ``step`` (the outer iteration) is a
    host integer, so setting the poly learning rate never waits for the card."""

    model: nn.Module
    model_opt: torch.optim.SGD
    teacher: nn.Module  # frozen warmup network (trainV2_simt.py:260-267)
    t1: NTMState
    t2: NTMState
    w1: NTMState
    w2: NTMState
    class_dist: torch.Tensor
    step: int = 0
