"""Everything a run feeds both sides, made on the device from ``--seed``: the weights
(one draw for all conv weights of a model), and the traffic's pool of batches (images
and region labels), by the one generator every traffic mix's parameters drive.

The same seed gives the same tensors on the same device. Each draw has a generator of
its own, seeded by ``sub_seed(seed, what)``, so adding a draw moves no other.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .reference.network import param_spec

INIT_STD = 0.01  # conv weights ~ N(0, 0.01), biases 0 (deeplab_multi.py's init)


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the draw named ``what`` of run ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def model_weights(seed: int, what: str, model: dict, device,
                  openset: bool) -> Dict[str, torch.Tensor]:
    """The tensors of one model (``network.param_spec`` of ``model``'s sizes) in
    float32: every conv weight from one normal draw at INIT_STD, conv biases 0,
    BatchNorm weight 1, bias 0, running mean 0, variance 1."""
    spec = param_spec(model["num_classes"], model["open_classes"], openset,
                      model["layers"])
    sizes = [math.prod(shape) for _, shape, kind in spec if kind == "conv_w"]
    flat = torch.randn(sum(sizes), generator=generator(seed, what, device),
                       device=device) * INIT_STD
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "conv_w":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind in ("bn_w", "bn_var") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def ntm_params(seed: int, model: dict, device) -> Dict[str, torch.Tensor]:
    """T1 / T2 (kaiming-normal, fan-out, std sqrt(2 / (C+O))) and W1 / W2 (the constant
    1 / (C+O-1)) of the SimT stage's noise transition matrices."""
    c, o = model["num_classes"], model["open_classes"]
    total = c + o
    g = generator(seed, "ntm", device)
    t = torch.randn((2, total, c), generator=g, device=device) * math.sqrt(2.0 / total)
    w = torch.full((total, total), 1.0 / (total - 1.0), device=device)
    return {"t1": t[0].clone(), "t2": t[1].clone(), "w1": w.clone(), "w2": w.clone()}


def smooth_field(g: torch.Generator, n: int, channels: int, hw: Tuple[int, int],
                 stride: int, device) -> torch.Tensor:
    """(n, channels, H, W) float32: a normal draw on a grid of ``stride`` pixels,
    upsampled bilinearly, so that neighbouring pixels agree as in a photograph."""
    h, w = hw
    coarse = torch.randn((n, channels, -(-h // stride) + 1, -(-w // stride) + 1),
                         generator=g, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)


def region_labels(g: torch.Generator, n: int, hw: Tuple[int, int], num_classes: int,
                  stride: int, ignore_share: float, device) -> torch.Tensor:
    """(n, H, W) uint8 labels in contiguous regions, as pseudo-labels and ground truth
    come: the argmax over classes of a smooth field, with ``ignore_share`` of each
    image's pixels set to 255 in blobs (where a second smooth field is lowest)."""
    lab = torch.empty((n, *hw), dtype=torch.uint8, device=device)
    for i in range(n):  # one image at a time: a (C, H, W) field, not a batch of them
        lab[i] = smooth_field(g, 1, num_classes, hw, stride, device)[0].argmax(0)
        ign = smooth_field(g, 1, 1, hw, stride, device)[0, 0]
        k = max(1, round(ignore_share * ign.numel()))
        cut = torch.kthvalue(ign.flatten(), k).values
        lab[i][ign <= cut] = 255
    return lab


def images(g: torch.Generator, n: int, hw: Tuple[int, int], device) -> torch.Tensor:
    """(n, H, W, 3) uint8 BGR images: smooth colour fields with fine noise over them."""
    field = smooth_field(g, n, 3, hw, 16, device) * 45.0 + 120.0
    field = field + torch.randn(field.shape, generator=g, device=device) * 12.0
    return field.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def resize_images(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(n, H, W, 3) uint8 resized bilinearly (with antialiasing) to ``hw``."""
    x = img.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def train_pool(seed: int, mix: dict, num_classes: int, device) -> List[dict]:
    """The mix's ``pool`` distinct training batches: ``image`` (B, H, W, 3) uint8 and
    ``label`` (B, H, W) uint8 region pseudo-labels with 255 ignore."""
    g = generator(seed, "train_pool", device)
    b, hw, lab = mix["batch"], tuple(mix["hw"]), mix["labels"]
    return [{"image": images(g, b, hw, device),
             "label": region_labels(g, b, hw, num_classes, lab["stride"],
                                    lab["ignore_share"], device)}
            for _ in range(mix["pool"])]


def eval_pool(seed: int, mix: dict, num_classes: int, device) -> List[dict]:
    """The mix's ``pool`` distinct eval batches: each image made at the ground truth's
    size and resized to every scale of ``scales`` (the host's resize is not in the
    window), and uint8 region ground truth at ``out_hw`` with 255 ignore."""
    g = generator(seed, "eval_pool", device)
    b, out_hw, lab = mix["batch"], tuple(mix["out_hw"]), mix["labels"]
    pool = []
    for _ in range(mix["pool"]):
        full = images(g, b, out_hw, device)
        pool.append({"scales": [resize_images(full, hw) for hw in mix["scales"]],
                     "gt": region_labels(g, b, out_hw, num_classes, lab["stride"],
                                         lab["ignore_share"], device)})
        del full
    return pool


def counted(labels: torch.Tensor, num_classes: int) -> int:
    """Pixels whose label is a class (not ignore)."""
    return int((labels < num_classes).sum())


def stage_geometry(hw: Sequence[int], layers: Sequence[int]) -> List[Tuple[int, int]]:
    """(H, W) of each stage's 3x3 convolutions for an input of ``hw``: the stem's 7x7/2
    pad 3 and the ceil-mode 3x3/2 pad 1 pool, layer2's stride 2, then stride 1."""
    h, w = hw
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    h, w = -(-(h - 1) // 2) + 1, -(-(w - 1) // 2) + 1
    out = []
    for si in range(len(layers)):
        if si == 1:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out.append((h, w))
    return out
