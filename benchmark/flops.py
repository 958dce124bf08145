"""The FLOPs of a configuration's work an image, in closed form over the network's
convolutions: 2 * C_in * C_out * k^2 * H_out * W_out a forward, as much again for the
input gradient where the input depends on a trained tensor and for the weight gradient
where the weight trains. The same whatever implements the convolutions.

It counts the model's convolutions alone: the students' forward and backward and, in
the SimT stage, the teacher's forward; in evaluation the student's forward at each
scale (both heads: the model computes them). The losses' and the eval head's
interpolations and the W loop's 34 x 34 products are left out (about 1.5% of a SimT
step as dense matmuls; ``PERF.md`` gives the comparison with the port's counter).

    python -m benchmark.flops <config>    prints the counts at the cells' geometries
"""

from __future__ import annotations

import json
import sys
from typing import List, Sequence, Tuple

from .inputs import stage_geometry
from .reference.network import ASPP_DILATIONS, PLANES, trainable

Conv = Tuple[str, int, int, int, int, int, bool]  # name, C_in, C_out, k, H, W, dx


def convs(model: dict, hw: Sequence[int], openset: bool, stage: str) -> List[Conv]:
    """Every convolution the forward runs, in order, with its output size and whether
    its input depends on a tensor ``stage`` trains (so the backward computes dx)."""
    layers = model["layers"]
    geo = stage_geometry(hw, layers)
    stem = ((hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)
    out: List[Conv] = [("conv1.weight", 3, 64, 7, *stem, False)]

    def trains(name: str) -> bool:
        return trainable(name, stage=stage) != "frozen"

    grad = trains("conv1.weight")  # whether the current activation depends on one
    cin = 64
    for si, ((h, w), planes, blocks) in enumerate(zip(geo, PLANES, layers)):
        for bi in range(blocks):
            pre = f"layer{si + 1}.{bi}"
            c_in = cin if bi == 0 else planes * 4
            g1 = grad or trains(f"{pre}.conv1.weight")
            g2 = g1 or trains(f"{pre}.conv2.weight")
            out += [(f"{pre}.conv1.weight", c_in, planes, 1, h, w, grad),
                    (f"{pre}.conv2.weight", planes, planes, 3, h, w, g1),
                    (f"{pre}.conv3.weight", planes, planes * 4, 1, h, w, g2)]
            g3 = g2 or trains(f"{pre}.conv3.weight")
            if bi == 0:
                out.append((f"{pre}.downsample.0.weight", c_in, planes * 4, 1, h, w, grad))
                g3 = g3 or trains(f"{pre}.downsample.0.weight")
            grad = g3
        cin = planes * 4
        if si in (2, 3):
            heads = ("layer5", "layer5_1") if si == 2 else ("layer6", "layer6_1")
            for head, classes in zip(heads, (model["num_classes"], model["open_classes"])):
                if head.endswith("_1") and not openset:
                    continue
                for i in range(min(model["aspp_effective_branches"], len(ASPP_DILATIONS))):
                    out.append((f"{head}.conv2d_list.{i}.weight", cin, classes, 3, h, w,
                                grad))
    return out


def forward_flops(cs: List[Conv]) -> int:
    return sum(2 * ci * co * k * k * h * w for _, ci, co, k, h, w, _ in cs)


def backward_flops(cs: List[Conv], stage: str) -> int:
    total = 0
    for name, ci, co, k, h, w, dx in cs:
        f = 2 * ci * co * k * k * h * w
        total += f * dx + f * (trainable(name, stage=stage) != "frozen")
    return total


def per_image(cfg: dict, mix_hw=None, scales=None) -> dict:
    """{"train": FLOPs of one image's train step at ``mix_hw``, "eval": of one image's
    forwards at every scale of ``scales``} (a key only where its geometry is given)."""
    model, stage = cfg["model"], cfg["stage"]
    out = {}
    if mix_hw is not None:
        student = convs(model, mix_hw, model["openset"], stage)
        n = forward_flops(student) + backward_flops(student, stage)
        if stage == "simt":
            n += forward_flops(convs(model, mix_hw, False, stage))
        out["train"] = n
    if scales is not None:
        out["eval"] = sum(forward_flops(convs(model, hw, model["openset"], stage))
                          for hw in scales)
    return out


def main(argv=None) -> None:
    from .harness import HERE, load_json

    args = sys.argv[1:] if argv is None else argv
    cfg = load_json(f"{HERE}/configs/{args[0]}.json")
    train = load_json(f"{HERE}/mixes/train_b16.json")
    ev = load_json(f"{HERE}/mixes/eval_b8.json")
    print(json.dumps(per_image(cfg, train["hw"], ev["scales"] if cfg["stage"] == "simt"
                               else None)))


if __name__ == "__main__":
    main()
