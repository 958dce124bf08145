"""The trainable region of the SimT student in one call against its stages run alone
(counterpart of the JAX package's ``tools/profile_trunk.py``).

    python -m simt_tpu_torch.tools.profile_trunk [--n 5]
    python -m simt_tpu_torch.tools.profile_trunk --device cpu --layers 1,1,1,1 --hw 64,128

``Trunk34``: layer3, the layer5 head, layer4 and the layer6 head of
``profile_model``'s student (34-channel heads, known and open together), on the
activation that layer3 takes at the train geometry (1 x 512 x 65 x 129 bf16 for a
512x1024 crop; the JAX tool's 64x128 is its TPU model's floor-mode pool). Its forward
and its forward and backward of sum(x1^2) + sum(x2^2) for every trained parameter,
against the sum of the same four stages' rows (``profile_model``'s, the same model and
inputs, timed in this call): wall and device ms a call (``timing.time_rows``) and the
busy share. On the CPU the device numbers are not measured. Prints a table, the sums,
then one JSON line last.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from . import profile_model
from .bench import RESNET101, TRAIN_HW
from .profile_step import geometry_args, ints
from .timing import card, time_rows

PARTS = ("layer3", "layer5", "layer4", "layer6")


class Trunk34(nn.Module):
    """layer3 + the layer5 head + layer4 + the layer6 head of a student (the region the
    SimT stage trains), in the student's autocast dtype."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.dtype = model.dtype
        self.layer3, self.layer4 = model.layer3, model.layer4
        self.head5 = profile_model.heads(model.layer5, model.layer5_1)
        self.head6 = profile_model.heads(model.layer6, model.layer6_1)
        self.heads = nn.ModuleList([model.layer5, model.layer5_1, model.layer6,
                                    model.layer6_1])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = self.layer3(x)
            x1 = self.head5(x)
            x2 = self.head6(self.layer4(x))
        return x1.float(), x2.float()


def setup(dev: torch.device, hw: Tuple[int, int] = TRAIN_HW,
          layers: Sequence[int] = RESNET101) -> SimpleNamespace:
    """``profile_model.setup``'s student and inputs, ``trunk`` over it and ``rows``:
    "trunk34 fwd", "trunk34 fwd+bwd" and the fwd and fwd+bwd rows of PARTS."""
    stages = profile_model.setup(dev, hw, layers)
    trunk = Trunk34(stages.model)
    rows = profile_model.rows_for("trunk34", trunk, trunk, stages.inputs["layer3"],
                                  stages.dtype)
    for part in PARTS:
        for kind in ("fwd", "fwd+bwd"):
            rows[f"{part} {kind}"] = stages.rows[f"{part} {kind}"]
    return SimpleNamespace(trunk=trunk, rows=rows)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="layer3 + heads + layer4 in one call against "
                                            "the stages alone")
    geometry_args(p)
    return p


def run(args, print_fn=print) -> dict:
    dev = resolve_device(args.device)
    hw, layers = ints(args.hw), ints(args.layers)
    rows = time_rows(setup(dev, hw, layers).rows, args.n, dev)
    info = card(dev)
    profile_model.table(f"Trunk34 against its stages, {hw[0]}x{hw[1]}, layers {layers}, "
                        f"{args.n} calls a row, {info['card']} "
                        f"({info['power_limit_w']} W):", rows, print_fn)
    sums = {}
    for kind in ("fwd", "fwd+bwd"):
        one = rows[f"trunk34 {kind}"]
        for key in ("wall_ms", "device_ms"):
            parts = [rows[f"{p} {kind}"][key] for p in PARTS]
            total = None if None in parts else sum(parts)
            sums[f"{kind} {key}"] = {"trunk34": one[key], "stages": total}
            if total is not None:
                print_fn(f"  trunk34 {kind} {key}: one call {one[key]:.3f}, the four "
                         f"stages alone {total:.3f} ({one[key] / total:.3f}x)")
    return {"metric": f"trunk34_{hw[0]}x{hw[1]}", "rows": rows, "sums": sums, **info}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
