"""The SimT student's forward and forward+backward, one stage at a time, at the train
geometry (counterpart of the JAX package's ``tools/profile_model.py``).

    python -m simt_tpu_torch.tools.profile_model [--n 5]
    python -m simt_tpu_torch.tools.profile_model --device cpu --layers 1,1,1,1 --hw 64,128

The open-set DeepLabv2-ResNet-101 student (19 + 15 classes, seeded random weights,
train mode, bf16 autocast and channels_last on the card) on a synthetic 512x1024 batch,
cut into the stem + layer1, layer2, layer3, layer4 and the two ASPP heads, layer5 (on
layer3's 1024 channels) and layer6 (on layer4's 2048), known and open heads together.
Each stage runs on the activation the stages before it give that batch (129x257 into
layer1, 65x129 from layer2 on), conv2 of every bottleneck through
``ops/conv.py::dilated_conv3x3`` (B4/B5 on the card) as on the model's path. For each
stage, the forward (no gradient) and the forward and backward of sum(y^2) in float32
for every parameter the warmup stage trains (all of the stage's but BatchNorm's affine
and the ASPP branches past the summed two; the JAX tool takes every parameter of a
freshly initialised stage): wall and device ms a call (``timing.time_rows``: ``--n``
calls, the wall windows before the profiled ones) and the busy share. On the CPU the
device numbers are not measured. Prints a table, then one JSON line last.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import torch

from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..models import ResNetMulti, init_weights
from ..models.layers import bn_act
from .bench import RESNET101, TRAIN_HW, dtypes
from .profile_step import fmt, geometry_args, ints
from .timing import card, time_rows

STAGES = ("stem+layer1", "layer2", "layer3", "layer4", "layer5", "layer6")


def student(dev: torch.device, layers: Sequence[int], dtype: torch.dtype) -> ResNetMulti:
    """The open-set student (19 + 15 classes), seeded, in train mode on ``dev``."""
    model = init_weights(ResNetMulti(19, 15, True, layers=layers, dtype=dtype),
                         torch.Generator().manual_seed(0))
    fmt_ = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    return model.to(device=dev, memory_format=fmt_).train()


def heads(known, open_):
    """The known and open ASPP heads of one level, concatenated on channels."""
    return lambda x: torch.cat([known(x), open_(x)], dim=1)


def stage_fns(model: ResNetMulti) -> dict:
    """{stage: (module holding its parameters, its forward)}."""
    def stem1(x):
        return model.layer1(model.maxpool(bn_act(model.bn1, model.conv1(x))))

    stem = torch.nn.ModuleDict({"conv1": model.conv1, "bn1": model.bn1,
                                "layer1": model.layer1})
    return {"stem+layer1": (stem, stem1), "layer2": (model.layer2, model.layer2),
            "layer3": (model.layer3, model.layer3), "layer4": (model.layer4, model.layer4),
            "layer5": (torch.nn.ModuleList([model.layer5, model.layer5_1]),
                       heads(model.layer5, model.layer5_1)),
            "layer6": (torch.nn.ModuleList([model.layer6, model.layer6_1]),
                       heads(model.layer6, model.layer6_1))}


def rows_for(name: str, module: torch.nn.Module, forward, x: torch.Tensor,
             dtype: torch.dtype) -> dict:
    """{"<name> fwd": fn, "<name> fwd+bwd": fn} of one stage on the input ``x``; the
    backward takes a gradient for each of ``module``'s parameters that requires one
    (BatchNorm's affine is frozen; the ASPP branches past the summed two get none)."""
    params = [p for p in module.parameters() if p.requires_grad]
    autocast = torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32)

    def fwd():
        with torch.no_grad(), autocast:
            return forward(x)

    def fwdbwd():
        with autocast:
            y = forward(x)
        if isinstance(y, tuple):
            loss = sum((t.float() ** 2).sum() for t in y)
        else:
            loss = (y.float() ** 2).sum()
        return torch.autograd.grad(loss, params, allow_unused=True)

    return {f"{name} fwd": fwd, f"{name} fwd+bwd": fwdbwd}


def setup(dev: torch.device, hw: Tuple[int, int] = TRAIN_HW,
          layers: Sequence[int] = RESNET101) -> SimpleNamespace:
    """The student on ``dev`` (bf16 autocast on the card, float32 on the CPU) and each
    stage's input, from one forward of the synthetic batch: ``model``, ``inputs``
    ({stage: input}) and ``rows`` ({"<stage> fwd" / "<stage> fwd+bwd": fn})."""
    dtype = dtypes(dev)[1]
    model = student(dev, layers, dtype)
    raw = synthetic_batch(batch_size=1, hw=hw, num_classes=19, seed=0)
    x = torch.from_numpy(raw["image"]).to(dev).permute(0, 3, 1, 2)
    fns = stage_fns(model)
    inputs = {}
    with torch.no_grad(), torch.autocast(dev.type, dtype=dtype,
                                         enabled=dtype != torch.float32):
        for name in ("stem+layer1", "layer2", "layer3", "layer4"):
            inputs[name] = x
            x = fns[name][1](x)
            if name == "layer3":
                inputs["layer5"] = x
        inputs["layer6"] = x
    rows = {}
    for name in STAGES:
        rows.update(rows_for(name, *fns[name], inputs[name], dtype))
    return SimpleNamespace(model=model, inputs=inputs, rows=rows, dtype=dtype)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the student, one stage at a time: wall and "
                                            "device ms")
    geometry_args(p)
    return p


def table(title: str, rows: dict, print_fn=print) -> None:
    print_fn(title)
    print_fn(f"  {'row':36s} {'wall ms':>10s} {'device ms':>12s} {'launches':>9s} "
             f"{'busy':>6s}")
    for name, r in rows.items():
        print_fn(f"  {name:36s} {r['wall_ms']:10.3f} {fmt(r['device_ms']):>12s} "
                 f"{fmt(r['launches'], '.0f'):>9s} {fmt(r['busy']):>6s}")


def run(args, print_fn=print) -> dict:
    dev = resolve_device(args.device)
    hw, layers = ints(args.hw), ints(args.layers)
    parts = setup(dev, hw, layers)
    rows = time_rows(parts.rows, args.n, dev)
    info = card(dev)
    table(f"student stages, {hw[0]}x{hw[1]}, layers {layers}, {args.n} calls a row, "
          f"{info['card']} ({info['power_limit_w']} W):", rows, print_fn)
    return {"metric": f"student_stages_{hw[0]}x{hw[1]}", "rows": rows, **info}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
