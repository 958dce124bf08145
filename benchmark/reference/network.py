"""Plain DeepLabv2-ResNet-101 with two ASPP heads (AdaptSegNet's ``deeplab_multi``, as
SimT's ``model/deeplab_multi.py``), written from the published model in plain PyTorch
over a flat dict of named tensors. Nothing here imports the port.

- stem: 7x7/2 conv (no bias), BatchNorm, ReLU, 3x3/2 pad-1 ceil-mode max pool;
- four stages of bottlenecks (3, 4, 23, 3 at full depth), the stride on the first 1x1
  conv, dilation 2 in layer3 and 4 in layer4, output stride 8; the first block of each
  stage has a projection (a channel change or a dilated stage);
- ``layer5`` (ASPP on layer3's 1024 channels) and ``layer6`` (on layer4's 2048): four
  3x3 convs with bias at dilations 6/12/18/24, of which the first two are summed (the
  reference's early return in ``Classifier_Module.forward``); with ``openset`` the
  open-set heads ``layer5_1`` / ``layer6_1`` are concatenated on channels.

Names are the published checkpoints' (``conv1.weight``, ``layer3.4.bn2.running_var``,
``layer6.conv2d_list.1.bias``, ...). BatchNorm in training mode normalises with the
batch's statistics and has no side effect (the running statistics do not enter a
training step's losses or gradients); in eval mode with the running ones.

``precision``: "fp32" (IEEE float32; the caller turns TF32 off); "fp8", the
benchmark's control, which has to come out not correct: every convolution as fp8
training computes it (``_Fp8Conv``); or "bf16", a witness: every convolution in bf16,
forward and backward, as the configuration's autocast runs it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ASPP_DILATIONS = (6, 12, 18, 24)
PLANES = (64, 128, 256, 512)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)


def param_spec(num_classes: int, open_classes: int, openset: bool,
               layers: Sequence[int]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model, in a fixed order; ``kind`` is
    "conv_w", "conv_b", "bn_w", "bn_b", "bn_mean", "bn_var" or "bn_count"."""
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def bn(name: str, c: int) -> None:
        spec.extend([(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
                     (f"{name}.running_mean", (c,), "bn_mean"),
                     (f"{name}.running_var", (c,), "bn_var"),
                     (f"{name}.num_batches_tracked", (), "bn_count")])

    spec.append(("conv1.weight", (64, 3, 7, 7), "conv_w"))
    bn("bn1", 64)
    inplanes = 64
    for si, (planes, blocks) in enumerate(zip(PLANES, layers)):
        for bi in range(blocks):
            pre = f"layer{si + 1}.{bi}"
            cin = inplanes if bi == 0 else planes * 4
            spec.append((f"{pre}.conv1.weight", (planes, cin, 1, 1), "conv_w"))
            bn(f"{pre}.bn1", planes)
            spec.append((f"{pre}.conv2.weight", (planes, planes, 3, 3), "conv_w"))
            bn(f"{pre}.bn2", planes)
            spec.append((f"{pre}.conv3.weight", (planes * 4, planes, 1, 1), "conv_w"))
            bn(f"{pre}.bn3", planes * 4)
            if bi == 0:
                spec.append((f"{pre}.downsample.0.weight", (planes * 4, cin, 1, 1),
                             "conv_w"))
                bn(f"{pre}.downsample.1", planes * 4)
        inplanes = planes * 4
    heads = [("layer5", 1024, num_classes), ("layer6", 2048, num_classes)]
    if openset:
        heads += [("layer5_1", 1024, open_classes), ("layer6_1", 2048, open_classes)]
    for name, cin, cout in heads:
        for i in range(len(ASPP_DILATIONS)):
            spec.append((f"{name}.conv2d_list.{i}.weight", (cout, cin, 3, 3), "conv_w"))
            spec.append((f"{name}.conv2d_list.{i}.bias", (cout,), "conv_b"))
    return spec


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` at a per-tensor scale (its amax to the
    format's largest value), back in ``x``'s dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


class _Fp8Conv(torch.autograd.Function):
    """A convolution computed as fp8 training computes it: the forward's operands in
    e4m3, the backward's incoming gradient in e5m2, each at a per-tensor scale, products
    summed in float32; the output and the input gradient stored in bf16, as the
    configuration's activations are."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, dilation, b is not None)
        return _bf16(F.conv2d(xq, wq, b, stride, padding, dilation))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, has_b = ctx.conf
        gq = _fp8(g, torch.float8_e5m2)
        dx = _bf16(torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding, dilation))
        dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding, dilation)
        return dx, dw, g.sum((0, 2, 3)) if has_b else None, None, None, None


def conv(x, w, b=None, stride=1, padding=0, dilation=1, precision="fp32"):
    if precision == "fp32":
        return F.conv2d(x, w, b, stride, padding, dilation)
    if precision == "bf16":  # a witness: bf16 operands, output and gradients
        b = None if b is None else b.bfloat16()
        return F.conv2d(x.bfloat16(), w.bfloat16(), b, stride, padding, dilation).float()
    if precision == "fp8":
        return _Fp8Conv.apply(x, w, b, stride, padding, dilation)
    raise ValueError(f"unknown precision {precision!r}")


def batch_norm(P: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
               train: bool) -> torch.Tensor:
    if train:
        return F.batch_norm(x, None, None, P[f"{name}.weight"], P[f"{name}.bias"], True,
                            0.0, 1e-5)
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], False, 0.0, 1e-5)


def _bottleneck(P, pre, x, stride, dilation, project, train, precision):
    out = F.relu(batch_norm(P, f"{pre}.bn1", conv(x, P[f"{pre}.conv1.weight"], None,
                                                 stride, precision=precision), train))
    out = F.relu(batch_norm(P, f"{pre}.bn2", conv(out, P[f"{pre}.conv2.weight"], None, 1,
                                                 dilation, dilation, precision), train))
    out = batch_norm(P, f"{pre}.bn3", conv(out, P[f"{pre}.conv3.weight"],
                                           precision=precision), train)
    if project:
        x = batch_norm(P, f"{pre}.downsample.1",
                       conv(x, P[f"{pre}.downsample.0.weight"], None, stride,
                            precision=precision), train)
    return F.relu(out + x)


def _aspp(P, name, x, branches, precision):
    out = None
    for i in range(branches):
        d = ASPP_DILATIONS[i]
        y = conv(x, P[f"{name}.conv2d_list.{i}.weight"], P[f"{name}.conv2d_list.{i}.bias"],
                 1, d, d, precision)
        out = y if out is None else out + y
    return out


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor, *, layers: Sequence[int],
            openset: bool, train: bool, precision: str = "fp32", branches: int = 2,
            taps: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x1, x2): the stride-8 logits of the layer3 and layer4 heads, NCHW, of a
    mean-subtracted BGR NCHW float32 batch ``x``. Where ``x`` needs a gradient, each
    bottleneck is recomputed in the backward (the same values; the memory of a batch of
    16 crops). ``taps``: a dict
    that takes the stem's and each stage's output (``tap``)."""
    x = conv(x, P["conv1.weight"], None, 2, 3, precision=precision)
    x = F.relu(batch_norm(P, "bn1", x, train))
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
    tap(taps, "stem", x)
    x1 = None
    for si, blocks in enumerate(layers):
        for bi in range(blocks):
            args = (P, f"layer{si + 1}.{bi}", x, STRIDES[si] if bi == 0 else 1,
                    DILATIONS[si], bi == 0, train, precision)
            if x.requires_grad:
                x = checkpoint(_bottleneck, *args, use_reentrant=False)
            else:
                x = _bottleneck(*args)
        tap(taps, f"layer{si + 1}", x)
        if si == 2:
            x1 = _aspp(P, "layer5", x, branches, precision)
            if openset:
                x1 = torch.cat([x1, _aspp(P, "layer5_1", x, branches, precision)], 1)
    x2 = _aspp(P, "layer6", x, branches, precision)
    if openset:
        x2 = torch.cat([x2, _aspp(P, "layer6_1", x, branches, precision)], 1)
    return x1, x2


TAP_IMAGES = 2  # the images of a batch whose activations a tap keeps


def tap(taps: Optional[dict], name: str, x: torch.Tensor) -> None:
    """Keep the first TAP_IMAGES images of ``x`` in ``taps[name]``, float32 on the
    host (the first value only)."""
    if taps is not None and name not in taps:
        taps[name] = x[:TAP_IMAGES].detach().float().cpu()


def trainable(name: str, *, stage: str, branches: int = 2) -> str:
    """"frozen", "1x" or "10x": the learning-rate group of a tensor in ``stage``
    ("simt" or "warmup"). BatchNorm's tensors are frozen (``requires_grad=False`` in the
    reference); so are the ASPP branches past the summed ones, which get no gradient.
    The SimT stage freezes the stem and layers 1-2 (``get_1x_lr_params_NOscale`` of
    ``deeplab_multi.py`` starts at layer3); the heads train at 10x the rate."""
    parts = name.split(".")
    mods = parts[:-1]
    if parts[-1] in ("running_mean", "running_var", "num_batches_tracked"):
        return "frozen"
    if mods and (mods[-1].startswith("bn") or mods[-2:] == ["downsample", "1"]):
        return "frozen"
    if len(mods) >= 2 and mods[-2] == "conv2d_list" and int(mods[-1]) >= branches:
        return "frozen"
    if parts[0] in ("layer5", "layer6", "layer5_1", "layer6_1"):
        return "10x"
    if parts[0] in ("conv1", "bn1", "layer1", "layer2") and stage == "simt":
        return "frozen"
    return "1x"
