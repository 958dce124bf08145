"""The fused eval-mode BatchNorm (simt_tpu_torch/ops/kernels/bn_act.py) and its dispatch
(``models/layers.py::bn_act``).

On the CPU the wrapper runs its plain version, held here to ``F.batch_norm`` in eval
mode followed by the add and the ReLU; the CUDA kernel is held to the plain version on
the card by chip_smoke.py. The models take the kernel only on a card, so on the CPU an
eval-mode ``Bottleneck`` and ``ResNetMulti`` must give the composition's outputs bit for
bit; with the kernel forced in (its plain version standing in), every BatchNorm of the
block goes through it with the right residual and ReLU.
"""

import pytest
import torch
import torch.nn.functional as F

from simt_tpu_torch.models import ResNetMulti, init_weights, layers
from simt_tpu_torch.ops.kernels import bn_act as kbn

CL = torch.channels_last


def _bn(c, seed, affine=True):
    g = torch.Generator().manual_seed(seed)
    bn = layers.frozen_bn(c) if affine else layers.BatchNorm2d(c, affine=False)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
        if affine:
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
    return bn.eval()


def _x(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=CL)


def _plain(bn, x, residual=None, relu=True):
    return kbn.bn_act_plain(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                            residual, relu)


@pytest.mark.parametrize("variant", ["relu", "add_relu", "alone"])
@pytest.mark.parametrize("affine", [True, False])
def test_plain_equals_eval_batch_norm_composition(variant, affine):
    bn = _bn(24, 1, affine)
    x = _x((2, 24, 5, 7), 2)
    r = _x((2, 24, 5, 7), 3) if variant == "add_relu" else None
    want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
                        0.0, bn.eps)
    if r is not None:
        want = want + r
    if variant != "alone":
        want = torch.relu(want)
    got = kbn.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                     residual=r, relu=variant != "alone")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert got.is_contiguous(memory_format=CL)


def test_plain_rounds_once_to_bf16_and_keeps_nan():
    bn = _bn(16, 4)
    x, r = _x((2, 16, 3, 5), 5), _x((2, 16, 3, 5), 6)
    x[0, 3, 1, 2] = float("nan")
    got = _plain(bn, x.to(torch.bfloat16), r.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = _plain(bn, x.to(torch.bfloat16).float(), r.to(torch.bfloat16).float())
    assert torch.equal(got.view(torch.int16), want.to(torch.bfloat16).view(torch.int16))
    assert torch.isnan(got[0, 3, 1, 2])


def test_wrapper_refuses_an_add_without_its_relu():
    bn = _bn(8, 7)
    x = _x((1, 8, 2, 2), 8)
    with pytest.raises(ValueError, match="ReLU"):
        kbn.bn_act(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                   residual=x, relu=False)


def _old_bottleneck(block, x):
    """``Bottleneck.forward`` as it composed the modules before ``bn_act``."""
    out = torch.relu_(block.bn1(block.conv1(x)))
    out = layers.dilated_conv3x3(out, block.conv2.weight.to(out.dtype), block.dilation)
    out = torch.relu_(block.bn2(out))
    out = block.bn3(block.conv3(out))
    residual = x if block.downsample is None else block.downsample(x)
    return torch.relu_(out + residual)


def _block(downsample, seed=0):
    torch.manual_seed(seed)
    block = layers.Bottleneck(32 if downsample else 64, 16, stride=2 if downsample else 1,
                              dilation=1 if downsample else 2, downsample=downsample)
    for i, bn in enumerate(m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.load_state_dict(_bn(bn.num_features, 10 + i).state_dict())
    return block.eval()


@pytest.mark.parametrize("downsample", [False, True])
def test_eval_bottleneck_on_the_cpu_is_the_composition(downsample):
    block = _block(downsample)
    x = _x((2, block.conv1.in_channels, 9, 11), 20)
    with torch.no_grad():
        assert torch.equal(block(x), _old_bottleneck(block, x))


def _old_resnet_multi(model, x):
    """``ResNetMulti.forward`` (float32, no rows) as it composed the modules before."""
    x = model.maxpool(torch.relu_(model.bn1(model.conv1(x))))
    for stage in (model.layer1, model.layer2, model.layer3):
        for block in stage:
            x = _old_bottleneck(block, x)
    x1 = model._head(x, model.layer5, model.layer5_1)
    for block in model.layer4:
        x = _old_bottleneck(block, x)
    return x1, model._head(x, model.layer6, model.layer6_1)


def test_eval_resnet_multi_on_the_cpu_is_the_composition():
    model = init_weights(ResNetMulti(5, 3, True, layers=(1, 1, 1, 1), dtype=torch.float32),
                         torch.Generator().manual_seed(0)).eval()
    for i, bn in enumerate(m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.load_state_dict(_bn(bn.num_features, 30 + i).state_dict())
    x = _x((1, 3, 32, 48), 40)
    with torch.no_grad():
        got, want = model(x), _old_resnet_multi(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on a card, to drive ``takes_kernel``."""

    @property
    def is_cuda(self):
        return True


def _card(shape, seed, dtype=torch.bfloat16, fmt=CL):
    return _x(shape, seed, dtype).contiguous(memory_format=fmt).as_subclass(_OnCard)


def test_takes_kernel_only_for_running_statistics_and_no_graph():
    bn = _bn(16, 50)
    x, r = _card((2, 16, 3, 4), 51), _card((2, 16, 3, 4), 52)
    assert layers.takes_kernel(bn, x) and layers.takes_kernel(bn, x, r)
    assert not layers.takes_kernel(bn.train(), x)  # batch statistics
    bn.eval()
    assert not layers.takes_kernel(bn, x.detach().requires_grad_())  # a graph for x
    with torch.no_grad():
        assert layers.takes_kernel(bn, x.detach().requires_grad_())
    assert not layers.takes_kernel(bn, x, r.detach().requires_grad_())  # ... the residual
    bn.weight.requires_grad_(True)  # ... BN's parameters (a trainable affine)
    assert not layers.takes_kernel(bn, x)
    with torch.inference_mode():
        assert layers.takes_kernel(bn, x)
    bn.weight.requires_grad_(False)
    untracked = layers.BatchNorm2d(16, track_running_stats=False).eval()
    assert not layers.takes_kernel(untracked, x)


def test_takes_kernel_only_for_channels_last_bf16_on_a_card():
    bn = _bn(16, 60)
    assert not layers.takes_kernel(bn, _x((2, 16, 3, 4), 61, torch.bfloat16))  # CPU
    assert not layers.takes_kernel(bn, _card((2, 16, 3, 4), 61, torch.float32))
    # Any layout and channel count on a card: bn_act brings x and the residual to
    # channels_last, and the kernel raises on what it cannot take.
    x = _card((2, 16, 3, 4), 64, fmt=torch.contiguous_format)
    assert layers.takes_kernel(bn, x, _card((2, 16, 3, 4), 65, fmt=torch.contiguous_format))
    assert layers.takes_kernel(_bn(12, 62), _card((2, 12, 3, 4), 63))


def test_bn_act_hands_the_kernel_channels_last_copies(monkeypatch):
    bn = _bn(16, 66)
    seen = []

    def kernel(x, mean, var, weight, bias, eps, residual=None, relu=True):
        seen.append([t.is_contiguous(memory_format=CL) for t in (x, residual)])
        return kbn.bn_act_plain(x, mean, var, weight, bias, eps, residual, relu)

    monkeypatch.setattr(layers, "fused_bn_act", kernel)
    x = _card((2, 16, 3, 4), 67, fmt=torch.contiguous_format)
    r = _card((2, 16, 3, 4), 68, fmt=torch.contiguous_format)
    got = layers.bn_act(bn, x, r)
    assert seen == [[True, True]]
    want = torch.relu(F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, False, 0.0, bn.eps) + r.float())
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=2 ** -7)


def test_the_kernel_check_refuses_what_the_kernel_cannot_take():
    bn = _bn(16, 69)
    stats = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    x = _card((2, 16, 3, 4), 70)
    kbn._check(x, *stats, x)  # takes it
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:]  # 2 bytes off 16
    off = flat.as_strided(x.shape, x.stride()).as_subclass(_OnCard)
    bad = {"channels first": _card((2, 16, 3, 4), 71, fmt=torch.contiguous_format),
           "float32": _card((2, 16, 3, 4), 72, torch.float32),
           "12 channels": _card((2, 12, 3, 4), 73), "unaligned": off}
    for name, t in bad.items():
        with pytest.raises(ValueError, match="channels_last"):
            kbn._check(t, *(s[:t.shape[1]] for s in stats), None)
        if t.shape == x.shape:
            with pytest.raises(ValueError, match="residual"):
                kbn._check(x, *stats, t)
    with pytest.raises(ValueError, match="mean"):
        kbn._check(x, bn.running_mean.double(), *stats[1:], None)


def _forced(monkeypatch):
    """Every ``bn_act`` call takes the kernel's path, the plain version standing in for
    the kernel; returns the list of (residual given, relu) of each call."""
    calls = []

    def kernel(x, mean, var, weight, bias, eps, residual=None, relu=True):
        calls.append((residual is not None, relu))
        return kbn.bn_act_plain(x, mean, var, weight, bias, eps, residual, relu)

    monkeypatch.setattr(layers, "takes_kernel", lambda bn, x, residual=None: not bn.training)
    monkeypatch.setattr(layers, "fused_bn_act", kernel)
    return calls


@pytest.mark.parametrize("downsample", [False, True])
def test_every_eval_batch_norm_of_a_block_goes_through_the_kernel(monkeypatch, downsample):
    block = _block(downsample, seed=1)
    x = _x((2, block.conv1.in_channels, 9, 11), 70)
    with torch.no_grad():
        want = _old_bottleneck(block, x)
        calls = _forced(monkeypatch)
        got = block(x)
    # bn1, bn2 with their ReLU; the downsample's BN alone; bn3 with the add and ReLU.
    assert calls == ([(False, True)] * 2 + [(False, False)] * downsample + [(True, True)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_mode_block_never_takes_the_kernel(monkeypatch):
    block = _block(True, seed=2).train()
    calls = _forced(monkeypatch)
    x = _x((2, 32, 9, 11), 80)
    block(x).sum().backward()
    assert calls == []
    assert block.conv1.weight.grad is not None
