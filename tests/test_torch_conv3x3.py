"""Port vs JAX: the dilated 3x3 conv of every bottleneck (simt_tpu_torch/ops/conv.py,
ops/kernels/conv3x3.py; kernels B4/B5 run only on a card, so here the Function runs
their plain versions in the same forward/backward structure).

  - forward, d_input and d_weight against ``simt_tpu.ops.conv.dilated_conv3x3_taps``
    and its custom VJP, on the four cases of the Pallas experiment's test
    (experiments/pallas_alternates/test_pallas_conv.py:20-22) at batch 1 and 2: float32
    at that test's rtol 1e-4 / atol 1e-5; bfloat16 operands at one bf16 ulp of the
    largest value (2**-7 of the max abs: both sides sum exactly representable products
    in float32, in other orders, and round once, so a value may round the other way);
  - the same against the Pallas ``dilated_conv3x3`` in interpret mode;
  - ``needs_input_grad``: a frozen weight gets no d_weight, an input that needs no
    gradient no d_input;
  - a train-mode ``Bottleneck`` against flax's, output, input gradient and conv2 weight
    gradient at the tolerance of tests/test_torch_model_train.py (2e-3).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models.layers import Bottleneck as JBottleneck
from simt_tpu.ops.conv import dilated_conv3x3_taps
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.models.layers import Bottleneck
from simt_tpu_torch.ops import conv as conv_lib
from simt_tpu_torch.ops.conv import dilated_conv3x3
from simt_tpu_torch.ops.kernels import conv3x3 as kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(1, 8, 16, 4, 4), (2, 12, 20, 8, 16), (4, 16, 12, 8, 8), (2, 13, 10, 3, 5)]
BF16_ULP = 2.0 ** -7


def _inputs(batch, d, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed + 10 * d + batch)
    x = rng.randn(batch, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    g = rng.randn(batch, h, w, cout).astype(np.float32)
    return x, k, g


def _jax(fn, x, k, g, d, dtype):
    xj, kj = jnp.asarray(x, dtype), jnp.asarray(k, dtype)
    y, pull = jax.vjp(lambda a, b: fn(a, b, d), xj, kj)
    dx, dk = pull(jnp.asarray(g, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dk)]


def _port(x, k, g, d, dtype):
    """NHWC / HWIO numpy in, (y NHWC, dx NHWC, dk HWIO) float32 numpy out."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(dtype)
    wt.requires_grad_()
    y = dilated_conv3x3(xt, wt, d)
    assert y.dtype == dtype
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).to(dtype)
    dx, dw = torch.autograd.grad(y, (xt, wt), gt)
    assert dx.dtype == dtype and dw.dtype == dtype
    return [y.detach().float().permute(0, 2, 3, 1).numpy(),
            dx.float().permute(0, 2, 3, 1).numpy(),
            dw.float().permute(2, 3, 1, 0).numpy()]


def _assert_close(got, want, dtype):
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=BF16_ULP * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("d,h,w,cin,cout", CASES)
def test_matches_jax_taps_and_vjp(d, h, w, cin, cout, batch, dtype):
    x, k, g = _inputs(batch, d, h, w, cin, cout)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax(dilated_conv3x3_taps, x, k, g, d, jdt)
    _assert_close(_port(x, k, g, d, dtype), want, dtype)


@pytest.fixture(scope="module")
def pallas_conv():
    """experiments/pallas_alternates/conv3x3.py, imported by path; on the CPU its
    pallas_call runs in interpret mode."""
    path = os.path.join(REPO, "experiments", "pallas_alternates", "conv3x3.py")
    spec = importlib.util.spec_from_file_location("pallas_conv3x3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.dilated_conv3x3


@pytest.mark.parametrize("d,h,w,cin,cout", CASES)
def test_matches_pallas_interpret(pallas_conv, d, h, w, cin, cout):
    x, k, g = _inputs(2, d, h, w, cin, cout, seed=1)
    want = _jax(pallas_conv, x, k, g, d, jnp.float32)
    _assert_close(_port(x, k, g, d, torch.float32), want, torch.float32)


def test_needs_input_grad(monkeypatch):
    calls = {"fwd": 0, "dx": 0, "dw": 0}
    fwd, wgrad = conv_lib.conv3x3_fwd, conv_lib.conv3x3_wgrad

    def spy_fwd(x, w, d, *, flip=False):
        calls["dx" if flip else "fwd"] += 1
        return fwd(x, w, d, flip=flip)

    def spy_wgrad(x, g, d):
        calls["dw"] += 1
        return wgrad(x, g, d)

    monkeypatch.setattr(conv_lib, "conv3x3_fwd", spy_fwd)
    monkeypatch.setattr(conv_lib, "conv3x3_wgrad", spy_wgrad)
    x = torch.randn(1, 4, 6, 7)
    w = torch.randn(5, 4, 3, 3) * 0.1

    xg = x.clone().requires_grad_()  # frozen weight: d_input only
    dilated_conv3x3(xg, w, 2).square().sum().backward()
    assert calls == {"fwd": 1, "dx": 1, "dw": 0} and xg.grad is not None

    wg = w.clone().requires_grad_()  # an input that needs no gradient: d_weight only
    dilated_conv3x3(x, wg, 2).square().sum().backward()
    assert calls == {"fwd": 2, "dx": 1, "dw": 1} and wg.grad is not None

    with torch.no_grad():  # nothing recorded
        dilated_conv3x3(x, wg, 2)
    assert calls == {"fwd": 3, "dx": 1, "dw": 1}


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 4, 5, 6)
    with pytest.raises(ValueError, match="channels"):
        kernels.conv3x3_fwd(x, torch.zeros(5, 3, 3, 3), 1)
    with pytest.raises(ValueError, match="OIHW"):
        kernels.conv3x3_fwd(x, torch.zeros(5, 4, 1, 1), 1)
    with pytest.raises(TypeError, match="dtype"):
        kernels.conv3x3_fwd(x, torch.zeros(5, 4, 3, 3, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="dilation"):
        kernels.conv3x3_fwd(x, torch.zeros(5, 4, 3, 3), 0)
    with pytest.raises(ValueError, match="device"):  # neither CPU nor CUDA: no fallback
        kernels.conv3x3_fwd(x.to("meta"), torch.zeros(5, 4, 3, 3, device="meta"), 1)
    with pytest.raises(ValueError, match="must be"):
        kernels.conv3x3_wgrad(x, torch.zeros(1, 5, 5, 7), 1)


def test_work_counts_the_trunk_geometries():
    # layer1 at 512x1024: 2.44 GFLOP and 8.6 MB in bf16 (bound by bytes at 3.35 TB/s
    # against 989 TFLOP/s); layer4: 39.6 GFLOP.
    nbytes, ops = kernels.work(1, 129, 257, 64, 64, torch.bfloat16, "fwd")
    assert ops == 2 * 129 * 257 * 9 * 64 * 64 and round(ops / 1e9, 2) == 2.44
    assert round(nbytes / 1e6, 1) == 8.6 and nbytes / 3.35e12 > ops / 989e12
    assert round(kernels.work(1, 65, 129, 512, 512, torch.bfloat16, "wgrad")[1] / 1e9,
                 1) == 39.6
    splits, per = kernels.wgrad_splits(129 * 257, 64, 64)
    assert splits * 9 >= 2 * 132 and (splits - 1) * per < 129 * 257 <= splits * per


@pytest.mark.parametrize("stride,dilation,downsample", [(1, 1, True), (2, 1, True),
                                                        (1, 2, False), (1, 4, True)])
def test_bottleneck_matches_flax(stride, dilation, downsample):
    planes, inplanes = 4, 16 if not downsample else 8
    rng = np.random.RandomState(stride + 3 * dilation)
    x = (rng.randn(2, 9, 11, inplanes) * 2).astype(np.float32)
    jblock = JBottleneck(planes, stride=stride, dilation=dilation,
                         has_downsample=downsample, dtype=jnp.float32)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    variables = jax.tree.map(np.asarray, variables)

    def loss(params, xa):
        y, _ = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            xa, True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.cos(y)), y

    (_, want_y), (want_dp, want_dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                         has_aux=True)(
        variables["params"], jnp.asarray(x))

    block = Bottleneck(inplanes, planes, stride, dilation, downsample=downsample)
    block.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = block.train()(xt)
    (y * torch.cos(y)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_y),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(block.conv2.weight.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(want_dp["conv2"]["kernel"]), rtol=2e-3,
                               atol=2e-3)
