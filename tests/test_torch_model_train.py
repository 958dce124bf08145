"""Port vs JAX: the train-mode forward and the BatchNorm running statistics
(simt_tpu_torch/models/layers.py::BatchNorm2d, models/resnet_multi.py).

Decision C1: the port updates ``running_var`` with the *biased* batch variance, as
``flax.linen.BatchNorm`` does, not with torch's unbiased one. float32 throughout.
Tolerances: a single BatchNorm rtol 1e-5 / atol 1e-6 (flax computes E[x^2] - E[x]^2,
torch a two-pass variance); the whole network rtol = atol = 2e-3, as the eval-mode test
(conv algorithms sum in other orders, and batch statistics pass that on).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models.resnet_multi import ResNetMulti as JaxResNetMulti
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.models.layers import frozen_bn


@pytest.mark.parametrize("shape", [(2, 8, 9, 4), (1, 3, 5, 7)])
def test_batchnorm_running_stats_equal_flax(shape):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)  # NHWC
    c = shape[-1]
    mean0 = rng.randn(c).astype(np.float32)
    var0 = (rng.rand(c) + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    variables = {"params": {"scale": jnp.ones(c), "bias": jnp.zeros(c)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want_y, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = frozen_bn(c).train()
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    got_y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)
    # torch's own BatchNorm2d would differ: its variance increment is N/(N-1) larger.
    n = x.size // c
    stock = torch.nn.BatchNorm2d(c, momentum=0.1).train()
    with torch.no_grad():
        stock.running_var.copy_(torch.from_numpy(var0))
        stock(torch.from_numpy(x).permute(0, 3, 1, 2))
    ratio = (stock.running_var - 0.9 * torch.from_numpy(var0)) / (
        port.running_var - 0.9 * torch.from_numpy(var0))
    np.testing.assert_allclose(ratio.numpy(), n / (n - 1), rtol=1e-4)


def test_batchnorm_gradient_flows_and_eval_is_unchanged():
    bn = frozen_bn(3)
    x = torch.randn(2, 3, 4, 5, requires_grad=True)
    bn.train()(x).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert bn.num_batches_tracked.item() == 1
    stock = torch.nn.BatchNorm2d(3)
    stock.load_state_dict(bn.state_dict())
    y = torch.randn(1, 3, 4, 5)
    assert torch.equal(bn.eval()(y), stock.eval()(y))


def test_train_forward_and_batch_stats_match_flax():
    c, o, layers, (h, w) = 5, 3, (1, 1, 2, 1), (65, 97)
    jmodel = JaxResNetMulti(num_classes=c, open_classes=o, openset=True, layers=layers,
                            dtype=jnp.float32)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, h, w, 3) * 50).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), False)
    bs = jax.tree.map(lambda a: np.abs(rng.randn(*a.shape).astype(np.float32) * 0.3
                                       + 1.0) + 0.1, variables["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": bs}
    (want1, want2), new = jmodel.apply(variables, jnp.asarray(x), True,
                                       mutable=["batch_stats"])

    model = ResNetMulti(c, o, True, layers=layers, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got1, got2 = model.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=2e-3, atol=2e-3)
    want_sd = state_dict_from_flax({"params": variables["params"],
                                    "batch_stats": jax.tree.map(np.asarray,
                                                                new["batch_stats"])})
    sd = model.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(1 for m in model.modules()
                                 if isinstance(m, torch.nn.BatchNorm2d))
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=k)
