"""Port vs JAX: DeepLabv2-ResNet multi-head forward with weights carried across
(simt_tpu_torch/models/resnet_multi.py, models/from_jax.py).

float32, eval mode, BN statistics randomised so the running-stat normalisation is not
the identity. Tolerance 2e-3, as the repo's torch twin (tests/test_model_parity.py):
the conv algorithms and JAX's W-folded stem sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models.import_torch import export_state_dict
from simt_tpu.models.resnet_multi import ResNetMulti as JaxResNetMulti
from simt_tpu_torch.models import ResNetMulti, deeplab_multi
from simt_tpu_torch.models.from_jax import state_dict_from_flax

CASES = {
    # name: (num_classes, open_classes, openset, layers, input (h, w), seed)
    "openset": (5, 3, True, (1, 1, 2, 1), (65, 97), 0),
    "closed": (4, 0, False, (1, 1, 1, 1), (48, 64), 1),
}


def _jax_variables(case):
    c, o, openset, layers, (h, w), seed = CASES[case]
    model = JaxResNetMulti(num_classes=c, open_classes=o, openset=openset, layers=layers,
                           dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, h, w, 3) * 50).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    bs = jax.tree.map(lambda a: np.abs(rng.randn(*a.shape).astype(np.float32) * 0.3
                                       + 1.0) + 0.1, variables["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": bs}
    return model, variables, x


def _port(case, variables):
    c, o, openset, layers, _, _ = CASES[case]
    model = ResNetMulti(c, o, openset, layers=layers, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jmodel, variables, x = _jax_variables(case)
    want1, want2 = jmodel.apply(variables, jnp.asarray(x), False)
    model = _port(case, variables)
    with torch.no_grad():
        got1, got2 = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((got1, want1), (got2, want2)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_equals_jax_export(case):
    _, variables, _ = _jax_variables(case)
    got = state_dict_from_flax(variables)
    want = export_state_dict(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_full_depth_keys_match_reference_layout():
    """ResNet-101 open-set: the names a reference DeeplabMulti .pth carries."""
    sd = deeplab_multi(19, 15, openset=True).state_dict()
    assert "layer3.22.conv3.weight" in sd and "layer4.2.bn3.running_var" in sd
    assert "layer3.0.downsample.0.weight" in sd and "layer3.0.downsample.1.bias" in sd
    assert "layer2.1.downsample.0.weight" not in sd
    assert sd["layer5_1.conv2d_list.3.weight"].shape == (15, 1024, 3, 3)
    assert sd["layer6.conv2d_list.0.bias"].shape == (19,)
    assert all(not p.requires_grad for n, p in deeplab_multi().named_parameters()
               if ".bn" in n or n.startswith("bn1") or "downsample.1" in n)
