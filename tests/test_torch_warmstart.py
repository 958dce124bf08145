"""Port vs JAX: the warm start from a reference ``.pth`` (``models/from_jax.py::
load_matching``) in the reference's three flavours, against
``simt_tpu/models/import_torch.py::import_state_dict``:

  - the warmup stage's ``k[6:]`` (trainV1_warmup.py:177): a closed-set ``deeplab_multi``
    state_dict whose every key carries ``"Scale."``, with one tensor of the wrong shape
    and one key the model lacks, loads exactly the keys ``import_state_dict(
    strip_prefix=6, shape_filter=True)`` loads, with equal values;
  - ``exclude=`` drops keys by prefix (the layer5 exclusion of deeplab.py:230-235);
  - the default call stays the key intersection (trainV2_simt.py:252-255);
  - ``tools/train_warmup.py --synthetic --restore-from`` on such a file loads the whole
    model: 0 missing keys.

``num_batches_tracked`` is left out of the comparison: the flax tree has no leaf for
that counter, and a BatchNorm with a momentum never reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models.import_torch import export_state_dict, import_state_dict
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu_torch.models import ResNetMulti, deeplab_multi
from simt_tpu_torch.models.from_jax import load_matching
from simt_tpu_torch.tools import train_warmup

COUNTER = "num_batches_tracked"


def _models():
    jm = JResNetMulti(num_classes=5, open_classes=0, openset=False, layers=(1, 1, 1, 1),
                      dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), False)
    return variables, ResNetMulti(5, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)


def _prefixed(model, seed=0):
    """The model's keys with ``"Scale."`` in front and seeded random values, plus a
    tensor of the wrong shape and a key the model lacks."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in model.state_dict().items():
        v = (torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
             if t.dtype.is_floating_point else t.clone())
        sd["Scale." + k] = v
    sd["Scale.layer5.conv2d_list.0.weight"] = torch.zeros(3, 3, 3, 3)  # wrong shape
    sd["Scale.not_a_module.weight"] = torch.zeros(4)
    return sd


def test_strip_prefix_loads_what_import_state_dict_loads():
    variables, model = _models()
    sd = _prefixed(model)
    restored, jrep = import_state_dict(variables, {k: v.numpy() for k, v in sd.items()},
                                       strip_prefix=6, shape_filter=True)
    rep = load_matching(model, sd, strip_prefix=6)
    loaded = {k for k in rep["loaded"] if not k.endswith(COUNTER)}
    assert loaded == set(jrep["loaded"]) and len(loaded) >= 100
    assert set(rep["skipped"]) == set(jrep["skipped"]) == {"layer5.conv2d_list.0.weight"}
    assert rep["unused"] == ["not_a_module.weight"]
    assert set(jrep["unused"]) == {"not_a_module.weight", "layer5.conv2d_list.0.weight"}
    own, jax_sd = model.state_dict(), export_state_dict(restored)
    for k in loaded:
        want = sd["Scale." + k].numpy()
        np.testing.assert_array_equal(own[k].numpy(), want, err_msg=k)
        np.testing.assert_array_equal(np.asarray(jax_sd[k]), want, err_msg=k)
    assert rep["missing"] == ["layer5.conv2d_list.0.weight"]


def test_exclude_drops_a_prefix():
    variables, model = _models()
    sd = _prefixed(model, seed=1)
    _, jrep = import_state_dict(variables, {k: v.numpy() for k, v in sd.items()},
                                strip_prefix=6, shape_filter=True, exclude=("layer5",))
    before = model.state_dict()["layer5.conv2d_list.1.weight"].clone()
    rep = load_matching(model, sd, strip_prefix=6, exclude=("layer5",))
    assert {k for k in rep["loaded"] if not k.endswith(COUNTER)} == set(jrep["loaded"])
    assert not any(k.startswith("layer5") for k in rep["loaded"] + rep["unused"])
    assert all(k.startswith("layer5") for k in rep["missing"]) and rep["missing"]
    assert torch.equal(model.state_dict()["layer5.conv2d_list.1.weight"], before)


def test_default_is_the_key_intersection():
    _, model = _models()
    plain = {k[len("Scale."):]: v for k, v in _prefixed(model, seed=2).items()}
    rep = load_matching(model, plain)
    assert rep["unused"] == ["not_a_module.weight"] and len(rep["loaded"]) > 100
    # Unstripped, the prefixed keys match nothing: the fault the warmup CLI had.
    _, fresh = _models()
    assert load_matching(fresh, _prefixed(fresh))["loaded"] == []


def test_warmup_cli_restores_a_prefixed_checkpoint(tmp_path, capsys):
    ref = deeplab_multi(5, 0, openset=False, dtype=torch.float32)
    sd = {"Scale." + k: v for k, v in ref.state_dict().items()}
    path = tmp_path / "warmup_init.pth"
    torch.save(sd, path)
    res = train_warmup.main(["--synthetic", "--num-steps-stop", "1", "--device", "cpu",
                             "--num-classes", "5", "--input-size-target", "64,32",
                             "--compute-dtype", "float32", "--restore-from", str(path)])
    out = capsys.readouterr().out
    assert "(missing 0, skipped 0)" in out and f"loaded {len(sd)} tensors" in out, out
    assert len(sd) > 500
    assert np.isfinite(res["final_metrics"]["loss_seg1"])


@pytest.mark.parametrize("prefix", ["Scale.", "Model."])
def test_strip_prefix_counts_characters(prefix):
    _, model = _models()
    sd = {prefix + k: v for k, v in model.state_dict().items()}
    rep = load_matching(model, sd, strip_prefix=len(prefix))
    assert not rep["missing"] and not rep["unused"] and not rep["skipped"]
