"""Port vs JAX: the whole two-scale evaluation (simt_tpu_torch/eval/evaluate.py).

The tests/test_eval.py setup: 3 synthetic val images at 64x32, scales 32x16 / 40x20,
output 32x64, layers (1,1,1,1), float32, the JAX weights carried across. Pass: equal
histogram totals, L1 difference <= 1% of the counted pixels (float32 conv summation
order may flip near-tie argmaxes), and the same print lines apart from the IoU digits.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.data import synthetic as jax_synthetic
from simt_tpu.eval import evaluate as jax_evaluate
from simt_tpu.models.resnet_multi import ResNetMulti as JaxResNetMulti
from simt_tpu_torch.data import synthetic
from simt_tpu_torch.eval import evaluate
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import state_dict_from_flax

KW = dict(scales=((32, 16), (40, 20)), out_hw=(32, 64))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cs"))
    paths = synthetic.make_cityscapes_fixture(root, n_train=2, n_val=3, image_wh=(64, 32))
    jmodel = JaxResNetMulti(num_classes=19, layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 3)), False)
    model = ResNetMulti(19, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)))
    return paths, jmodel, variables, model


def _digits_out(lines):
    return [re.sub(r"[-0-9.na]+$", "#", line) for line in lines]


@pytest.mark.parametrize("mode", ["simt", "warmup"])
@pytest.mark.parametrize("batch_size", [1, 3])
def test_evaluate_matches_jax(setup, mode, batch_size):
    paths, jmodel, variables, model = setup
    common = dict(data_root=paths["root"], val_list=paths["val_txt"],
                  gt_dir=paths["gt_dir"], mode=mode, batch_size=batch_size,
                  return_hist=True, **KW)
    want_lines, got_lines = [], []
    _, want = jax_evaluate(jmodel, variables, print_fn=want_lines.append, **common)
    miou, got = evaluate(model, device="cpu", print_fn=got_lines.append, **common)
    assert 0.0 <= miou <= 100.0
    counted = 3 * 32 * 64  # every synthetic gt pixel maps to a train id
    assert got.sum() == want.sum() == counted
    assert np.abs(got - want).sum() <= 0.01 * counted, np.abs(got - want).sum()
    assert len(got_lines) == 20 and got_lines[-1].startswith("===> mIoU: ")
    assert _digits_out(got_lines) == _digits_out(want_lines)


def test_save_dir_path_matches_fused_path(setup, tmp_path):
    paths, _, _, model = setup
    common = dict(data_root=paths["root"], val_list=paths["val_txt"],
                  gt_dir=paths["gt_dir"], return_hist=True, device="cpu",
                  print_fn=lambda s: None, **KW)
    _, fused = evaluate(model, **common)
    _, saved = evaluate(model, save_dir=str(tmp_path), **common)
    np.testing.assert_array_equal(fused, saved)
    assert len(list(tmp_path.glob("*.png"))) == 3


def test_gt_shape_mismatch_is_skipped(setup):
    paths, _, _, model = setup
    lines = []
    _, hist = evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                       gt_dir=paths["gt_dir"], scales=KW["scales"], out_hw=(16, 32),
                       return_hist=True, device="cpu", print_fn=lines.append)
    assert hist.sum() == 0
    assert sum(line.startswith("Skipping: gt") for line in lines) == 3


def test_fixture_matches_jax_fixture(tmp_path):
    from PIL import Image

    a = synthetic.make_cityscapes_fixture(str(tmp_path / "port"), n_train=1, n_val=2)
    b = jax_synthetic.make_cityscapes_fixture(str(tmp_path / "jax"), n_train=1, n_val=2)
    with open(a["val_txt"]) as fa, open(b["val_txt"]) as fb:
        names = fa.read().split()
        assert names == fb.read().split()
    for name in names:
        gt = name.split("leftImg8bit")[0] + "gtFine_labelIds.png"
        for sub, fname in (("val", name), ("label", gt)):
            pa = np.asarray(Image.open(f"{a['root']}/{sub}/{fname}"))
            pb = np.asarray(Image.open(f"{b['root']}/{sub}/{fname}"))
            np.testing.assert_array_equal(pa, pb)
