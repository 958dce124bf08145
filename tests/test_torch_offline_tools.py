"""Port vs JAX: the offline tools (simt_tpu_torch/tools/compute_iou.py,
compute_class_distribution.py, compute_confusion_matrix.py, export_torch.py) and the
palette PNGs (eval/evaluate.py), on the synthetic Cityscapes fixture:

  - ``compute_miou``, ``compute_class_distribution``, ``hist_34x19`` and
    ``compute_confusion`` equal to the JAX tools' outputs exactly (integer counts);
  - the port's ``evaluate(save_dir=)`` predictions re-scored by its ``compute_miou``
    equal to its online mIoU (tests/test_offline_consistency.py for the port);
  - ``colorize_mask`` / ``save_pred_png(color=True)`` equal byte for byte to JAX's;
  - ``export_torch`` (its function and its CLI, from a ``.pth`` and from a snapshot)
    equal to JAX's ``export_state_dict`` for the same weights: the same keys, equal
    values.
"""

import importlib
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simt_tpu.models.import_torch import export_state_dict as jexport
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu_torch.data.lists import ASSETS_DIR
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture
from simt_tpu_torch.eval import colorize_mask, evaluate, save_pred_png
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.tools import (compute_class_distribution, compute_confusion_matrix,
                                  compute_iou, export_torch)
from simt_tpu_torch.train import checkpoint, create_warmup_state, loop

from torch_loop_helpers import configs, tiny_models

jeval_mod = importlib.import_module("simt_tpu.eval.evaluate")
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """A fixture of 3 train and 3 val images at 64x32, random train-id predictions
    for the val images, and a devkit directory naming them."""
    root = tmp_path_factory.mktemp("offline")
    paths = make_cityscapes_fixture(str(root / "cs"), n_train=3, n_val=3,
                                    image_wh=(64, 32), seed=4)
    with open(paths["val_txt"]) as f:
        names = [n.strip() for n in f if n.strip()]
    rng = np.random.default_rng(5)
    preds = root / "preds"
    preds.mkdir()
    for n in names:
        Image.fromarray(rng.integers(0, 19, (32, 64)).astype(np.uint8)).save(
            preds / os.path.basename(n))
    devkit = root / "devkit"
    devkit.mkdir()
    shutil.copy(os.path.join(ASSETS_DIR, "cityscapes_list", "info.json"), devkit)
    with open(devkit / "val.txt", "w") as f:
        f.write("\n".join(names) + "\n")
    with open(devkit / "label.txt", "w") as f:
        f.write("\n".join(n.split("leftImg8bit")[0] + "gtFine_labelIds.png"
                          for n in names) + "\n")
    return paths, str(preds), str(devkit), names


def test_compute_miou_equals_jax(fixture, capsys):
    paths, preds, devkit, _ = fixture
    got = compute_iou.main([paths["gt_dir"], preds, "--devkit-dir", devkit])
    port_out = capsys.readouterr().out
    want = _jax_tool("compute_iou").compute_miou(paths["gt_dir"], preds, devkit)
    assert port_out == capsys.readouterr().out and "===> mIoU: " in port_out
    np.testing.assert_array_equal(got, want)


def test_class_distribution_equals_jax(fixture, tmp_path):
    paths, _, _, _ = fixture
    lst = tmp_path / "names.txt"
    with open(paths["pseudo_lst"]) as f:
        lst.write_text("\n".join(line.split()[1] for line in f if line.strip()))
    out = tmp_path / "cd.npy"
    got = compute_class_distribution.main(["--pred-dir", os.path.join(paths["root"],
                                                                      "pseudo"),
                                           "--list", str(lst), "--out", str(out)])
    jtool = _jax_tool("compute_class_distribution")
    with open(lst) as f:
        names = [n.strip() for n in f if n.strip()]
    want = jtool.compute_class_distribution(os.path.join(paths["root"], "pseudo"), names)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(out), want.astype(np.float32))
    assert got.sum() == pytest.approx(1.0)
    pred = np.array([0, 3, 3, 255, 18, 19, -1])
    np.testing.assert_array_equal(compute_class_distribution.class_histogram(pred, 19),
                                  jtool.class_histogram(pred, 19))


def test_confusion_34x19_equals_jax(fixture, tmp_path):
    paths, preds, _, names = fixture
    gt_list, pred_list = tmp_path / "gt.txt", tmp_path / "pred.txt"
    gt_list.write_text("\n".join(n.split("leftImg8bit")[0] + "gtFine_labelIds.png"
                                 for n in names))
    pred_list.write_text("\n".join(names))
    out = tmp_path / "cm.npy"
    got = compute_confusion_matrix.main(["--gt-dir", paths["gt_dir"], "--pred-dir", preds,
                                         "--gt-list", str(gt_list), "--pred-list",
                                         str(pred_list), "--out", str(out),
                                         "--plot", str(tmp_path / "cm.png")])
    jtool = _jax_tool("compute_confusion_matrix")
    want = jtool.compute_confusion(paths["gt_dir"], preds,
                                   [n.strip() for n in gt_list.read_text().split("\n")],
                                   names)
    assert got.shape == (34, 19) and got.sum() == 3 * 32 * 64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(out), want)
    assert (tmp_path / "cm.png").stat().st_size > 0
    label = np.array([0, 7, 33, 34, 255, 7])
    pred = np.array([1, 18, 0, 2, 3, 19])
    np.testing.assert_array_equal(compute_confusion_matrix.hist_34x19(label, pred),
                                  jtool.hist_34x19(label, pred))


def test_saved_predictions_rescore_to_the_online_miou(fixture, tmp_path):
    paths, _, devkit, _ = fixture
    model = ResNetMulti(19, layers=(1, 1, 1, 1), dtype=torch.float32)
    online = evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                      gt_dir=paths["gt_dir"], scales=((32, 16), (40, 20)), out_hw=(32, 64),
                      save_dir=str(tmp_path / "preds"), device="cpu",
                      print_fn=lambda s: None)
    ious = compute_iou.compute_miou(paths["gt_dir"], str(tmp_path / "preds"), devkit)
    assert round(float(np.nanmean(ious)) * 100, 2) == online


def test_colorize_mask_equals_jax_byte_for_byte(tmp_path):
    mask = (np.arange(32 * 64).reshape(32, 64) % 21).astype(np.uint8)
    mask[0, :3] = 255
    got, want = colorize_mask(mask), jeval_mod.colorize_mask(mask)
    assert got.mode == want.mode == "P" and got.getpalette() == want.getpalette()
    assert got.tobytes() == want.tobytes()
    for color in (True, False):
        save_pred_png(mask, str(tmp_path / f"t{color}.png"), color=color)
        jeval_mod.save_pred_png(mask, str(tmp_path / f"j{color}.png"), color=color)
        assert ((tmp_path / f"t{color}.png").read_bytes()
                == (tmp_path / f"j{color}.png").read_bytes())


def _jax_variables(seed, num_classes=19):
    """A JAX variables tree of the layers (1,1,1,1) model with seeded normal values
    (shapes from ``eval_shape``: no initialiser runs)."""
    jmodel = JResNetMulti(num_classes=num_classes, layers=(1, 1, 1, 1), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16, 32, 3)), False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)


def test_export_equals_jax_export_state_dict(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    variables = _jax_variables(0, num_classes=5)
    want = jexport(variables)
    model = ResNetMulti(5, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables))
    got = export_torch.export_state_dict(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    # The CLI: from a .pth to an .npz, and from a snapshot to a .pth.
    torch.save(model.state_dict(), tmp_path / "m.pth")
    common = ["--device", "cpu", "--num-classes", "5", "--compute-dtype", "float32",
              "--stage", "warmup"]
    export_torch.main(common + ["--restore-from", str(tmp_path / "m.pth"),
                                "--snapshot-dir", str(tmp_path / "none"),
                                "--out", str(tmp_path / "out.npz")])
    with np.load(tmp_path / "out.npz") as z:
        assert set(z.files) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    _, cfg = configs(tmp_path, "warmup")
    st = create_warmup_state(loop.build_models(cfg)[0], cfg, "cpu")
    st.model.load_state_dict(state_dict_from_flax(variables))
    checkpoint.save(st, str(tmp_path / "snaps"), 3)
    export_torch.main(common + ["--snapshot-dir", str(tmp_path / "snaps"),
                                "--out", str(tmp_path / "out.pth")])
    sd = torch.load(tmp_path / "out.pth", weights_only=True)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    with pytest.raises(SystemExit):
        export_torch.main(common + ["--snapshot-dir", str(tmp_path / "none"),
                                    "--out", str(tmp_path / "x.pth")])
