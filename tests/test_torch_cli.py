"""The port's CLIs on the CPU (simt_tpu_torch/tools/train_simt.py, train_warmup.py,
test.py, common.py), on the layers (1,1,1,1) model (tests/torch_loop_helpers.py) at
64x32 crops of the synthetic fixture, 19 + 15 classes (the evaluation scores the
devkit's 19):

  - ``train_simt --synthetic`` runs through ``train()`` from PNGs on disk, evaluates at
    step 2 on the scaled two-scale protocol, keeps the best snapshot, writes the last
    one and 3 CSV rows; ``--resume`` continues from step 3 to 4;
  - ``train_warmup --synthetic``: 3 steps, one evaluation, its snapshots;
  - ``test --synthetic --save-dir`` writes the prediction PNGs;
  - a flag of a later ROADMAP item (A-4: the mesh and multi-host flags; A-5:
    ``--model``, ``--cache-teacher``, ``--adversarial``) raises and names the item.
"""

import os

import pytest

from simt_tpu_torch.tools import test as test_cli
from simt_tpu_torch.tools import train_simt, train_warmup

from torch_loop_helpers import read_csv, tiny_models

CPU = ["--synthetic", "--device", "cpu", "--input-size-target", "64,32",
       "--compute-dtype", "float32", "--log-every", "1"]


def test_train_simt_evaluates_snapshots_and_resumes(tmp_path, monkeypatch, capsys):
    tiny_models(monkeypatch)
    snaps, csv = str(tmp_path / "snaps"), str(tmp_path / "m.csv")
    args = CPU + ["--num-steps-stop", "3", "--save-pred-every", "2", "--snapshot-dir",
                  snaps, "--csv", csv]
    out = train_simt.main(args)
    text = capsys.readouterr().out
    assert "Leanring_rate_T:  0.0025" in text and "Open-set class:  15" in text
    assert text.count("iter = ") == 3 and "Begin evaluation on iter        2" in text
    assert "===> mIoU: " in text and "Saving model with mIoU:" in text
    assert out["best_step"] == 2 and len(out["eval_seconds"]) == 1
    assert sorted(os.listdir(snaps)) == ["step_00000002", "step_00000003"]
    assert [r["step"] for r in read_csv(csv)] == ["0", "1", "2"]
    out = train_simt.main(CPU + ["--num-steps-stop", "4", "--snapshot-dir", snaps,
                                 "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert out["state"].step == 4 and "step_00000004" in os.listdir(snaps)


def test_train_warmup_evaluates_and_snapshots(tmp_path, monkeypatch, capsys):
    tiny_models(monkeypatch)
    snaps = str(tmp_path / "snaps")
    out = train_warmup.main(CPU + ["--num-steps-stop", "3", "--save-pred-every", "2",
                                   "--snapshot-dir", snaps])
    text = capsys.readouterr().out
    assert text.count("loss_seg1 = ") == 3 and "===> mIoU: " in text
    assert out["state"].model.layer5_1 is None and out["best_step"] == 2
    assert sorted(os.listdir(snaps)) == ["step_00000002", "step_00000003"]


def test_test_cli_saves_predictions(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    miou = test_cli.main(["--synthetic", "--device", "cpu", "--compute-dtype", "float32",
                          "--save-dir", str(tmp_path / "preds")])
    assert 0.0 <= miou <= 100.0
    assert sorted(os.listdir(tmp_path / "preds")) == [
        "city_000000_000123_leftImg8bit.png", "city_000001_000123_leftImg8bit.png"]


@pytest.mark.parametrize("flag,item", [
    (["--mesh-data", "2"], "A-4"), (["--mesh-spatial", "2"], "A-4"),
    (["--coordinator", "localhost:1"], "A-4"), (["--num-processes", "2"], "A-4"),
    (["--process-id", "1"], "A-4"), (["--model", "deeplabv3"], "A-5"),
    (["--model", "deeplab_single"], "A-5"), (["--cache-teacher"], "A-5")])
def test_flags_of_later_items_raise_and_name_them(flag, item):
    for main in (train_simt.main, train_warmup.main, test_cli.main):
        with pytest.raises(ValueError, match=item):
            main(["--synthetic", "--device", "cpu"] + flag)


def test_adversarial_warmup_raises_and_names_a5():
    with pytest.raises(ValueError, match="A-5"):
        train_warmup.main(["--synthetic", "--device", "cpu", "--adversarial"])
