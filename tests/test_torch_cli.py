"""The port's CLIs on the CPU (simt_tpu_torch/tools/train_simt.py, train_warmup.py,
test.py, common.py), on the layers (1,1,1,1) model (tests/torch_loop_helpers.py) at
64x32 crops of the synthetic fixture, 19 + 15 classes (the evaluation scores the
devkit's 19):

  - ``train_simt --synthetic`` runs through ``train()`` from PNGs on disk, evaluates at
    step 2 on the scaled two-scale protocol, keeps the best snapshot, writes the last
    one and 3 CSV rows; ``--resume`` continues from step 3 to 4;
  - ``train_warmup --synthetic``: 3 steps, one evaluation, its snapshots;
  - ``test --synthetic --save-dir`` writes the prediction PNGs;
  - ``test --model`` evaluates Res_Deeplab (layers (1,1,1,1)), DeepLab-VGG and
    DeepLabv3; ``train_warmup --model deeplabv3`` trains DeepLabv3's groups;
    ``train_warmup --adversarial`` runs the adversarial loop; ``train_simt
    --cache-teacher`` feeds the step from the teacher cache; ``train_simt --model``
    other than deeplab_multi raises the JAX package's error;
  - the mesh and process-group flags (ROADMAP A-4, ported) refused in one process where
    they cannot hold, each naming what is missing: ``--mesh-data 2`` and
    ``--mesh-spatial 2`` the processes, ``--num-processes`` / ``--process-id`` the
    coordinator, a process id outside the group; tests/test_torch_multiprocess.py runs
    them across processes.
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
    (["--mesh-data", "2"], "--num-processes"),
    (["--mesh-spatial", "2"], "--num-processes"),
    (["--coordinator", "localhost:1", "--process-id", "1"], "outside 0..0"),
    (["--num-processes", "2"], "--coordinator"),
    (["--process-id", "1"], "--coordinator")],
    ids=[f"flag{i}-A-4" for i in range(5)])  # A-4's flags
def test_flags_of_later_items_raise_and_name_them(flag, item):
    items = item if isinstance(item, tuple) else (item,) * 3
    for main, want in zip((train_simt.main, train_warmup.main, test_cli.main), items):
        with pytest.raises(ValueError, match=want):
            main(["--synthetic", "--device", "cpu"] + flag)


@pytest.mark.parametrize("arch", ["deeplab_single", "deeplab_vgg", "deeplabv3"])
def test_test_cli_evaluates_every_arch(arch, monkeypatch, capsys):
    tiny_models(monkeypatch)
    built = []
    real = test_cli.build_models
    monkeypatch.setattr(test_cli, "build_models", lambda cfg: built.append(cfg) or real(cfg))
    miou = test_cli.main(["--synthetic", "--device", "cpu", "--compute-dtype", "float32",
                          "--model", arch])
    assert 0.0 <= miou <= 100.0 and "===> mIoU: " in capsys.readouterr().out
    assert built[0].model.arch == arch
    assert built[0].model.aspp_effective_branches == (4 if arch == "deeplab_single" else 2)


def test_train_warmup_trains_deeplabv3(capsys):
    out = train_warmup.main(CPU + ["--model", "deeplabv3", "--num-steps-stop", "2"])
    assert capsys.readouterr().out.count("loss_seg1 = ") == 2
    st = out["state"]
    assert st.step == 2 and type(st.model).__name__ == "DeepLabv3"
    assert st.model.layer3[0].bn2.weight.requires_grad  # v3's groups: BN affine trains
    assert not st.model.conv1.weight.requires_grad


def test_adversarial_warmup_runs(monkeypatch, capsys):
    tiny_models(monkeypatch)
    out = train_warmup.main(CPU + ["--adversarial", "--num-steps-stop", "2"])
    text = capsys.readouterr().out
    assert text.count("loss_adv = ") == 2 and "done (adversarial warmup)" in text
    assert out["state"].step == 2
    assert all(s["step"] == 2 for s in out["d_state"].opt.state.values())


def test_train_simt_caches_the_teacher(monkeypatch, capsys):
    tiny_models(monkeypatch)
    out = train_simt.main(CPU + ["--cache-teacher", "--num-steps-stop", "2"])
    assert "teacher cache enabled" in capsys.readouterr().out
    assert out["state"].step == 2
    with pytest.raises(ValueError, match="requires arch 'deeplab_multi'"):
        train_simt.main(CPU + ["--model", "deeplabv3"])
