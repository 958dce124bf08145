"""The planted run's seed calibration (simt_tpu_torch/tools/calibrate.py, the
counterpart of experiments/ntm_identification/calibrate.py) on the CPU at the smoke
geometry (layers (1,1,1,1), float32, 5 + 3 classes at 64x128), seeds 0 and 1: one JSON
line a seed on stdout, with calibrate.py's keys (``seed``, ``miou_ce``,
``miou_ce_val``, and per arm ``verbatim``/``paper``/``oracle`` the metrics without
``t1``); each line equal to the one built from ``planted_noise.run``'s own results for
that seed (the run wrapped, so its results are read as it returns them), its flags and
seed passed through, and each seed's record written where ``--out`` says."""

import json
import os

import pytest
import torch

from simt_tpu_torch.tools import calibrate, planted_noise

ARGV = ["--smoke", "--device", "cpu", "--warmup-steps", "2", "--train-steps", "1",
        "--log-every", "1", "--n-train", "2", "--n-val", "1"]
ARM_KEYS = {"miou_simt", "miou_simt_val", "t_dist_known_init", "t_attr_known_init",
            "t_dist_known_final", "t_attr_known_final"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread: the tests' tensors are small, and several threads per process under
    the suite's parallel workers only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lines_in_calibrate_py_layout_from_the_planted_runs(tmp_path, monkeypatch, capsys):
    runs = []
    real = planted_noise.run

    def recording(args, inits, print_fn=print):
        runs.append((args, real(args, inits, print_fn=print_fn)))
        return runs[-1][1]

    monkeypatch.setattr(planted_noise, "run", recording)
    out = str(tmp_path / "planted_{seed}.json")
    lines = calibrate.main(["0", "1", *ARGV, "--out", out])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines and [r["seed"] for r in lines] == [0, 1]
    for line, (args, res) in zip(lines, runs):
        assert args.seed == line["seed"] and args.warmup_steps == 2 and args.smoke
        assert set(line) == {"seed", "miou_ce", "miou_ce_val", "verbatim", "paper",
                             "oracle"}
        for arm in calibrate.ARMS:
            assert set(line[arm]) == ARM_KEYS
        assert line == calibrate.line(line["seed"], res)
        assert line["miou_ce_val"] == round(res["arms"]["ce"]["val_miou"], 4)
        assert line["oracle"]["t_dist_known_final"] <= 1e-4  # T frozen at T*
        assert os.path.exists(out.format(seed=line["seed"]))
    assert lines[0] != lines[1]
