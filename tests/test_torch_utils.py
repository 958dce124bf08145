"""Port vs JAX: the loop's logging and plotting (simt_tpu_torch/utils/logging.py,
utils/viz.py): ``MetricWriter``'s CSV equal to the JAX writer's for the same rows
(the time column aside), tensors read as floats; ``StepTimer``; the reference log
lines; ``plot_ntm`` writes a PNG from a tensor."""

import csv
import time

import numpy as np
import torch
from PIL import Image

from simt_tpu import utils as jutils
from simt_tpu_torch import utils


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_metric_writer_columns_and_values_equal_jax(tmp_path):
    rows = [{"loss": torch.tensor(2.5), "loss_seg_p": torch.tensor(0.125),
             "convex": -4.0, "lr": torch.tensor(2.5e-4)},
            {"loss": torch.tensor(1.5), "loss_seg_p": torch.tensor(0.25),
             "convex": -3.0, "lr": torch.tensor(2.4e-4)}]
    tw, jw = (utils.MetricWriter(str(tmp_path / "sub" / f"{n}.csv")) for n in "tj")
    for i, m in enumerate(rows):
        tw.write(i * 100, m)
        jw.write(i * 100, {k: np.float32(float(v)) for k, v in m.items()})
    tw.close()
    jw.close()
    got, want = _rows(tmp_path / "sub" / "t.csv"), _rows(tmp_path / "sub" / "j.csv")
    assert got[0] == want[0] == ["step", "time", "loss", "loss_seg_p", "convex", "lr"]
    assert len(got) == 3
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] and g[2:] == w[2:]
        assert abs(float(g[1]) - time.time()) < 60
    utils.MetricWriter(None).write(0, rows[0])  # no path: writes nothing


def test_step_timer():
    timer = utils.StepTimer()
    assert timer.rate() >= 0.0
    timer.tick()
    timer.tick(2)
    time.sleep(0.01)
    assert timer.count == 3 and 0 < timer.rate() < 3 / 0.01
    timer.reset()
    assert timer.count == 0


def test_log_lines_equal_jax():
    m = {"loss_seg_p": torch.tensor(1.23456), "loss_seg_y": 2.0, "convex": -1.0,
         "volume": 0.5, "anchor": 3.0, "place": 0.25, "loss_seg1": 0.75,
         "loss_seg2": torch.tensor(0.5)}
    fm = {k: float(v) for k, v in m.items()}
    assert utils.format_simt_line(7, 250000, m) == jutils.format_simt_line(7, 250000, fm)
    assert utils.format_warmup_line(7, 150000, m) == jutils.format_warmup_line(7, 150000, fm)


def test_plot_ntm_writes_a_png(tmp_path):
    t = torch.softmax(torch.randn(8, 5, generator=torch.Generator().manual_seed(0)), 1)
    path = utils.plot_ntm(t, str(tmp_path / "vis" / "NTM1_0.png"), title="NTM1_0")
    with Image.open(path) as img:
        assert img.format == "PNG" and img.size[0] > 100
