"""The port's soak tool (simt_tpu_torch/tools/soak.py), the counterpart of
tools/soak.py, on the CPU at layers (1,1,1,1) and 32x64 with 6 steps in windows of 3:

  - its one JSON line has the JAX tool's keys (``kernel_builds_after_warmup`` in place
    of ``recompiles``, plus ``reserved_growth_bytes`` and ``floor``, null on the CPU)
    and passes;
  - it exits 1 when a metric is non-finite, when ``--min-rate`` is out of reach and when
    a kernel is built after the warm-up;
  - its flags and defaults are the JAX tool's, plus ``--device`` (the card by default);
  - ``host_probe`` (the host's speed and the steps' rate, before and after one profiler
    session) prints its one JSON line.
"""

import json

import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.kernels import _build
from simt_tpu_torch.tools import host_probe, soak

KW = dict(layers=(1, 1, 1, 1), hw=(32, 64))
ARGV = ["--device", "cpu", "--steps", "6", "--window", "3"]
KEYS = {"metric", "value", "unit", "windows", "steps", "finite",
        "kernel_builds_after_warmup", "reserved_growth_bytes", "floor", "pass"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny steps run faster on one thread than on threads that the test run's
    other workers share."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_prints_one_line_with_the_jax_keys_and_passes(capsys):
    out = soak.main(ARGV, **KW)
    line = _line(capsys)
    assert line == out and set(line) == KEYS
    assert (line["metric"], line["unit"]) == ("simt_soak_steps_per_sec_min_window",
                                              "steps/s")
    assert line["steps"] == 6 and len(line["windows"]) == 2
    assert line["value"] == min(line["windows"]) > 0
    assert line["finite"] is True and line["kernel_builds_after_warmup"] == 0
    assert line["reserved_growth_bytes"] is None and line["floor"] is None
    assert line["pass"] is True


def _failed(capsys, argv) -> dict:
    with pytest.raises(SystemExit) as e:
        soak.main(argv, **KW)
    assert e.value.code == 1
    line = _line(capsys)
    assert set(line) == KEYS and line["pass"] is False
    return line


def test_exits_1_on_a_non_finite_metric(monkeypatch, capsys):
    real = soak.synthetic_batch

    def nan_image(**kw):
        b = real(**kw)
        b["image"][0, 0, 0, 0] = np.nan
        return b

    monkeypatch.setattr(soak, "synthetic_batch", nan_image)
    line = _failed(capsys, ARGV)
    assert line["finite"] is False


def test_exits_1_when_the_min_rate_is_out_of_reach(capsys):
    line = _failed(capsys, ARGV + ["--min-rate", "1e9"])
    assert line["finite"] is True and line["floor"] == 1e9
    assert line["value"] < line["floor"]


def test_exits_1_when_a_kernel_is_built_after_the_warmup(monkeypatch, capsys):
    real = soak.bench.simt_setup

    def setup(dev, **kw):
        cfg, state, step = real(dev, **kw)
        calls = []

        def late_build(state, batch):
            calls.append(1)
            if len(calls) == soak.WARM + 2:  # inside the first window
                monkeypatch.setattr(_build, "compiles", _build.compiles + 1)
            return step(state, batch)
        return cfg, state, late_build

    monkeypatch.setattr(soak.bench, "simt_setup", setup)
    line = _failed(capsys, ARGV)
    assert line["kernel_builds_after_warmup"] == 1 and line["finite"] is True


def test_flags_are_the_jax_tools_plus_device():
    args = soak.build_parser().parse_args([])
    assert vars(args) == {"steps": 600, "window": 100, "min_rate": None,
                          "device": "cuda"}


def test_host_probe_prints_one_line_of_rounds_before_and_after_a_profiler_session(capsys):
    out = host_probe.main(["--device", "cpu", "--rounds", "2"], loop_n=1000, steps=1,
                          **KW)
    line = _line(capsys)
    assert line == out and set(line) == {"python_loop_s", "steps_per_sec", "device"}
    assert line["device"] == "cpu"
    for key in ("python_loop_s", "steps_per_sec"):
        assert set(line[key]) == {"before", "after"}
        assert all(len(v) == 2 and min(v) > 0 for v in line[key].values())
