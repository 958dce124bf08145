"""The port's bench entry (simt_tpu_torch/tools/bench.py, bench_eval.py,
bench_warmup.py) on the CPU.

  - each mode (resident, ``--pipeline``, ``--pipeline --crop-cache``, ``--eval``,
    ``--warmup``) runs at a tiny geometry (layers (1,1,1,1), 32x64 crops, a few steps)
    and prints exactly one line on stdout: JSON with the JAX bench's keys and its metric
    names at that geometry;
  - the run functions default to the JAX bench's geometry and step counts, where the
    names above read ``..._512x1024`` and ``..._1024x2048``, the JAX bench's;
  - ``--pipeline --cache-teacher`` feeds the step from the teacher cache and adds the
    JAX bench's ``_teacher_cache`` suffix; without ``--pipeline`` it exits;
  - without a card and without ``--device cpu`` every mode raises.
"""

import inspect
import json

import pytest
import torch

from simt_tpu_torch.tools import bench, bench_eval, bench_warmup

TINY = dict(hw=(32, 64), layers=(1, 1, 1, 1), warm=1, steps=2)
PIPE = dict(TINY, image_wh=(128, 64), n_images=2, loader_items=2)
KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny steps run faster on one thread than on threads that the test run's
    other workers share."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _one_line(capsys):
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert KEYS <= set(line), line
    assert line["value"] > 0 and line["vs_baseline"] > 0
    return line


@pytest.mark.parametrize("argv,kw,metric,unit", [
    ([], TINY, "simt_train_steps_per_sec_bs1_32x64", "steps/s"),
    (["--pipeline"], PIPE, "simt_train_steps_per_sec_bs1_32x64_with_input_pipeline",
     "steps/s"),
    (["--pipeline", "--crop-cache"], dict(PIPE, warm=None),
     "simt_train_steps_per_sec_bs1_32x64_with_input_pipeline_crop_cache", "steps/s"),
    (["--eval"], TINY, "eval_images_per_sec_two_scale_64x128", "img/s"),
    (["--warmup"], TINY, "warmup_train_steps_per_sec_bs1_32x64", "steps/s"),
], ids=["resident", "pipeline", "pipeline_crop_cache", "eval", "warmup"])
def test_each_mode_prints_one_line_with_jax_keys(capsys, argv, kw, metric, unit):
    out = bench.main([*argv, "--device", "cpu"], **kw)
    line = _one_line(capsys)
    assert line == out
    assert line["metric"] == metric and line["unit"] == unit
    if "--warmup" in argv:
        assert line["baseline_is_simt_stage_proxy"] is True


def test_defaults_are_the_jax_bench_geometry_and_step_counts():
    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()}

    assert bench.BASELINE_STEPS_PER_SEC == 1.29 and bench_eval.BASELINE_IMG_PER_SEC == 1.55
    res, pipe = defaults(bench.resident), defaults(bench.pipeline)
    assert (res["batch_size"], res["hw"], res["warm"], res["steps"]) == (1, (512, 1024), 3, 20)
    assert res["layers"] == (3, 4, 23, 3) and res["device"] == "cuda"
    assert (pipe["image_wh"], pipe["hw"], pipe["n_images"], pipe["steps"]) == \
        ((2048, 1024), (512, 1024), 12, 50)
    assert pipe["warm"] is None  # 3, or 14 with the crop cache (n_images + 2)
    ev, wu = defaults(bench_eval.run), defaults(bench_warmup.run)
    assert (ev["hw"], ev["warm"], ev["steps"]) == ((512, 1024), 1, 20)
    assert (wu["hw"], wu["warm"], wu["steps"]) == ((512, 1024), 3, 20)


@pytest.mark.parametrize("argv", [[], ["--pipeline"], ["--pipeline", "--crop-cache"],
                                  ["--eval"], ["--warmup"]])
def test_needs_a_card_unless_the_cpu_is_named(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(argv)
    assert capsys.readouterr().out == ""


def test_eval_and_warmup_tools_are_the_bench_modes(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    for tool in (bench_eval, bench_warmup):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main([])
    with pytest.raises(SystemExit, match="--pipeline"):  # the same parser: --eval prepended
        bench_eval.main(["--cache-teacher"])
    assert capsys.readouterr().out == ""


def test_pipeline_with_the_teacher_cache(capsys):
    out = bench.main(["--pipeline", "--cache-teacher", "--device", "cpu"],
                     **dict(PIPE, warm=None))
    line = _one_line(capsys)
    assert line == out and line["metric"] == (
        "simt_train_steps_per_sec_bs1_32x64_with_input_pipeline_teacher_cache")
    with pytest.raises(SystemExit, match="--pipeline"):
        bench.main(["--cache-teacher", "--device", "cpu"])
