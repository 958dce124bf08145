"""The port's named ranges (``simt_tpu_torch/utils/spans.py``): under a profiler the train
steps and the eval call record their parts, one after another, the trunk conv's calls
inside the forward and the backward, and the loss core one range a direction; with no
profiler and no ``spans`` list the steps enter no range and make no CUDA event; with a
list, the step's CUDA-event spans keep their names. CPU, one block a stage, 32x64
crops."""

import pytest
import torch

from simt_tpu_torch.config import ModelConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.eval.evaluate import make_eval_fn
from simt_tpu_torch.models import ResNetMulti, init_weights
from simt_tpu_torch.ops.kernels.loss_fused import SimTLossCore
from simt_tpu_torch.tools.bench import simt_setup
from simt_tpu_torch.train import create_warmup_state, make_warmup_step
from simt_tpu_torch.utils import spans

LAYERS = (1, 1, 1, 1)
HW = (32, 64)
CPU = torch.device("cpu")

# Each step's CUDA-event spans on one process, in order (grad_sync runs over ranks only).
PARTS = {"simt": ["inner_w", "teacher", "student_forward", "backward", "optimizer"],
         "warmup": ["forward", "backward", "optimizer"]}
FORWARD = {"simt": "student_forward", "warmup": "forward"}


def _warmup_setup():
    cfg = TrainConfig(model=ModelConfig(num_classes=19, compute_dtype="float32"))
    model = init_weights(ResNetMulti(19, 0, False, layers=LAYERS),
                         torch.Generator().manual_seed(0))
    return cfg, create_warmup_state(model, cfg, CPU), make_warmup_step(cfg)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread, as the suite's other step tests: its workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps(one_thread):
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(batch_size=1, hw=HW, num_classes=19,
                                         seed=0).items()}
    torch.manual_seed(0)
    return {"simt": simt_setup(CPU, layers=LAYERS)[1:], "warmup": _warmup_setup()[1:],
            "batch": batch}


def _ranges(run):
    """[(name without the prefix, start_ns, end_ns)], in order of start, of the port's
    ranges that a CPU profiler session recorded over ``run()`` (its raw records:
    building the session's whole event tree costs seconds)."""
    with torch.autograd.profiler.profile() as prof:
        run()
    got = [(e.name()[len(spans.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.kineto_results.events() if e.name().startswith(spans.PREFIX)]
    return sorted(got, key=lambda r: r[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("stage", ["simt", "warmup"])
def test_a_step_records_its_parts_under_the_profiler(steps, stage):
    state, step = steps[stage]
    got = _ranges(lambda: step(state, steps["batch"]))
    parts = [r for r in got if r[0] in PARTS[stage]]
    assert [r[0] for r in parts] == PARTS[stage]
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # one after another
    convs = [r for r in got if r[0] == "conv3x3"]
    for name in (FORWARD[stage], "backward"):
        (part,) = [r for r in parts if r[0] == name]
        assert any(_inside(c, part) for c in convs), name


def test_the_loss_core_records_its_forward_and_backward():
    """``SimTLossCore`` (on CPU tensors its plain versions) is one range a direction."""
    gen = torch.Generator().manual_seed(0)
    c, k = 5, 8  # known classes, known + open
    xcat = torch.randn(1, 4, 8, 2 * k, generator=gen, requires_grad=True)
    t1, t2 = (torch.randn(k, c, generator=gen, requires_grad=True) for _ in range(2))
    label = torch.randint(0, c, (1, 32, 64), generator=gen)
    conf = torch.randint(0, c + 1, (1, 32, 64), generator=gen).to(torch.uint8)

    def run():
        sums = SimTLossCore.apply(xcat, t1, t2, label, conf, c, 0.7, 255)[0]
        sums.sum().backward()

    assert [r[0] for r in _ranges(run)] == ["loss_core", "loss_core"]


def test_the_eval_call_records_its_forwards_and_head():
    model = init_weights(ResNetMulti(19, 15, True, layers=LAYERS),
                         torch.Generator().manual_seed(0)).eval()
    predict_hist = make_eval_fn(model, 19, "simt", (64, 128))[1]
    gen = torch.Generator().manual_seed(0)
    images = [torch.randint(0, 256, (1, h, w, 3), dtype=torch.uint8, generator=gen)
              for h, w in ((32, 64), (40, 80))]
    gt = torch.randint(0, 19, (1, 64, 128), dtype=torch.uint8, generator=gen)
    got = _ranges(lambda: predict_hist(*images, gt))
    assert [r[0] for r in got if r[0] != "conv3x3"] == ["eval_forward", "eval_forward",
                                                        "eval_head"]
    assert sum(r[0] == "conv3x3" for r in got) == 2 * sum(LAYERS)


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("entered with no profiler and no spans list")


class _Event:
    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass


@pytest.mark.parametrize("stage", ["simt", "warmup"])
def test_spans_off_and_on_without_the_profiler(steps, stage, monkeypatch):
    state, step = steps[stage]
    monkeypatch.setattr(spans, "record_function", _Refused)
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    assert step.spans is None
    step(state, steps["batch"])  # neither a range nor an event
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    step.spans = []
    try:
        step(state, steps["batch"])
        assert [name for name, _, _ in step.spans] == PARTS[stage]
        assert all(isinstance(e, _Event) for _, a, b in step.spans for e in (a, b))
    finally:
        step.spans = None
