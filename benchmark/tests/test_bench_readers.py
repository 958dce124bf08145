"""The metric readers' arithmetic over hand-made records: rates and the p90 over all
steps, the trace's busy union, the roofline's call list; nothing read on the CPU."""

import pytest

from benchmark import harness, trace
from benchmark.readers import conv3x3_calls


def _rec(driver="train", peak=1 << 30, **window):
    return {"mix": {"driver": driver, "batch": 16}, "config": {}, "setup_s": 12.5,
            "window": {"peak_bytes": peak, **window}}


def test_rates_are_all_images_over_the_wall_seconds():
    rec = _rec(images=16 * 40, wall_s=10.0, step_ms=[250.0] * 40, host_ms=[100.0] * 40)
    assert harness.reader("simt_img_s").read(rec) == 64.0
    assert harness.reader("eval_img_s").read(rec) is None
    ev = _rec("eval", images=8 * 50, wall_s=4.0, host_ms=[10.0, 20.0])
    assert harness.reader("eval_img_s").read(ev) == 100.0
    assert harness.reader("host_ms_per_batch.eval").read(ev) == 15.0
    assert harness.reader("peak_mem_gib").read(rec) == 1.0
    assert harness.reader("setup_s").read(rec) == 12.5


def test_p90_is_over_every_step():
    steps = [float(i) for i in range(1, 101)]  # 100 steps, 10 beyond the p90
    rec = _rec(images=1600, wall_s=1.0, step_ms=steps, host_ms=steps)
    assert harness.reader("warmup_step_ms_p90").read(rec) == pytest.approx(90.1)
    rec["window"]["step_ms"] = [5.0] * 99 + [500.0]
    assert harness.reader("warmup_step_ms_p90").read(rec) == 5.0
    rec["window"]["step_ms"] = [5.0] * 80 + [500.0] * 20  # a stall in a fifth
    assert harness.reader("warmup_step_ms_p90").read(rec) == 500.0


def test_no_device_metric_from_a_cpu_run():
    rec = _rec(peak=None, images=32, wall_s=1.0, step_ms=[], host_ms=[1.0])
    rec["config"] = {"flops_per_image": {"train": 1e12}}
    for name in ("simt_img_s", "warmup_img_s", "peak_mem_gib", "setup_s", "mfu.simt",
                 "host_ms_per_step.warmup", "simt_step_ms_p90"):
        assert harness.reader(name).read(rec) is None, name


def test_busy_is_the_union_of_the_device_intervals():
    s = {"window_us": 100.0, "calls": 1,
         "ops": [("a", 10.0, 20.0), ("b", 25.0, 10.0), ("c", 50.0, 10.0),
                 ("d", 95.0, 20.0)], "host": [("aten::x", 28.0, 30.0)]}
    assert trace.busy_us(s) == 25.0 + 10.0 + 5.0
    assert trace.idle_gaps(s) == [(0.0, 10.0), (35.0, 50.0), (60.0, 95.0)]
    b = trace.breakdown(s, s)
    assert b["device_ops"][0] == ["a", 20.0 / 1e6]
    assert dict(map(tuple, b["idle_gaps"]))["aten::x"] == pytest.approx(15e-6)
    rec = {"mix": {"driver": "train"}, "session": s}
    assert harness.reader("device_idle_share.warmup").read(rec) == pytest.approx(60.0)
    assert harness.reader("launches_per_step.simt").read(rec) == 4.0


def test_the_conv3x3_calls_are_the_steps_launches():
    for name, traffic, launches in (("simt_train_b16", "train_b16", (92, 26)),
                                    ("warmup_train_b16", "train_b16", (66, 33)),
                                    ("simt_eval_b8", "eval_b8", (66, 0))):
        run = harness.Run(name, 1, "cpu")
        calls = conv3x3_calls(run.config, run.mix)
        b4 = sum(c[0] in ("fwd", "dx") for c in calls)
        b5 = sum(c[0] == "wgrad" for c in calls)
        assert (b4, b5) == launches, name


@pytest.mark.parametrize("per_call", [1, 2])
def test_a_roofline_sums_its_launches_and_refuses_a_dropped_record(per_call):
    from benchmark.readers import whole_ms

    name = "B2 loss_fwd"
    ops = [(name, float(i), 6.0 / per_call) for i in range(3 * per_call)]
    s = {"calls": 3, "ops": ops}
    assert whole_ms(s, (name,)) == pytest.approx(18e-3)  # however many launches
    rec = {"mix": {"driver": "train"}, "session": s}
    assert harness.reader("loss_core_launches.simt").read(rec) == per_call
    assert whole_ms({"calls": 3, "ops": ops[1:]}, (name,)) is None  # a record dropped
    assert whole_ms({"calls": 3, "ops": []}, (name,)) is None
