"""The readers of the program's ranges (``benchmark/program_spans.py``) over hand-made
host-traced sessions: every idle gap goes to the step part whose range holds its start,
the parts and the rest sum to the session's idle, a wrapper's host time (``conv3x3``,
``loss_core``, ``eval_head``) is a union, and a session with no program range reads
None."""

import pytest

from benchmark import harness, program_spans, trace

P = program_spans.PREFIX
WINDOW = 10000.0


def _session(gaps, host, calls=2, window=WINDOW):
    """A session whose device is busy everywhere but in ``gaps`` [(start, end)]."""
    ops, t = [], 0.0
    for a, b in sorted(gaps):
        if a > t:
            ops.append(("kernel", t, a - t))
        t = b
    if t < window:
        ops.append(("kernel", t, window - t))
    return {"calls": calls, "window_us": window, "ops": ops,
            "host": [(n if n.startswith("aten::") else P + n, a, b - a)
                     for n, a, b in host]}


def _simt_steps():
    """Two SimT steps' ranges on the host, with a conv3x3 and a loss_core range in each
    forward and backward (the backward's on another thread: inside the main thread's
    range)."""
    host = []
    for k in range(2):
        o = 100.0 + 4900.0 * k
        host += [("inner_w", o, o + 900),
                 ("teacher", o + 900, o + 1900), ("student_forward", o + 1900, o + 2900),
                 ("conv3x3", o + 2000, o + 2100), ("loss_core", o + 2500, o + 2600),
                 ("backward", o + 2900, o + 4400), ("loss_core", o + 2950, o + 3000),
                 ("conv3x3", o + 3000, o + 3300), ("aten::mm", o + 3100, o + 3200),
                 ("optimizer", o + 4400, o + 4800)]
    return host


def _rec(s, window="train"):
    return {"mix": {"driver": window}, "host_session": s}


def _read(name, rec):
    return harness.reader(name).read(rec)


def test_each_gap_goes_to_the_part_that_held_its_start():
    gaps = [(0.0, 50.0),  # before the first step: outside every part
            (200.0, 230.0),  # inner_w
            (1000.0, 1010.0), (2150.0, 2160.0),  # teacher; student_forward's conv3x3
            (3250.0, 3290.0),  # aten::mm in conv3x3 in backward: backward
            (4600.0, 4620.0),  # optimizer
            (4950.0, 4990.0),  # between the steps: outside
            (7950.0, 8100.0)]  # step 2's backward
    s = _session(gaps, _simt_steps())
    by = program_spans.idle_by_part(s, program_spans.PARTS["train"])
    assert by["inner_w"] == 30.0 and by["teacher"] == 10.0
    assert by["student_forward"] == 10.0 and by["backward"] == 190.0
    assert by["optimizer"] == 20.0 and by[program_spans.OUTSIDE] == 90.0
    idle = WINDOW - trace.busy_us(s)
    assert sum(by.values()) == pytest.approx(idle)
    rec = _rec(s)
    assert _read("inner_w_idle_ms.simt", rec) == pytest.approx(30e-3 / 2)
    assert _read("forward_idle_ms.simt", rec) == pytest.approx(20e-3 / 2)
    assert _read("backward_idle_ms.simt", rec) == pytest.approx(190e-3 / 2)
    assert _read("backward_idle_ms.warmup", rec) == pytest.approx(190e-3 / 2)
    assert _read("forward_idle_ms.warmup", rec) is None  # no range "forward"
    assert _read("forward_idle_ms.eval", rec) is None  # not an eval window


def test_a_gap_beyond_the_longest_named_by_the_breakdown():
    n = trace.ATTRIBUTED_GAPS  # as long as the breakdown names, and one shorter
    long_gaps = [(3000.0 + 5 * i, 3003.0 + 5 * i) for i in range(n)]  # backward, 3 us
    s = _session(long_gaps + [(200.0, 201.0)], _simt_steps())  # inner_w, 1 us
    named = dict(map(tuple, trace.breakdown(s, s)["idle_gaps"]))
    assert named["gaps of at most 1.0 us, not attributed"] == pytest.approx(1e-6)
    assert _read("inner_w_idle_ms.simt", _rec(s)) == pytest.approx(1e-3 / 2)
    assert _read("backward_idle_ms.simt", _rec(s)) == pytest.approx(3 * n * 1e-3 / 2)


def test_conv3x3_host_time_is_the_union_over_threads():
    host = _simt_steps() + [("conv3x3", 2050.0, 2200.0),  # overlaps 2100-2200
                            ("conv3x3", 3150.0, 3250.0)]  # inside 3100-3400
    s = _session([], host)
    # Step 1: 2050-2200 and 3100-3400; step 2: 100 + 300 us.
    assert _read("conv3x3_host_ms.simt", _rec(s)) == pytest.approx(
        (150.0 + 300.0 + 100.0 + 300.0) / 1e3 / 2)
    assert _read("conv3x3_host_ms.warmup", _rec(s)) == pytest.approx(0.425)


def test_loss_core_host_time_is_the_union_over_threads():
    host = _simt_steps() + [("loss_core", 3080.0, 3150.0)]  # overlaps 3050-3100
    s = _session([], host)
    # Step 1: 2600-2700 and 3050-3150; step 2: 100 + 50 us.
    assert _read("loss_core_host_ms.simt", _rec(s)) == pytest.approx(
        (100.0 + 100.0 + 100.0 + 50.0) / 1e3 / 2)
    assert _read("loss_core_host_ms.simt", _rec(s, "eval")) is None


def test_eval_forward_idle_per_call():
    host = [("eval_forward", 0.0, 400.0), ("conv3x3", 100.0, 150.0),
            ("eval_forward", 400.0, 900.0), ("eval_head", 900.0, 1000.0)]
    s = _session([(120.0, 140.0), (500.0, 505.0), (950.0, 990.0)], host, calls=1,
                 window=1000.0)
    assert _read("forward_idle_ms.eval", _rec(s, "eval")) == pytest.approx(25e-3)
    by = program_spans.idle_by_part(s, program_spans.PARTS["eval"])
    assert by == {"eval_forward": 25.0, "eval_head": 40.0, program_spans.OUTSIDE: 0.0}
    assert _read("eval_head_host_ms.eval", _rec(s, "eval")) == pytest.approx(0.1)


@pytest.mark.parametrize("name", ["inner_w_idle_ms.simt", "forward_idle_ms.simt",
                                  "backward_idle_ms.simt", "forward_idle_ms.warmup",
                                  "backward_idle_ms.warmup", "conv3x3_host_ms.simt",
                                  "conv3x3_host_ms.warmup", "forward_idle_ms.eval",
                                  "loss_core_host_ms.simt", "eval_head_host_ms.eval"])
def test_none_without_a_program_range(name):
    window = "eval" if name.endswith(".eval") else "train"
    s = _session([(10.0, 20.0)], [("aten::mm", 0.0, 500.0), ("benchmark_x", 0, 9)])
    assert _read(name, _rec(s, window)) is None
    assert _read(name, {"mix": {"driver": window}}) is None  # an untraced run
    assert program_spans.idle_by_part(s, program_spans.PARTS[window]) is None
