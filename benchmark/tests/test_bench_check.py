"""The plain reference against the port on the CPU in float32 at a tiny size, for each
cell, through the harness's whole run but the look for a card; then the same run with
the timed path broken underneath, once for each fault the cell can have, and
``correct`` has to come out false."""

import importlib
import time

import pytest
import torch

from benchmark import harness

TRAIN = ["simt_train_b16", "warmup_train_b16"]


def _run(name, tiny, seconds=0.3):
    torch.manual_seed(0)
    run = harness.Run(name, 2 ** 31 + 99, "cpu", overrides=tiny)
    return harness.run_cell(run, seconds, False, time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + ["simt_eval_b8"])
def test_the_port_agrees_with_the_reference(name, tiny):
    out = _run(name, tiny)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] < 1e-2  # float32 on both sides
    assert res["metrics"] == {}  # no device metric from a CPU run


def _step_class(name):
    from simt_tpu_torch.train.simt import SimTStep
    from simt_tpu_torch.train.warmup import WarmupStep

    return SimTStep if name == "simt_train_b16" else WarmupStep


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(name, tiny, monkeypatch):
    cls = _step_class(name)
    call = cls.__call__

    def unchanged(self, st, batch):
        keep = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        m = call(self, st, batch)
        st.model.load_state_dict(keep)
        return m

    monkeypatch.setattr(cls, "__call__", unchanged)
    res = _run(name, tiny)["result"]
    assert not res["correct"]
    change = [c for k, c in res["checks"].items() if k.startswith("change_gap")]
    assert change and all(c["value"] > c["limit"] for c in change)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_is_not_correct(name, tiny, monkeypatch):
    cls = _step_class(name)
    call = cls.__call__

    def half(self, st, batch):
        n = batch["label"].shape[0] // 2
        return call(self, st, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(cls, "__call__", half)
    assert not _run(name, tiny)["result"]["correct"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny, monkeypatch):
    evaluate = importlib.import_module("simt_tpu_torch.eval.evaluate")

    fused = evaluate.multiscale_argmax_hist

    def altered(a, b, gt, **kw):
        return fused(a, b, torch.where(gt < 18, gt + 1, gt), **kw)

    monkeypatch.setattr(evaluate, "multiscale_argmax_hist", altered)
    res = _run("simt_eval_b8", tiny)["result"]
    assert not res["correct"]


def test_an_inner_w_loop_that_takes_no_step_is_not_correct(tiny, monkeypatch):
    simt = importlib.import_module("simt_tpu_torch.train.simt")
    monkeypatch.setattr(simt, "inner_w_steps", lambda st, c, o, steps: None)
    res = _run("simt_train_b16", tiny)["result"]
    assert not res["correct"]
    ntm = res["checks"]["ntm_change_gap"]
    assert ntm["value"] > ntm["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_heads_at_the_trunks_rate_are_not_correct(name, tiny, monkeypatch):
    from benchmark import program

    stage = "simt" if name == "simt_train_b16" else "warmup"
    build = getattr(program, stage)

    def one_rate(*args):
        state, step = build(*args)
        for group in state.model_opt.param_groups:
            group["lr_mult"] = 1.0
        return state, step

    monkeypatch.setattr(program, stage, one_rate)
    res = _run(name, tiny)["result"]
    assert not res["correct"]
    head = res["checks"]["head_change_gap"]
    assert head["value"] > head["limit"]
