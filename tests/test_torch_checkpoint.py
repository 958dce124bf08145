"""The port's full-state snapshots and the loop around them (simt_tpu_torch/train/
checkpoint.py, train/loop.py), on the CPU at tests/torch_loop_helpers.py's tiny
geometry:

  - a save/restore round trip of either stage's state equal bit for bit (weights,
    BatchNorm statistics, SGD momentum, NTM/W parameters with their Adam moments and
    counts, step); a snapshot that does not fit the state raises before loading;
  - ``latest_step`` / ``delete``, and a half-written snapshot never counts;
  - the ``.npz`` warm start (``load_warmstart``) equal to the ``.pth`` one;
  - the loop: the best-mIoU keep/delete sequence, a run that evaluates at step 2 (the
    real two-scale ``evaluate`` on a fixture) equal bit for bit to one that does not,
    a run resumed at step 2 equal bit for bit to one that was not interrupted, the
    ``iter_size`` stacking equal to the step on a stacked batch, the profiler's
    trace and the NTM heat-maps.
"""

import copy
import os

import numpy as np
import pytest
import torch

from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch
from simt_tpu_torch.eval import evaluate
from simt_tpu_torch.train import (checkpoint, create_simt_state, create_warmup_state,
                                  loop, make_simt_step, make_warmup_step)

from torch_loop_helpers import C, HW, batches, configs, read_csv, tiny_models


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain loss core's CPU reductions over 19 classes sum in
    another order from run to run with several threads (T1/T2 one ulp apart), so
    runs are compared bit for bit on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(cfg, seed=0):
    student, teacher = loop.build_models(cfg.replace(random_seed=seed))
    if cfg.stage == "simt":
        return create_simt_state(student, teacher, cfg,
                                 torch.Generator().manual_seed(seed), "cpu")
    return create_warmup_state(student, cfg, "cpu")


def _trained(cfg, steps=1):
    st = _state(cfg)
    step = make_simt_step(cfg) if cfg.stage == "simt" else make_warmup_step(cfg)
    it = batches()
    for _ in range(steps):
        step(st, next(it))
    return st


def _tensors(st):
    """Every tensor of a state by name, optimizer moments and counts included."""
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    opts = {"model_opt": st.model_opt}
    if hasattr(st, "teacher"):
        out.update({f"teacher.{k}": v for k, v in st.teacher.state_dict().items()})
        for k in ("t1", "t2", "w1", "w2"):
            out[k] = getattr(st, k).param.detach()
            opts[k] = getattr(st, k).opt
    for name, opt in opts.items():
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in s.items()})
    return out


@pytest.mark.parametrize("stage", ["simt", "warmup"])
def test_round_trip_is_bit_exact(tmp_path, monkeypatch, stage):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, stage)
    st = _trained(cfg)
    path = checkpoint.save(st, str(tmp_path / "snaps"), 7)
    assert os.path.basename(path) == "step_00000007"
    assert checkpoint.snapshot_bytes(str(tmp_path / "snaps"), 7) > 0
    fresh = _state(cfg, seed=5)  # other weights, no optimizer state yet
    assert checkpoint.restore(fresh, str(tmp_path / "snaps")) is fresh
    want, got = _tensors(st), _tensors(fresh)
    assert fresh.step == st.step == 1
    assert set(got) == set(want) and any("momentum_buffer" in k for k in want)
    if stage == "simt":
        assert any(k.endswith("exp_avg_sq") for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert fresh.model.training and (stage == "warmup" or not fresh.teacher.training)


def test_a_snapshot_that_does_not_fit_raises_before_loading(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    _, simt = configs(tmp_path, "simt")
    checkpoint.save(_state(configs(tmp_path, "warmup")[1]), str(tmp_path / "w"), 1)
    checkpoint.save(_state(simt.replace(model=simt.model.__class__(
        num_classes=C, open_classes=2, compute_dtype="float32"))), str(tmp_path / "o2"), 1)
    for snap in ("w", "o2"):
        st = _state(simt)
        before = copy.deepcopy(_tensors(st))
        with pytest.raises(ValueError, match="does not match the current train-state"):
            checkpoint.restore(st, str(tmp_path / snap))
        assert all(torch.equal(v, before[k]) for k, v in _tensors(st).items())
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(_state(simt), str(tmp_path / "empty"))


def test_latest_step_and_delete(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    d = str(tmp_path / "snaps")
    assert checkpoint.latest_step(d) is None
    st = _state(configs(tmp_path, "warmup")[1])
    for step in (2, 10, 4):
        checkpoint.save(st, d, step)
    os.makedirs(os.path.join(d, ".step_00000099.tmp"))  # a save cut short
    os.makedirs(os.path.join(d, "step_notanumber"))
    assert checkpoint.latest_step(d) == 10
    checkpoint.delete(d, 10)
    checkpoint.delete(d, 11)  # absent: nothing to do
    assert checkpoint.latest_step(d) == 4
    assert sorted(os.listdir(d)) == [".step_00000099.tmp", "step_00000002",
                                     "step_00000004", "step_notanumber"]


def test_npz_warm_start_equals_pth(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "warmup")
    src = loop.build_models(cfg.replace(random_seed=3))[0]
    sd = {"Scale." + k: v for k, v in src.state_dict().items()}
    torch.save(sd, tmp_path / "w.pth")
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in sd.items()})
    models = {}
    for ext in ("pth", "npz"):
        models[ext] = loop.build_models(cfg)[0]
        rep = checkpoint.load_warmstart(models[ext], str(tmp_path / f"w.{ext}"),
                                        strip_prefix=6)
        assert not rep["missing"] and not rep["skipped"] and not rep["unused"], rep
    for k, v in src.state_dict().items():
        assert torch.equal(models["npz"].state_dict()[k], v), k
        assert torch.equal(models["pth"].state_dict()[k], v), k
    # train() takes the .npz too, with the warmup stage's k[6:].
    lines = []
    loop.train(cfg.replace(restore_from=str(tmp_path / "w.npz"), num_steps_stop=1),
               batch_iter=batches(), print_fn=lines.append, device="cpu")
    assert any(f"loaded {len(sd)} tensors" in s and "(missing 0, skipped 0)" in s
               for s in lines), lines


def test_best_snapshot_is_kept_and_the_previous_one_deleted(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    d = str(tmp_path / "snaps")
    _, cfg = configs(tmp_path, "warmup", snapshot_dir=d, save_pred_every=1,
                     num_steps_stop=5)
    scores, seen = iter([10.0, 5.0, 20.0, 20.0]), []

    def eval_fn(model):
        seen.append(sorted(os.listdir(d)) if os.path.isdir(d) else [])
        return next(scores)

    lines = []
    out = loop.train(cfg, batch_iter=batches(), eval_fn=eval_fn, print_fn=lines.append,
                     device="cpu")
    assert seen == [[], ["step_00000001"], ["step_00000001"], ["step_00000003"]]
    assert out["best_miou"] == 20.0 and out["best_step"] == 3
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000005"]
    assert sum("Saving model with mIoU:" in s for s in lines) == 2
    assert len(out["eval_seconds"]) == 4 and out["state"].model.training


def test_evaluating_at_step_2_does_not_change_training(tmp_path, monkeypatch, one_thread):
    """The real two-scale evaluation on a fixture at step 2 (19 known classes, as the
    evaluation needs): the weights, BN statistics, optimizer state and losses of the
    run equal those of a run without it, bit for bit."""
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "simt", save_pred_every=2, num_steps_stop=4)
    cd = str(tmp_path / "cd19.npy")
    np.save(cd, (np.ones(19) / 19).astype(np.float32))
    cfg = cfg.replace(model=cfg.model.__class__(num_classes=19, open_classes=3,
                                                compute_dtype="float32"),
                      simt=cfg.simt.__class__(class_dist=cd, inner_w_steps=2))
    paths = make_cityscapes_fixture(str(tmp_path / "fx"), n_train=0, n_val=2,
                                    image_wh=(HW[1], HW[0]))

    def eval_fn(model):
        return evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                        gt_dir=paths["gt_dir"], scales=((64, 32), (80, 40)),
                        out_hw=HW, device="cpu", print_fn=lambda s: None)

    b = synthetic_batch(1, HW, 19, seed=0)

    def const():
        while True:
            yield b

    runs = {}
    for name, fn in (("eval", eval_fn), ("none", None)):
        runs[name] = loop.train(cfg, batch_iter=const(), eval_fn=fn, device="cpu",
                                csv_path=str(tmp_path / f"{name}.csv"),
                                print_fn=lambda s: None)
    assert len(runs["eval"]["eval_seconds"]) == 1 and not runs["none"]["eval_seconds"]
    assert runs["eval"]["best_step"] == 2
    a, b_ = _tensors(runs["eval"]["state"]), _tensors(runs["none"]["state"])
    for k, v in b_.items():
        assert torch.equal(a[k], v), k
    rows = [[{k: v for k, v in r.items() if k != "time"} for r in read_csv(tmp_path / f)]
            for f in ("eval.csv", "none.csv")]
    assert rows[0] == rows[1] and len(rows[0]) == 4
    st = runs["eval"]["state"]
    assert st.model.training and not st.teacher.training


def test_resumed_run_equals_the_uninterrupted_one(tmp_path, monkeypatch, one_thread):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "simt", num_steps_stop=4)
    whole = loop.train(cfg.replace(snapshot_dir=str(tmp_path / "a")), batch_iter=batches(),
                       print_fn=lambda s: None, csv_path=str(tmp_path / "a.csv"),
                       device="cpu")
    part = cfg.replace(snapshot_dir=str(tmp_path / "b"))
    loop.train(part, batch_iter=batches(), print_fn=lambda s: None, max_steps=2,
               device="cpu")
    assert checkpoint.latest_step(str(tmp_path / "b")) == 2
    resumed = loop.train(part, batch_iter=batches(), print_fn=lambda s: None,
                         csv_path=str(tmp_path / "b.csv"), resume=True, device="cpu")
    want, got = _tensors(whole["state"]), _tensors(resumed["state"])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    a = [{k: v for k, v in r.items() if k != "time"} for r in read_csv(tmp_path / "a.csv")]
    b = [{k: v for k, v in r.items() if k != "time"} for r in read_csv(tmp_path / "b.csv")]
    assert b == a[2:] and [r["step"] for r in b] == ["2", "3"]


def test_iter_size_stacks_loader_batches(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "warmup", num_steps_stop=1)
    cfg = cfg.replace(optim=cfg.optim.__class__(num_steps=100, iter_size=2))
    subs = [synthetic_batch(1, HW, C, seed=s) for s in (0, 1)]
    want = _state(cfg, seed=cfg.random_seed)  # train()'s own init
    m = make_warmup_step(cfg)(want, {k: np.stack([s[k] for s in subs]) for k in subs[0]})
    out = loop.train(cfg, batch_iter=iter([{**s, "name": ["x"]} for s in subs]),
                     print_fn=lambda s: None, device="cpu")
    assert out["final_metrics"] == {k: float(v) for k, v in m.items()}
    for k, v in _tensors(want).items():
        assert torch.equal(_tensors(out["state"])[k], v), k


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "warmup", num_steps_stop=1)
    loop.train(cfg, batch_iter=batches(), print_fn=lambda s: None, device="cpu",
               profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in f.read(2000)


def test_plot_ntm_every_writes_both_heat_maps(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "simt", num_steps_stop=2)
    loop.train(cfg, batch_iter=batches(), print_fn=lambda s: None, device="cpu",
               plot_ntm_every=2, plot_ntm_dir=str(tmp_path / "vis"))
    assert sorted(os.listdir(tmp_path / "vis")) == ["NTM1_0.png", "NTM2_0.png"]


def test_train_raises_for_the_teacher_cache_and_without_a_card(tmp_path):
    _, cfg = configs(tmp_path, "simt")
    with pytest.raises(ValueError, match="A-5"):
        loop.train(cfg.replace(simt=cfg.simt.__class__(cache_teacher=True)),
                   batch_iter=batches(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            loop.train(cfg, batch_iter=batches())
