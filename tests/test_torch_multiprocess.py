"""The port's loop, evaluation and CLIs across processes (simt_tpu_torch/train/loop.py,
eval/evaluate.py, tools/common.py): two gloo ranks, each a spawned process with one
thread, on the layers (1,1,1,1) DeepLabv2 (19 + 15 classes, float32) over a synthetic
fixture's list files (64x32 crops).

  - ``train()`` on a data=2 mesh, each rank's loader decoding its half of every global
    batch (``process_shard``), against one process at the doubled batch over the same
    global batches (2 steps), iter_size 1 and 2, with the bounds and exclusions of
    tests/test_multihost.py: the first loss line equal, the continuous metrics within
    5e-3, both ranks' metrics and parameters equal, the ``mesh:`` line; with the
    sharded in-loop evaluation after step 1 (both ranks read one mIoU, keep the same
    best step), rank 0's CSV and snapshots;
  - ``evaluate(shard=)`` over 3 val images on 2 ranks (2 and 1 images): the summed
    histogram equal to one process's exactly, with the shard given and by default;
    ``evaluate(mesh=)`` on a spatial=2 mesh (the head split by output rows) equal too;
  - the CLIs with ``--coordinator``, ``--num-processes``, ``--process-id`` and
    ``--mesh-spatial`` (tools/test.py) or ``--mesh-data`` (tools/train_simt.py) in two
    fresh processes: one mIoU on both ranks, two steps on both ranks;
  - ``train_simt --mesh-spatial 2 --cache-teacher`` (each image's rows split over two
    processes, the teacher cache's teacher H-sharded, the row-split evaluation after
    step 1) against the same CLI in one process over the
    same batches, with the bounds above: the continuous metrics within 5e-3, both
    ranks' metrics and parameters equal, rank 0's CSV and snapshots;
  - ``train()`` of the warmup stage for DeepLabv3 and DeepLab-VGG (full width, 19
    classes) on a spatial=2 mesh against one process over the same batches (2 steps):
    the step, both ranks' metrics and states equal, the losses within 5e-3.
"""

import csv
import dataclasses
import multiprocessing
import os

import numpy as np
import pytest
import torch

from simt_tpu_torch import config as tconfig
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture
from simt_tpu_torch.eval import evaluate
from simt_tpu_torch.models import ResNetMulti, init_weights
from simt_tpu_torch.parallel import make_mesh
from simt_tpu_torch.tools import common
from simt_tpu_torch.train import loop

from test_torch_parallel import RankPool, _free_port

C, O = 19, 15
CROP = (64, 32)  # (w, h)
CONTINUOUS = ("loss_seg_y", "loss_seg_p", "convex", "volume")


def _tiny(num_classes=19, open_classes=0, openset=False, *, dtype,
          aspp_effective_branches=2):
    return ResNetMulti(num_classes, open_classes, openset, layers=(1, 1, 1, 1), dtype=dtype,
                       aspp_effective_branches=aspp_effective_branches)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool()
    yield pool
    pool.close()


@pytest.fixture
def one_thread():
    """This process's one-process references on one thread, as the ranks run: under a
    loaded machine the ranks' collectives wait on their peers' scheduling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    paths = make_cityscapes_fixture(str(root / "cs"), n_train=12, n_val=3, image_wh=CROP,
                                    num_classes=C)
    cd = str(root / "cd.npy")
    np.save(cd, (np.ones(C) / C).astype(np.float32))
    return paths, cd, root


def _cfg(paths, cd, iter_size, batch_size, data_axis, snapshot_dir=""):
    base = tconfig.TrainConfig()
    return tconfig.TrainConfig(
        stage="simt",
        model=tconfig.ModelConfig(num_classes=C, open_classes=O, openset=True,
                                  compute_dtype="float32"),
        optim=tconfig.OptimConfig(num_steps=100, iter_size=iter_size),
        simt=dataclasses.replace(base.simt, class_dist=cd, inner_w_steps=2),
        data=dataclasses.replace(base.data, root=paths["root"],
                                 list_path=paths["pseudo_lst"], crop_size=CROP,
                                 batch_size=batch_size, num_workers=2,
                                 process_workers=False),
        mesh=tconfig.MeshConfig(data_axis=data_axis),
        num_steps_stop=2, save_pred_every=1, snapshot_dir=snapshot_dir, log_every=1)


def _eval_fn(cfg, paths):
    def eval_fn(model):
        return evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                        gt_dir=paths["gt_dir"], device="cpu", print_fn=lambda s: None,
                        **common.scaled_protocol(cfg))
    return eval_fn


def _train(cfg, paths, csv_path=None):
    lines = []
    out = loop.train(cfg, eval_fn=_eval_fn(cfg, paths), print_fn=lines.append,
                     csv_path=csv_path, device="cpu")
    sd = {k: v.numpy() for k, v in out["state"].model.state_dict().items()}
    return (lines, out["final_metrics"], out["best_step"], out["best_miou"], sd,
            out["state"].t1.param.detach().numpy())


def _train_rank(rank, paths, cd, iter_size, snaps, csv_path):
    loop.deeplab_multi = _tiny
    return _train(_cfg(paths, cd, iter_size, 1, 2, snaps), paths, csv_path)


@pytest.mark.parametrize("iter_size", [1, 2])
def test_two_process_train_matches_one_process(ranks, fixture, monkeypatch, one_thread,
                                               iter_size):
    paths, cd, root = fixture
    snaps = str(root / f"snaps{iter_size}")
    csv_path = str(root / f"m{iter_size}.csv")
    ranks.submit(_train_rank, paths, cd, iter_size, snaps, csv_path)
    monkeypatch.setattr(loop, "deeplab_multi", _tiny)
    lines1, single, _, _, _, _ = _train(_cfg(paths, cd, iter_size, 2, 1), paths)
    (l0, m0, b0, miou0, sd0, t0), (l1, m1, b1, miou1, sd1, t1) = ranks.results()
    for lines in (l0, l1):
        assert "mesh: data=2 spatial=1 over 2 devices" in lines
        first = [s for s in lines if s.startswith("iter =")][0]
        assert first == [s for s in lines1 if s.startswith("iter =")][0]
    assert m0 == m1 and (b0, miou0) == (b1, miou1) and b0 == 1
    assert np.array_equal(t0, t1) and all(np.array_equal(sd0[k], sd1[k]) for k in sd0)
    for k in CONTINUOUS:
        assert abs(m0[k] - single[k]) < 5e-3 * max(1.0, abs(single[k])), (k, m0[k],
                                                                          single[k])
    assert sorted(os.listdir(snaps)) == ["step_00000001", "step_00000002"]
    with open(csv_path) as f:
        assert [r["step"] for r in csv.DictReader(f)] == ["0", "1"]


def _model():
    model = _tiny(C, O, True, dtype=torch.float32)
    return init_weights(model, torch.Generator().manual_seed(3))


def _evaluate(paths, **kw):
    cfg = tconfig.TrainConfig().replace(data=dataclasses.replace(
        tconfig.TrainConfig().data, crop_size=CROP))
    return evaluate(_model(), data_root=paths["root"], val_list=paths["val_txt"],
                    gt_dir=paths["gt_dir"], device="cpu", return_hist=True,
                    print_fn=lambda s: None, **common.scaled_protocol(cfg), **kw)[1]


def _eval_rank(rank, paths):
    return {"shard": _evaluate(paths, shard=(rank, 2)), "default": _evaluate(paths),
            "spatial": _evaluate(paths, mesh=make_mesh(1, 2, device="cpu"))}


def test_sharded_and_row_split_evaluation_equal_one_process(ranks, fixture, one_thread):
    paths, _, _ = fixture
    whole = _evaluate(paths)
    assert whole.sum() > 0
    for got in ranks.run(_eval_rank, paths):
        for k, hist in got.items():
            np.testing.assert_array_equal(hist, whole, err_msg=k)


def _summary(out):
    """A train CLI's summary as plain values: the step, the final metrics, the best
    step and every tensor of the model and the NTM parameters."""
    st = out["state"]
    return {"step": st.step, "metrics": out["final_metrics"], "best": out["best_step"],
            "params": {**{k: v.numpy() for k, v in st.model.state_dict().items()},
                       **{k: getattr(st, k).param.detach().numpy()
                          for k in ("t1", "t2", "w1", "w2")}}}


def _cli_rank(rank, port, argv, queue):
    from simt_tpu_torch.tools import test as test_cli
    from simt_tpu_torch.tools import train_simt

    torch.set_num_threads(1)
    loop.deeplab_multi = _tiny
    main = {"test": test_cli.main, "train": train_simt.main,
            "train_summary": train_simt.main}[argv[0]]
    try:
        out = main(argv[1:] + ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                               "2", "--process-id", str(rank)])
        queue.put((rank, {"test": lambda o: o, "train": lambda o: o["state"].step,
                          "train_summary": _summary}[argv[0]](out)))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        queue.put((rank, repr(e)))


def _cli(argv, timeout=240.0):
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_cli_rank, args=(r, port, argv, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(2)]


EVAL_CLI = ["--synthetic", "--device", "cpu", "--compute-dtype", "float32"]


def test_clis_take_the_process_group_and_mesh_flags():
    (a, b) = _cli(["test"] + EVAL_CLI + ["--mesh-spatial", "2"])
    assert a == b and isinstance(a, float) and 0.0 <= a <= 100.0, (a, b)
    steps = _cli(["train"] + EVAL_CLI + ["--input-size-target", "64,32", "--mesh-data",
                                         "2", "--num-steps-stop", "2"])
    assert steps == [2, 2]


def test_spatial_train_cli_on_two_processes_matches_one_process(tmp_path, monkeypatch,
                                                                one_thread):
    from simt_tpu_torch.tools import train_simt

    argv = EVAL_CLI + ["--input-size-target", "64,32", "--num-steps-stop", "2",
                       "--save-pred-every", "1", "--log-every", "1", "--cache-teacher"]
    snaps, csv_path = str(tmp_path / "snaps"), str(tmp_path / "m.csv")
    ranks = _cli(["train_summary"] + argv + ["--mesh-spatial", "2", "--snapshot-dir",
                                             snaps, "--csv", csv_path])
    assert all(isinstance(r, dict) for r in ranks), ranks
    monkeypatch.setattr(loop, "deeplab_multi", _tiny)
    single = _summary(train_simt.main(argv))
    r0, r1 = ranks
    assert r0["step"] == r1["step"] == single["step"] == 2
    assert r0["metrics"] == r1["metrics"] and r0["best"] == r1["best"] == 1
    assert all(np.array_equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    for k in CONTINUOUS:
        want = single["metrics"][k]
        assert abs(r0["metrics"][k] - want) < 5e-3 * max(1.0, abs(want)), (k, want)
    assert sorted(os.listdir(snaps)) == ["step_00000001", "step_00000002"]
    with open(csv_path) as f:
        assert [r["step"] for r in csv.DictReader(f)] == ["0", "1"]


def _arch_cfg(paths, arch, spatial):
    base = tconfig.TrainConfig()
    return tconfig.TrainConfig(
        stage="warmup",
        model=tconfig.ModelConfig(arch=arch, num_classes=C, compute_dtype="float32"),
        optim=tconfig.OptimConfig(num_steps=100),
        data=dataclasses.replace(base.data, root=paths["root"],
                                 list_path=paths["pseudo_lst"], crop_size=CROP,
                                 batch_size=1, num_workers=2, process_workers=False),
        mesh=tconfig.MeshConfig(spatial_axis=spatial),
        num_steps_stop=2, snapshot_dir="", log_every=1)


def _arch_train(paths, arch, spatial):
    out = loop.train(_arch_cfg(paths, arch, spatial), print_fn=lambda s: None,
                     device="cpu")
    return out["state"], out["final_metrics"]


def _arch_rank(rank, arch, paths):
    """One rank's run, its state held to rank 0's in the rank (bit for bit)."""
    import torch.distributed as dist

    state, metrics = _arch_train(paths, arch, 2)
    mine = torch.cat([v.detach().reshape(-1) for v in state.model.state_dict().values()
                      if v.is_floating_point()])
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    return state.step, metrics, bool(torch.equal(mine, theirs))


@pytest.mark.parametrize("arch", ["deeplabv3", "deeplab_vgg"])
def test_train_on_rows_of_the_other_families_matches_one_process(ranks, fixture, one_thread,
                                                                  arch):
    paths, _, _ = fixture
    ranks.submit(_arch_rank, arch, paths)
    state, single = _arch_train(paths, arch, 1)
    (s0, m0, same0), (s1, m1, same1) = ranks.results()
    assert s0 == s1 == state.step == 2
    assert m0 == m1 and same0 and same1
    for k in ("loss_seg1", "loss_seg2"):
        assert abs(m0[k] - single[k]) < 5e-3 * max(1.0, abs(single[k])), (k, m0[k],
                                                                          single[k])
