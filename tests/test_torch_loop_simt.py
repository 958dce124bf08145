"""Port vs JAX: ``train()`` of the SimT stage resumed from a JAX snapshot
(simt_tpu_torch/train/loop.py, train/checkpoint.py, models/from_jax.py).

JAX's ``train()`` runs 3 steps and writes its orbax snapshot. The snapshot, restored
to numpy, is carried through ``simt_state_from_jax`` (weights, SGD momentum, the four
NTM/W parameters with their Adam moments and counts, step) into a port state and
written as a port snapshot. Both packages' ``train(resume=True)`` then run steps 3-4
on the same constant batch (tests/torch_loop_helpers.py's tiny geometry). That holds
the loop, the snapshot format, the optimizer moments and the poly LR against JAX at
once:

  - both CSVs: the same columns and steps; every metric at rel 2e-3 / abs 2e-4 (the
    GOLDEN trace's tolerance, tests/test_torch_simt_step.py);
  - each trained parameter's change over the two resumed steps within 1e-2 of its
    L2 norm (measured: at most 3e-3, in layer3; elementwise, one weight of layer3's
    downsample is off by 5.6% of its tensor's largest change: the batch-statistic
    BatchNorm of the random-init trunk amplifies one-ulp differences, as
    tests/test_torch_warmup_step.py says; a wrong LR group or a missed update is off
    by 90% or more); the BN running statistics at 2e-3; T1/T2/W1/W2 at atol 2e-5;
  - the snapshot the port writes at step 5 restores to the state it trained.
"""

import jax
import numpy as np
import pytest
import torch

from simt_tpu.train import checkpoint as jckpt
from simt_tpu.train import loop as jloop
from simt_tpu_torch.models.from_jax import load_state, simt_state_from_jax
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.train import checkpoint, create_simt_state, loop

from torch_loop_helpers import batches, configs, read_csv, tiny_models

METRICS = ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place", "lr")


def test_resume_from_a_jax_snapshot_trains_as_jax(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    jsnap, tsnap = str(tmp_path / "jsnap"), str(tmp_path / "tsnap")
    jcfg, tcfg = configs(tmp_path, "simt", snapshot_dir=jsnap)
    out = jloop.train(jcfg, batch_iter=batches(as_jax=True), print_fn=lambda s: None)
    assert jckpt.latest_step(jsnap) == 3
    jstate = jax.tree.map(np.asarray, jckpt.restore(out["state"], jsnap))
    carried = simt_state_from_jax(jstate)
    assert carried["step"] == 3 and carried["adam"]["w1"]["step"] == 3 * 2
    assert carried["momentum"] and all(v.abs().max() > 0 for v in carried["momentum"].values())

    student, teacher = loop.build_models(tcfg)
    st = create_simt_state(student, teacher, tcfg, torch.Generator().manual_seed(0), "cpu")
    load_state(st, carried)
    checkpoint.save(st, tsnap, 3)
    start = {k: v.clone() for k, v in st.model.state_dict().items()}

    jlines, tlines = [], []
    jout = jloop.train(jcfg.replace(num_steps_stop=5), batch_iter=batches(as_jax=True),
                       print_fn=jlines.append, csv_path=str(tmp_path / "j.csv"),
                       resume=True)
    tout = loop.train(tcfg.replace(num_steps_stop=5, snapshot_dir=tsnap),
                      batch_iter=batches(), print_fn=tlines.append,
                      csv_path=str(tmp_path / "t.csv"), resume=True, device="cpu")
    assert "resumed from step 3" in jlines and "resumed from step 3" in tlines
    assert tout["state"].step == int(jout["state"].step) == 5

    jrows, trows = read_csv(tmp_path / "j.csv"), read_csv(tmp_path / "t.csv")
    assert set(jrows[0]) == set(trows[0]) == {"step", "time", *METRICS}
    assert [r["step"] for r in jrows] == [r["step"] for r in trows] == ["3", "4"]
    for jr, tr in zip(jrows, trows):
        for k in METRICS:
            assert float(tr[k]) == pytest.approx(float(jr[k]), rel=2e-3, abs=2e-4), (
                tr["step"], k)
    assert tout["final_metrics"]["loss"] == pytest.approx(jout["final_metrics"]["loss"],
                                                          rel=2e-3, abs=2e-4)

    js = jout["state"]
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    sd = tout["state"].model.state_dict()
    trained = [n for n, p in tout["state"].model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n in trained} >= {"layer3", "layer4", "layer5", "layer6",
                                                  "layer5_1", "layer6_1"}
    for k in trained:
        want_d = want[k].numpy() - start[k].numpy()
        got_d = sd[k].numpy() - start[k].numpy()
        assert np.abs(want_d).max() > 0, k
        rel = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
        assert rel <= 1e-2, (k, rel)
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=k)
    for k in ("t1", "t2", "w1", "w2"):
        np.testing.assert_allclose(getattr(tout["state"], k).param.detach().numpy(),
                                   np.asarray(getattr(js, k).param), atol=2e-5, err_msg=k)

    # The port's last snapshot holds what it trained.
    fresh = create_simt_state(*loop.build_models(tcfg), tcfg,
                              torch.Generator().manual_seed(0), "cpu")
    checkpoint.restore(fresh, tsnap)
    assert fresh.step == 5
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
