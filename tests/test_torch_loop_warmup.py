"""Port vs JAX: ``train()`` of the warmup stage resumed from a JAX snapshot
(simt_tpu_torch/train/loop.py, train/checkpoint.py, models/from_jax.py).

JAX's ``train()`` runs 3 steps and writes its orbax snapshot; restored
to numpy, it is carried through ``warmup_state_from_jax`` (weights, SGD momentum,
step) into a port state and written as a port snapshot. Both packages'
``train(resume=True)`` then run steps 3-4 on the same constant batch
(tests/torch_loop_helpers.py's tiny geometry, closed set):

  - both CSVs: the same columns and steps, loss_seg1 / loss_seg2 / lr at rel 2e-4 /
    abs 2e-5 (tests/test_torch_warmup_step.py's tolerance);
  - each trained parameter's change over the two resumed steps within 1e-2 of its
    L2 norm (tests/test_torch_loop_simt.py's measure: the batch-statistic BatchNorm
    of the random-init trunk amplifies one-ulp differences elementwise), the BN
    running statistics at 2e-3 (tests/test_torch_warmup_step.py's); the stem and
    layers 1-2 train in this stage.
"""

import jax
import numpy as np
import pytest

from simt_tpu.train import checkpoint as jckpt
from simt_tpu.train import loop as jloop
from simt_tpu_torch.models.from_jax import load_state, state_dict_from_flax
from simt_tpu_torch.models.from_jax import warmup_state_from_jax
from simt_tpu_torch.train import checkpoint, create_warmup_state, loop

from torch_loop_helpers import batches, configs, read_csv, tiny_models

METRICS = ("loss_seg1", "loss_seg2", "lr")


def test_resume_from_a_jax_snapshot_trains_as_jax(tmp_path, monkeypatch):
    tiny_models(monkeypatch)
    jsnap, tsnap = str(tmp_path / "jsnap"), str(tmp_path / "tsnap")
    jcfg, tcfg = configs(tmp_path, "warmup", snapshot_dir=jsnap)
    out = jloop.train(jcfg, batch_iter=batches(as_jax=True), print_fn=lambda s: None)
    carried = warmup_state_from_jax(jax.tree.map(np.asarray,
                                                 jckpt.restore(out["state"], jsnap)))
    assert carried["step"] == 3 and "conv1.weight" in carried["momentum"]

    st = create_warmup_state(loop.build_models(tcfg)[0], tcfg, "cpu")
    load_state(st, carried)
    checkpoint.save(st, tsnap, 3)
    start = {k: v.clone() for k, v in st.model.state_dict().items()}

    jout = jloop.train(jcfg.replace(num_steps_stop=5), batch_iter=batches(as_jax=True),
                       print_fn=lambda s: None, csv_path=str(tmp_path / "j.csv"),
                       resume=True)
    tout = loop.train(tcfg.replace(num_steps_stop=5, snapshot_dir=tsnap),
                      batch_iter=batches(), print_fn=lambda s: None,
                      csv_path=str(tmp_path / "t.csv"), resume=True, device="cpu")
    assert tout["state"].step == int(jout["state"].step) == 5

    jrows, trows = read_csv(tmp_path / "j.csv"), read_csv(tmp_path / "t.csv")
    assert set(jrows[0]) == set(trows[0]) == {"step", "time", *METRICS}
    assert [r["step"] for r in jrows] == [r["step"] for r in trows] == ["3", "4"]
    for jr, tr in zip(jrows, trows):
        for k in METRICS:
            assert float(tr[k]) == pytest.approx(float(jr[k]), rel=2e-4, abs=2e-5), (
                tr["step"], k)

    js = jout["state"]
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    sd = tout["state"].model.state_dict()
    trained = [n for n, p in tout["state"].model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n in trained} >= {"conv1", "layer1", "layer2", "layer3",
                                                  "layer4", "layer5", "layer6"}
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
