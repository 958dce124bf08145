"""Port vs JAX: the warmup train step (simt_tpu_torch/train/warmup.py) and its loss
(ops/fused_losses.py::upsample_ce).

  - three steps against ``simt_tpu.train.make_warmup_step`` from the same
    flax-initialised weights (C5, layers (1,1,1,1), 32x64, float32), seeded through
    ``warmup_state_from_jax``, at iter_size 1 and 2: loss_seg1/loss_seg2 at rel 2e-4 /
    abs 2e-5; every trainable parameter's change over the three steps within 5e-2 of
    the largest change of its tensor, and the batch statistics at 2e-3 (the tolerance
    of tests/test_torch_model_train.py). The parameters after one step agree to their
    float32 rounding (1e-3 of the change); from one state, step 2 agrees to 2e-3; but
    the random-init trunk's batch-statistic BatchNorm over layer4's 5x9 map amplifies
    those one-ulp parameter differences into up to 3.3e-2 of layer4's change by step 3
    (iter_size 2). A wrong learning-rate group (1x for 10x) or a missed update is off by
    90% or more;
  - the frozen BatchNorm affine parameters unchanged and the stem moved;
  - the full-resolution-logits branch (plain cross_entropy_2d) on a stub model against
    the JAX step with the same stub;
  - ``param_label(warmup=True/False)`` equal to JAX's over the full-depth names;
  - ``upsample_ce`` values and gradients against JAX, chunk invariance (a non-divisor
    chunk included), all labels ignored -> 0;
  - the CLI on the CPU at a tiny crop, and its default device.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import OptimConfig as JOptimConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.ops.fused_losses import upsample_ce as j_upsample_ce
from simt_tpu.train import create_warmup_state as j_create, make_warmup_step as j_make
from simt_tpu.train import state as jstate
from simt_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import ResNetMulti, deeplab_multi
from simt_tpu_torch.models.from_jax import state_dict_from_flax, torch_key
from simt_tpu_torch.models.from_jax import warmup_state_from_jax
from simt_tpu_torch.ops.fused_losses import upsample_ce
from simt_tpu_torch.train import create_warmup_state, make_warmup_step, param_label

C, HW = 5, (32, 64)


def _configs(**optim):
    jcfg = JTrainConfig(model=JModelConfig(num_classes=C, openset=False,
                                           compute_dtype="float32"),
                        optim=JOptimConfig(**optim), stage="warmup")
    tcfg = TrainConfig(model=ModelConfig(num_classes=C, compute_dtype="float32"),
                       optim=OptimConfig(**optim))
    return jcfg, tcfg


def _batch(iter_size, seed):
    subs = [synthetic_batch(1, HW, C, seed=seed + j) for j in range(iter_size)]
    if iter_size == 1:
        return subs[0]
    return {k: np.stack([s[k] for s in subs]) for k in subs[0]}


def _run_both(jmodel, jvars, model, jcfg, tcfg, batches):
    """The JAX and the port's steps over ``batches`` from the same weights: (JAX
    metrics, port metrics, JAX state, port state, initial state_dict)."""
    js = j_create(jmodel, jvars, jcfg)
    got = warmup_state_from_jax(jax.tree.map(np.asarray, js))
    model.load_state_dict(got["model"], strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    st = create_warmup_state(model, tcfg, "cpu")
    st.step = got["step"]
    jstep, step = j_make(jmodel, jcfg), make_warmup_step(tcfg)
    jm, tm = [], []
    for batch in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in step(st, batch).items()})
    return jm, tm, js, st, start


@pytest.mark.parametrize("iter_size", [1, 2])
def test_three_steps_match_jax(iter_size):
    jcfg, tcfg = _configs(iter_size=iter_size)
    jmodel = JResNetMulti(num_classes=C, layers=(1, 1, 1, 1), dtype=jnp.float32)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), False)
    model = ResNetMulti(C, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
    batches = [_batch(iter_size, seed=10 * i) for i in range(3)]
    jm, tm, js, st, start = _run_both(jmodel, jvars, model, jcfg, tcfg, batches)
    for i, (want, got) in enumerate(zip(jm, tm)):
        for k in ("loss_seg1", "loss_seg2", "lr"):
            assert got[k] == pytest.approx(want[k], rel=2e-4, abs=2e-5), (i, k)
    assert st.step == 3

    want_sd = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    sd = model.state_dict()
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert {n.split(".")[0] for n in trained} >= {"conv1", "layer1", "layer2", "layer3",
                                                  "layer4", "layer5", "layer6"}
    for k in trained:
        want_d = want_sd[k].numpy() - start[k].numpy()
        got_d = sd[k].numpy() - start[k].numpy()
        assert np.abs(want_d).max() > 0, k
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=5e-2 * np.abs(want_d).max(),
                                   err_msg=k)
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=k)
    # Frozen: every BatchNorm affine parameter and the unused ASPP branches.
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, start[n]), n
    assert "bn1.weight" not in trained and "layer5.conv2d_list.2.weight" not in trained
    assert not torch.equal(sd["conv1.weight"], start["conv1.weight"])  # the stem moved


class _JStub(fnn.Module):
    """Logits at the input's size: a per-pixel linear map of the image per head."""

    @fnn.compact
    def __call__(self, x, train):
        return fnn.Dense(C, name="layer5")(x), fnn.Dense(C, name="layer6")(x)


class _Stub(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer5 = nn.Conv2d(3, C, 1)
        self.layer6 = nn.Conv2d(3, C, 1)

    def forward(self, x):
        return self.layer5(x), self.layer6(x)


def test_full_resolution_logits_take_plain_ce():
    jcfg, tcfg = _configs(iter_size=1, learning_rate=1e-3)
    jmodel = _JStub()
    batch = synthetic_batch(2, (6, 9), C, seed=3)
    batch["image"] = batch["image"] / 60.0
    jvars = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 9, 3)), False)
    model = _Stub()
    with torch.no_grad():
        for name in ("layer5", "layer6"):
            k = np.array(jvars["params"][name]["kernel"]).T  # (C, 3)
            getattr(model, name).weight.copy_(torch.from_numpy(k)[:, :, None, None])
            getattr(model, name).bias.copy_(torch.from_numpy(
                np.array(jvars["params"][name]["bias"])))
    js = j_create(jmodel, jvars, jcfg)
    st = create_warmup_state(model, tcfg, "cpu")
    jstep, step = j_make(jmodel, jcfg), make_warmup_step(tcfg)
    for _ in range(2):
        js, want = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(st, batch)
        for k in ("loss_seg1", "loss_seg2"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-4, abs=2e-5), k
    for name in ("layer5", "layer6"):
        np.testing.assert_allclose(
            getattr(model, name).weight.detach().numpy()[:, :, 0, 0].T,
            np.asarray(js.model.params[name]["kernel"]), rtol=1e-5, atol=1e-6)


def test_param_label_equals_jax_over_full_depth_names():
    jmodel = JResNetMulti(num_classes=19)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 65, 65, 3)), False))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    model = deeplab_multi(19, 0)
    for warmup in (True, False):
        want = {}
        for path, _ in flat:
            names = tuple(p.key for p in path)
            want[torch_key(("params",) + names)[0]] = jstate.param_label(names,
                                                                         warmup=warmup)
        got = {n: param_label(n, warmup=warmup) for n, _ in model.named_parameters()}
        assert got == want
    n_stem = sum(n.split(".")[0] in ("conv1", "layer1", "layer2") and "bn" not in n
                 and "downsample.1" not in n for n, _ in model.named_parameters())
    # the stem conv, conv1-3 of every block of layers 1-2 and their two projections
    assert n_stem == 1 + 3 * 3 + 1 + 4 * 3 + 1
    assert all(param_label(n, warmup=True) == jstate.LABEL_1X
               for n, _ in model.named_parameters()
               if n.startswith(("conv1", "layer1.", "layer2.")) and ".bn" not in n
               and "downsample.1" not in n)


def _ce_inputs(seed=0, b=2, h8=5, w8=9, hh=37, ww=65, c=C, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, h8, w8, c) * 3).astype(np.float32)
    label = rng.randint(0, c, (b, hh, ww)).astype(np.int32)
    label[rng.rand(b, hh, ww) < ignore_frac] = 255
    return logits, label


def test_upsample_ce_values_and_gradients_match_jax():
    logits, label = _ce_inputs()
    want, want_g = jax.value_and_grad(
        lambda x: j_upsample_ce(x, jnp.asarray(label), chunk_rows=8))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = upsample_ce(x, torch.from_numpy(label), chunk_rows=8)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-7)


def test_upsample_ce_chunk_invariance_and_all_ignored():
    logits, label = _ce_inputs(seed=1)
    lab = torch.from_numpy(label)
    vals = []
    for chunk in (64, 37, 10, 7, 1):  # 10 and 7 do not divide 37 rows
        x = torch.from_numpy(logits).requires_grad_()
        v = upsample_ce(x, lab, chunk_rows=chunk)
        v.backward()
        vals.append((float(v.detach()), x.grad.clone()))
    for v, g in vals[1:]:
        assert v == pytest.approx(vals[0][0], rel=1e-6)
        torch.testing.assert_close(g, vals[0][1], rtol=1e-5, atol=1e-8)
    x = torch.from_numpy(logits).requires_grad_()
    zero = upsample_ce(x, torch.full_like(lab, 255), chunk_rows=16)
    zero.backward()
    assert float(zero.detach()) == 0.0 and torch.isfinite(x.grad).all()
    assert not x.grad.any()


TINY_CLI = ["--synthetic", "--num-steps-stop", "2", "--num-classes", "5",
            "--input-size-target", "64,32", "--compute-dtype", "float32"]


def test_warmup_cli_defaults_to_cuda_and_raises_without_it():
    from simt_tpu_torch.tools.train_warmup import main

    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        main(TINY_CLI)


def test_warmup_cli_runs_on_the_cpu(capsys):
    """Full-depth closed-set model at a tiny crop: the reference's metric lines, finite
    losses, the warmup preset, and no kernel launch on the CPU."""
    from simt_tpu_torch.ops.kernels import conv3x3
    from simt_tpu_torch.tools.train_warmup import build_config, build_parser, main

    conv3x3.conv3x3_fwd.launches = conv3x3.conv3x3_wgrad.launches = 0
    out = main(TINY_CLI + ["--device", "cpu", "--iter-size", "2", "--log-every", "1"])
    text = capsys.readouterr().out
    assert text.count("iter = ") == 2 and "loss_seg1 = " in text and "loss_seg2 = " in text
    assert out["state"].step == 2
    assert all(np.isfinite(v) for v in out["final_metrics"].values())
    assert conv3x3.conv3x3_fwd.launches == conv3x3.conv3x3_wgrad.launches == 0
    assert out["state"].model.layer5_1 is None  # closed set
    cfg = build_config(build_parser().parse_args(["--synthetic"]))
    assert cfg.num_steps_stop == 150_000
    assert dataclasses.asdict(cfg)["optim"]["iter_size"] == 1
    with pytest.raises(ValueError, match="not a warmup preset"):
        build_config(build_parser().parse_args(["--synthetic", "--preset",
                                                "simt_bapa_lr25"]))
