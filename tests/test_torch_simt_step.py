"""Port vs JAX: the SimT train step (simt_tpu_torch/train/simt.py, train/state.py).

  - the 5-step GOLDEN trace of tests/test_golden_metrics.py (C5+O3, layers (1,1,1,1),
    32x64, float32, inner_w_steps 3), the port seeded from the JAX-initialised state
    through ``simt_state_from_jax``, at that test's tolerance (rel 2e-3, abs 2e-4);
  - one whole step against the JAX step on the stub-logit setup of
    tests/test_reference_oracle.py (the models replaced by precomputed logits, so the
    loss block, the inner W loop and the optimizer families are what is compared):
    losses at rel 2e-4 / abs 2e-4, post-step T1/T2/W1/W2 at atol 2e-5, that test's
    tolerances, at iter_size 1 and 2 and with clear_inner_t_grads;
  - ``param_label`` equal to the JAX package's over the full-depth parameter names.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import OptimConfig as JOptimConfig
from simt_tpu.config import SimTConfig as JSimTConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.train import create_simt_state as j_create, make_simt_step as j_make
from simt_tpu.train import state as jstate
from simt_tpu_torch.config import ModelConfig, OptimConfig, SimTConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import ResNetMulti, deeplab_multi
from simt_tpu_torch.models.from_jax import simt_state_from_jax, torch_key
from simt_tpu_torch.train import create_simt_state, make_simt_step, param_label

HERE = os.path.dirname(os.path.abspath(__file__))


def _module(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(c, o, cd_path, **optim):
    simt = dict(class_dist=cd_path, inner_w_steps=optim.pop("inner", 3),
                clear_inner_t_grads=optim.pop("clear", False))
    jcfg = JTrainConfig(model=JModelConfig(num_classes=c, open_classes=o, openset=True,
                                           compute_dtype="float32"),
                        optim=JOptimConfig(**optim),
                        simt=dataclasses.replace(JSimTConfig(), **simt))
    tcfg = TrainConfig(model=ModelConfig(num_classes=c, open_classes=o,
                                         compute_dtype="float32"),
                       optim=OptimConfig(**optim),
                       simt=dataclasses.replace(SimTConfig(), **simt))
    return jcfg, tcfg


def _port_state(jstate_np, student, teacher, tcfg):
    """The port's state seeded from a JAX state through simt_state_from_jax."""
    got = simt_state_from_jax(jstate_np)
    if student is not None:
        student.load_state_dict(got["student"], strict=True)
        teacher.load_state_dict(got["teacher"], strict=True)
    st = create_simt_state(student or _StubStudent(), teacher or _StubTeacher(), tcfg,
                           torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for k in ("t1", "t2", "w1", "w2"):
            getattr(st, k).param.copy_(got[k])
    st.step = got["step"]
    return st


def test_five_step_golden_trace(tmp_path):
    golden = _module("test_golden_metrics").GOLDEN
    c, o, hw = 5, 3, (32, 64)
    cd = str(tmp_path / "cd.npy")
    np.save(cd, (np.ones(c) / c).astype(np.float32))
    jcfg, tcfg = _configs(c, o, cd, num_steps=1000)
    jstudent = JResNetMulti(num_classes=c, open_classes=o, openset=True,
                            layers=(1, 1, 1, 1), dtype=jnp.float32)
    jteacher = JResNetMulti(num_classes=c, layers=(1, 1, 1, 1), dtype=jnp.float32)
    sv = jstudent.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), False)
    tv = jteacher.init(jax.random.PRNGKey(1), jnp.zeros((1, *hw, 3)), False)
    js = jax.tree.map(np.asarray, j_create(sv, tv, jcfg, jax.random.PRNGKey(2)))

    student = ResNetMulti(c, o, True, layers=(1, 1, 1, 1), dtype=torch.float32)
    teacher = ResNetMulti(c, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
    st = _port_state(js, student, teacher, tcfg)
    step = make_simt_step(tcfg)
    batch = synthetic_batch(1, hw, c, seed=0)
    for i, want in enumerate(golden):
        m = step(st, batch)
        for k, v in want.items():
            assert float(m[k]) == pytest.approx(v, rel=2e-3, abs=2e-4), (i, k, float(m[k]), v)
    assert st.step == len(golden)


class _StubStudent(nn.Module):
    """Forward slices precomputed logits out of the (NCHW) image: channels [0, T) are
    head 1, [T, 2T) head 2 (the oracle's stub, tests/test_reference_oracle.py)."""

    def __init__(self, total=8):
        super().__init__()
        self.total = total
        self.layer3 = nn.Conv2d(1, 1, 1)  # a parameter for the optimizer; unused

    def forward(self, x):
        return x[:, :self.total], x[:, self.total:2 * self.total]


class _StubTeacher(nn.Module):
    def __init__(self, total=8, c=5):
        super().__init__()
        self.total, self.c = total, c

    def forward(self, x):
        return None, x[:, 2 * self.total:2 * self.total + self.c]


@pytest.mark.parametrize("iter_size,clear", [(1, False), (2, False), (1, True)])
def test_step_matches_jax_step_on_stub_logits(tmp_path, iter_size, clear):
    oracle = _module("test_reference_oracle")
    c, o, total = oracle.C, oracle.O, oracle.TOTAL
    rng = np.random.RandomState(7 + iter_size + 10 * clear)
    shp8 = (1, oracle.H8, oracle.W8)
    images = [np.concatenate([rng.randn(*shp8, total) * 2, rng.randn(*shp8, total) * 2,
                              rng.randn(*shp8, c) * 4], axis=-1).astype(np.float32)
              for _ in range(iter_size)]
    labels = [np.where(rng.rand(1, oracle.HH, oracle.WW) < 0.15, 255,
                       rng.randint(0, c, (1, oracle.HH, oracle.WW))).astype(np.int32)
              for _ in range(iter_size)]
    class_dist = rng.rand(c).astype(np.float32) + 0.5
    cd = str(tmp_path / "cd.npy")
    np.save(cd, class_dist / class_dist.sum())
    jcfg, tcfg = _configs(c, o, cd, learning_rate_t=oracle.LR_T, num_steps=10**9,
                          iter_size=iter_size, inner=oracle.INNER, clear=clear)
    stub_params = {"layer3_0": {"conv1": {"kernel": jnp.zeros((1, 1, 1, 1))}}}
    js = j_create({"params": stub_params}, {"params": {}}, jcfg, jax.random.PRNGKey(0))
    js = js.replace(t1=js.t1.replace(param=jnp.asarray(rng.randn(total, c) * 0.5,
                                                       jnp.float32)),
                    t2=js.t2.replace(param=jnp.asarray(rng.randn(total, c) * 0.5,
                                                       jnp.float32)))
    if iter_size == 1:
        batch = {"image": images[0], "label": labels[0]}
    else:
        batch = {"image": np.stack(images), "label": np.stack(labels)}
    j_new, j_metrics = j_make(oracle._StubStudent(), oracle._StubTeacher(), jcfg)(
        js, {k: jnp.asarray(v) for k, v in batch.items()})

    st = _port_state(jax.tree.map(np.asarray, js), None, None, tcfg)
    metrics = make_simt_step(tcfg)(st, batch)
    for k in ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place"):
        assert float(metrics[k]) == pytest.approx(float(j_metrics[k]), rel=2e-4,
                                                  abs=2e-4), k
    for k in ("t1", "t2", "w1", "w2"):
        np.testing.assert_allclose(getattr(st, k).param.detach().numpy(),
                                   np.asarray(getattr(j_new, k).param), atol=2e-5,
                                   err_msg=k)


def test_param_label_equals_jax_over_full_depth_names():
    jmodel = JResNetMulti(num_classes=19, open_classes=15, openset=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 65, 65, 3)), False))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    want = {}
    for path, _ in flat:
        names = tuple(p.key for p in path)
        key, _ = torch_key(("params",) + names)
        want[key] = jstate.param_label(names, warmup=False)
    model = deeplab_multi(19, 15, openset=True)
    got = {n: param_label(n) for n, _ in model.named_parameters()}
    assert got == want
    assert sum(v == jstate.LABEL_10X for v in got.values()) == 16  # 4 heads x 2 branches x (w, b)


TINY_CLI = ["--synthetic", "--num-steps-stop", "2", "--num-classes", "5",
            "--open-classes", "3", "--input-size-target", "64,32",
            "--compute-dtype", "float32"]


def test_train_cli_defaults_to_cuda_and_raises_without_it():
    from simt_tpu_torch.ops.kernels import _build
    from simt_tpu_torch.tools.train_simt import main

    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        main(TINY_CLI)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("loss_fused")


def test_train_cli_runs_on_the_cpu(capsys):
    """Full-depth student and teacher at a tiny crop: the reference's start-up and
    per-step lines, finite metrics, and no kernel launch on the CPU."""
    from simt_tpu_torch.ops.kernels import loss_fused
    from simt_tpu_torch.tools.train_simt import main

    loss_fused.loss_core_fwd.launches = loss_fused.loss_core_bwd.launches = 0
    out = main(TINY_CLI + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "Leanring_rate_T:  0.0025" in text and "Open-set class:  3" in text
    assert text.count("iter = ") == 2 and "loss_seg_p = " in text
    assert out["state"].step == 2
    assert all(np.isfinite(float(v)) for v in out["metrics"].values())
    assert loss_fused.loss_core_fwd.launches == loss_fused.loss_core_bwd.launches == 0
