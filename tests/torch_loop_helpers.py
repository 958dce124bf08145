"""Helpers shared by the port's loop tests (tests/test_torch_loop_*.py,
tests/test_torch_checkpoint.py): both packages' ``train()`` on the layers (1,1,1,1)
DeepLabv2 at 32x64, float32, 5 + 3 classes, inner_w_steps 2 (the geometry of
tests/test_loop.py), fed one constant synthetic batch."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from simt_tpu import config as jconfig
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.train import loop as jloop
from simt_tpu_torch import config as tconfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.train import loop

C, O, HW = 5, 3, (32, 64)
LAYERS = (1, 1, 1, 1)


def tiny_models(monkeypatch):
    """Both packages' ``build_models`` build the layers (1,1,1,1) network, and JAX's
    ``train()`` initialises it with ``jit(model.init)`` (the same values as its eager
    ``model.init``, in a fraction of the time; no warm start)."""

    def jtiny(num_classes=19, open_classes=0, openset=False, *, dtype,
              aspp_effective_branches=2):
        return JResNetMulti(num_classes=num_classes, open_classes=open_classes,
                            openset=openset, layers=LAYERS, dtype=dtype,
                            aspp_effective_branches=aspp_effective_branches)

    def ttiny(num_classes=19, open_classes=0, openset=False, *, dtype):
        return ResNetMulti(num_classes, open_classes, openset, layers=LAYERS, dtype=dtype)

    def jinit(model, restore_from, input_hw, *, strip_prefix=0, rng=None):
        assert not restore_from
        init = jax.jit(lambda r: model.init(r, jnp.zeros((1, *input_hw, 3)), False))
        return init(rng), {"loaded": [], "missing": [], "skipped": [], "unused": []}

    monkeypatch.setattr(jloop, "deeplab_multi", jtiny)
    monkeypatch.setattr(jloop.ckpt_lib, "load_warmstart_variables", jinit)
    monkeypatch.setattr(loop, "deeplab_multi", ttiny)


def configs(tmp_path, stage, snapshot_dir="", **kw):
    """(JAX TrainConfig, port TrainConfig) of the tiny geometry."""
    cd = str(tmp_path / "cd.npy")
    np.save(cd, (np.ones(C) / C).astype(np.float32))
    out = []
    for lib in (jconfig, tconfig):
        base = lib.TrainConfig()
        out.append(lib.TrainConfig(
            stage=stage,
            model=lib.ModelConfig(num_classes=C, open_classes=O, openset=stage == "simt",
                                  compute_dtype="float32"),
            optim=lib.OptimConfig(num_steps=100),
            simt=dataclasses.replace(lib.SimTConfig(), class_dist=cd, inner_w_steps=2),
            data=dataclasses.replace(base.data, crop_size=(HW[1], HW[0]), batch_size=1),
            num_steps_stop=3, save_pred_every=100, snapshot_dir=snapshot_dir,
            log_every=1).replace(**kw))
    return tuple(out)


def batches(as_jax=False):
    b = synthetic_batch(1, HW, C, seed=0)
    if as_jax:
        b = {k: jnp.asarray(v) for k, v in b.items()}
    while True:
        yield b


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))
