"""Port vs JAX: the adversarial warmup (simt_tpu_torch/train/adversarial.py) with the
FCDiscriminator (models/discriminator.py).

  - three steps against ``simt_tpu.train.adversarial.make_adversarial_warmup_step`` from
    the same flax-initialised segmenter (DeepLabv2, C5, layers (1,1,1,1), 32x64,
    float32) and discriminator, carried across by ``warmup_state_from_jax`` and
    ``state_dict_from_flax``: loss_seg1, loss_seg2 and loss_adv within 1e-3 relative;
    every trained segmenter parameter's change within 5e-2 of its tensor's largest
    change and the running statistics within 2e-3 (the tolerances of
    test_torch_warmup_step.py, where they are explained); each discriminator
    parameter's change within 1e-3 of JAX's by norm (measured: at most 1e-4). Adam's
    update g/(|g| + eps) turns a one-ulp difference of a gradient element near eps into
    a large one of that element's step (5.6% of the tensor's largest change, measured,
    on one of 2M), so D is held by norm, not element by element;
  - the segmenter's backward computes no gradient of the discriminator's parameters:
    one gradient a parameter a step, from the discriminator's own loss;
  - the one-hot "real" maps send ignored pixels to class 0 (the JAX step's quirk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import OptimConfig as JOptimConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.models import FCDiscriminator as JFCDiscriminator
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.train import create_warmup_state as j_create
from simt_tpu.train.adversarial import create_discriminator_state as j_create_d
from simt_tpu.train.adversarial import make_adversarial_warmup_step as j_make
from simt_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import FCDiscriminator, ResNetMulti
from simt_tpu_torch.models.from_jax import state_dict_from_flax, warmup_state_from_jax
from simt_tpu_torch.train import create_warmup_state
from simt_tpu_torch.train.adversarial import (create_discriminator_state,
                                              make_adversarial_warmup_step)

C, HW = 5, (32, 64)


def _setup():
    """(JAX step, JAX state, JAX D state, port step, port state, port D state)."""
    jcfg = JTrainConfig(stage="warmup", model=JModelConfig(num_classes=C,
                                                           compute_dtype="float32"),
                        optim=JOptimConfig())
    tcfg = TrainConfig(stage="warmup", model=ModelConfig(num_classes=C,
                                                         compute_dtype="float32"),
                       optim=OptimConfig())
    jmodel = JResNetMulti(num_classes=C, layers=(1, 1, 1, 1), dtype=jnp.float32)
    jvars = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, *HW, 3)), False))(
        jax.random.PRNGKey(0))
    jdisc = JFCDiscriminator(dtype=jnp.float32)
    js, jd = j_create(jmodel, jvars, jcfg), j_create_d(jdisc, C, HW, jax.random.PRNGKey(1))
    model = ResNetMulti(C, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.load_state_dict(warmup_state_from_jax(jax.tree.map(np.asarray, js))["model"],
                          strict=True)
    disc = FCDiscriminator(C, dtype=torch.float32)
    disc.load_state_dict(state_dict_from_flax({"params": jax.tree.map(np.asarray,
                                                                      jd.params)}),
                         strict=True)
    return (j_make(jmodel, jdisc, jcfg), js, jd, make_adversarial_warmup_step(tcfg),
            create_warmup_state(model, tcfg, "cpu"),
            create_discriminator_state(disc, "cpu"))


def _changes(got: dict, want: dict, start: dict, names) -> None:
    assert names
    for k in names:
        want_d = want[k].numpy() - start[k].numpy()
        got_d = got[k].numpy() - start[k].numpy()
        assert np.abs(want_d).max() > 0, k
        np.testing.assert_allclose(got_d, want_d, rtol=0,
                                   atol=5e-2 * np.abs(want_d).max(), err_msg=k)


def test_three_steps_match_jax():
    jstep, js, jd, step, st, d = _setup()
    start = {k: v.clone() for k, v in st.model.state_dict().items()}
    d_start = {k: v.clone() for k, v in d.model.state_dict().items()}
    for i in range(3):
        batch = synthetic_batch(1, HW, C, seed=10 * i)
        js, jd, jm = jstep(js, jd, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(st, d, batch)
        for k in ("loss_seg1", "loss_seg2", "loss_adv", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-3), (i, k)
    assert st.step == 3 and int(js.step) == 3
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    sd = st.model.state_dict()
    _changes(sd, want, start, [n for n, p in st.model.named_parameters() if p.requires_grad])
    for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    d_want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jd.params)})
    d_sd = d.model.state_dict()
    for k, v in d_want.items():
        want_d, got_d = v.numpy() - d_start[k].numpy(), d_sd[k].numpy() - d_start[k].numpy()
        assert np.linalg.norm(want_d) > 0, k
        assert np.linalg.norm(got_d - want_d) <= 1e-3 * np.linalg.norm(want_d), k
    assert all(s["step"] == 3 for s in d.opt.state.values())


def test_segmenter_backward_leaves_discriminator_without_gradient():
    _, _, _, step, st, d = _setup()
    grads = {n: 0 for n, _ in d.model.named_parameters()}
    for n, p in d.model.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, grads[n] + 1))
    for i in range(2):
        step(st, d, synthetic_batch(1, HW, C, seed=i))
    # One gradient a parameter a step, from the discriminator's own loss.
    assert set(grads.values()) == {2}
    assert all(p.requires_grad for p in d.model.parameters())


def test_real_maps_send_ignored_pixels_to_class_zero():
    _, _, _, step, st, d = _setup()
    inputs = []
    d.model.register_forward_hook(lambda m, i, o: inputs.append(i[0].detach()))
    batch = synthetic_batch(1, HW, C, seed=3)
    batch["label"][0, 0, :2] = [255, 2]
    step(st, d, batch)
    fake_for_seg, real, fake = inputs
    assert torch.equal(fake, fake_for_seg)
    label = torch.from_numpy(batch["label"]).long()
    want = torch.nn.functional.one_hot(torch.where(label == 255, 0, label), C).float()
    assert torch.equal(real.permute(0, 2, 3, 1), want)
    assert torch.equal(real[0, :, 0, 0], torch.eye(C)[0])
