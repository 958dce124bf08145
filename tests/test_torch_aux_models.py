"""Port vs JAX: the auxiliary model families (simt_tpu_torch/models/deeplab_single.py,
deeplab_vgg.py, deeplabv3.py, discriminator.py), their weights across
(models/from_jax.py), their LR groups (train/state.py::param_label) and their warmup
steps (train/warmup.py), and the half-pixel upsample (ops/interp.py).

float32. JAX weights are carried across by ``state_dict_from_flax`` (a strict load),
BN statistics randomised so the running-stat normalisation is not the identity:

  - each model's eval-mode forward and (DeepLabv2 trunks and v3) train-mode forward
    within rtol = atol = 2e-3 of its flax twin (the tolerance of test_torch_model.py),
    the running statistics after a train-mode forward within 2e-3;
  - the state_dict equal to ``export_state_dict``; Res_Deeplab's ``load_matching(
    exclude=("layer5",))`` against ``import_state_dict(exclude=)``;
  - the half-pixel upsample within 1e-5 of ``jax.image.resize`` (upsampling, odd
    ratios included), and DeepLabv3's in-model upsample equal to it;
  - ``param_label`` equal to JAX's on every parameter of every arch and stage;
  - three warmup steps of each new arch against ``make_warmup_step``: losses within
    1e-3 relative; every trained parameter's change within 5e-2 of its tensor's
    largest change and the running statistics within 2e-3 (the tolerances of
    test_torch_warmup_step.py, where they are explained). DeepLabv3's trunk (layer3)
    is the exception: at its random init its float32 gradient is ill-conditioned, the
    batch statistics of a stride-16 map cancelling the nearly uniform gradient that
    the upsample spreads (measured at one step: the port's float32 gradient is 0.4-1.5%
    from the port's own float64 one by norm, JAX's 1.5-4%; after three steps the
    changes differ by at most 3.6% by norm), so each DeepLabv3 parameter's change is
    held by its norm, within ``V3_REL`` of JAX's (a wrong LR group is off by 90%
    or more).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import OptimConfig as JOptimConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.models import DeepLabv3 as JDeepLabv3
from simt_tpu.models import DeeplabSingle as JDeeplabSingle
from simt_tpu.models import DeeplabVGG as JDeeplabVGG
from simt_tpu.models import FCDiscriminator as JFCDiscriminator
from simt_tpu.models.import_torch import export_state_dict, import_state_dict
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.ops.interp import upsample_bilinear_half_pixel as j_half_pixel
from simt_tpu.train import create_warmup_state as j_create, make_warmup_step as j_make
from simt_tpu.train import state as jstate
from simt_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import (DeepLabv3, DeeplabSingle, DeeplabVGG,
                                   FCDiscriminator, ResNetMulti)
from simt_tpu_torch.models.from_jax import (load_matching, state_dict_from_flax,
                                            torch_key, warmup_state_from_jax)
from simt_tpu_torch.models.layers import ClassifierModule
from simt_tpu_torch.ops.interp import upsample_bilinear_half_pixel
from simt_tpu_torch.train import (build_models, create_warmup_state, make_warmup_step,
                                  param_label)

TINY = (1, 1, 1, 1)
C, HW = 5, (32, 64)
V3_REL = 1e-1

# name: (JAX model, port model, input (b, h, w, channels), call with the train flag)
MODELS = {
    "deeplab_single": (lambda: JDeeplabSingle(num_classes=7, layers=TINY,
                                              dtype=jnp.float32),
                       lambda: DeeplabSingle(7, layers=TINY, dtype=torch.float32),
                       (1, 64, 64, 3), True),
    "deeplab_vgg": (lambda: JDeeplabVGG(num_classes=5, dtype=jnp.float32),
                    lambda: DeeplabVGG(5, dtype=torch.float32), (1, 64, 96, 3), True),
    "deeplabv3": (lambda: JDeepLabv3(num_classes=6, open_classes=2, openset=True,
                                     dtype=jnp.float32),
                  lambda: DeepLabv3(6, 2, True, dtype=torch.float32), (1, 40, 56, 3), True),
    "discriminator": (lambda: JFCDiscriminator(dtype=jnp.float32),
                      lambda: FCDiscriminator(19, dtype=torch.float32), (2, 64, 64, 19),
                      False),
}


def _jax_case(name, seed=0):
    """(JAX model, its variables as numpy with randomised BN statistics, input)."""
    make_j, _, shape, flag = MODELS[name]
    jm = make_j()
    rng = np.random.RandomState(seed)
    scale = 50.0 if shape[-1] == 3 else 1.0
    x = (rng.randn(*shape) * scale).astype(np.float32)
    args = (False,) if flag else ()
    variables = jax.jit(lambda r: jm.init(r, jnp.asarray(x), *args))(
        jax.random.PRNGKey(seed))
    variables = jax.tree.map(np.asarray, flax.core.unfreeze(variables))
    if "batch_stats" in variables:
        flat = flax.traverse_util.flatten_dict(variables["batch_stats"])
        flat = {k: (rng.randn(*v.shape) * 0.05 if k[-1] == "mean"
                    else np.abs(rng.randn(*v.shape)) * 0.5 + 0.5).astype(np.float32)
                for k, v in flat.items()}
        variables["batch_stats"] = flax.traverse_util.unflatten_dict(flat)
    return jm, variables, x


def _port(name, variables):
    model = MODELS[name][1]()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,train", [
    ("deeplab_single", False), ("deeplab_single", True), ("deeplab_vgg", False),
    ("deeplab_vgg", True), ("deeplabv3", False), ("deeplabv3", True),
    ("discriminator", False)])
def test_forward_matches_flax_twin(name, train):
    jm, variables, x = _jax_case(name)
    model = _port(name, variables).train(train)
    with torch.set_grad_enabled(False):
        got = _first(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    if name == "discriminator":
        want = jm.apply(variables, jnp.asarray(x))
    elif train:
        want, mutated = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), False)
    want = np.asarray(_first(want))
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-3, atol=2e-3)
    if train and "batch_stats" in variables:
        want_sd = state_dict_from_flax({"batch_stats": jax.tree.map(
            np.asarray, mutated["batch_stats"])})
        sd = model.state_dict()
        assert want_sd
        for k, v in want_sd.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_equals_jax_export(name):
    _, variables, _ = _jax_case(name)
    got = state_dict_from_flax(variables)
    want = export_state_dict(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    model = MODELS[name][1]()
    own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert own == set(want)  # the strict load of _port needs no more and no less
    examples = {"deeplab_vgg": ("features.29.weight", "classifier.conv2d_list.1.bias"),
                "deeplab_single": ("layer5.conv2d_list.3.weight",
                                   "layer4.0.downsample.1.running_var"),
                "deeplabv3": ("assp.bn1.weight", "conv_1.weight", "assp.convf.weight",
                              "layer3.5.bn3.bias", "layer1.0.downsample.0.weight"),
                "discriminator": ("conv4.weight", "classifier.bias")}[name]
    assert set(examples) <= set(want)


def test_res_deeplab_returns_pair_and_sums_all_four_branches():
    _, variables, x = _jax_case("deeplab_single")
    model = _port("deeplab_single", variables).eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        o1, o2 = model(xt)
        assert o1 is o2 and o1.shape == (1, 7, 9, 9)
        model.layer5.conv2d_list[3].weight.add_(1.0)
        moved, _ = model(xt)
    assert not torch.allclose(o1, moved)
    assert ClassifierModule(8, 3).effective_branches == 2
    with pytest.raises(ValueError, match="1..4"):
        ClassifierModule(8, 3, effective_branches=5)


def test_vgg_is_stride_8_with_the_reference_indices():
    model = DeeplabVGG(5, dtype=torch.float32).eval()
    with torch.no_grad():
        o1, o2 = model(torch.zeros(1, 3, 64, 96))
    assert o1 is o2 and o1.shape == (1, 5, 8, 12)
    convs = [i for i, m in enumerate(model.features) if isinstance(m, torch.nn.Conv2d)]
    assert convs == [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 23, 25, 27, 29, 31]
    pools = [i for i, m in enumerate(model.features) if isinstance(m, torch.nn.MaxPool2d)]
    assert pools == [4, 9, 16]
    assert model.features[29].dilation == (4, 4) and model.features[23].dilation == (2, 2)


def test_discriminator_patch_output():
    out = FCDiscriminator(19, dtype=torch.float32)(torch.zeros(2, 19, 64, 96))
    assert out.shape == (2, 1, 2, 3)  # (B, 1, H/32, W/32); JAX's is (B, H/32, W/32, 1)


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 4, 6), (48, 64)),
                                          ((1, 5, 7, 3), (13, 19)),
                                          ((1, 4, 5, 2), (4, 5))])
def test_half_pixel_upsample_matches_jax(shape, out_hw):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = upsample_bilinear_half_pixel(torch.from_numpy(x), out_hw)
    want = np.asarray(j_half_pixel(jnp.asarray(x), out_hw))
    assert got.shape == want.shape == (shape[0], *out_hw, shape[3])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_deeplabv3_upsamples_in_model_with_the_half_pixel_op():
    _, variables, x = _jax_case("deeplabv3")
    model = _port("deeplabv3", variables).eval()
    seen = {}

    def keep_input(module, inputs, output):
        seen.setdefault("x", inputs[0])

    model.conv_1.register_forward_hook(keep_input)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        logits = torch.cat([model.conv(seen["x"]), model.conv_1(seen["x"])], dim=1)
    assert out.shape == (1, 8, 40, 56) and logits.shape[2:] == (3, 4)  # stride 16
    want = upsample_bilinear_half_pixel(logits.permute(0, 2, 3, 1), (40, 56))
    np.testing.assert_allclose(_nhwc(out), want.numpy(), rtol=1e-5, atol=1e-5)


def test_res_deeplab_head_exclusion_load_matches_jax():
    jm, variables, _ = _jax_case("deeplab_single")
    other = jax.tree.map(lambda a: a + 1.0, variables)
    sd = export_state_dict(other)
    want, jreport = import_state_dict(variables, sd, exclude=("layer5",))
    model = _port("deeplab_single", variables)
    report = load_matching(model, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                           exclude=("layer5",))
    assert sorted(report["loaded"]) == sorted(jreport["loaded"])
    assert all(k.startswith("layer5") for k in report["missing"]) and report["missing"]
    got = model.state_dict()
    for k, v in state_dict_from_flax(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def _labels_jax(jm, shape, arch, warmup, eff):
    flag = (False,) if arch != "discriminator" else ()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(shape), *flag))
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        names = tuple(p.key for p in path)
        out[torch_key(("params",) + names)[0]] = jstate.param_label(
            names, warmup=warmup, aspp_effective_branches=eff, arch=arch)
    return out


@pytest.mark.parametrize("arch,eff", [("deeplab_multi", 2), ("deeplab_multi", 3),
                                      ("deeplab_single", 4), ("deeplab_vgg", 2),
                                      ("deeplabv3", 2)])
def test_param_label_equals_jax_on_every_parameter(arch, eff):
    jm, model = {
        "deeplab_multi": (JResNetMulti(num_classes=19, open_classes=15, openset=True,
                                       aspp_effective_branches=eff),
                          ResNetMulti(19, 15, True, aspp_effective_branches=eff)),
        "deeplab_single": (JDeeplabSingle(num_classes=19), DeeplabSingle(19)),
        "deeplab_vgg": (JDeeplabVGG(num_classes=19), DeeplabVGG(19)),
        "deeplabv3": (JDeepLabv3(num_classes=19, open_classes=15, openset=True),
                      DeepLabv3(19, 15, True)),
    }[arch]
    for warmup in (True, False):
        want = _labels_jax(jm, (1, 65, 65, 3), arch, warmup, eff)
        got = {n: param_label(n, warmup=warmup, aspp_effective_branches=eff, arch=arch)
               for n, _ in model.named_parameters()}
        assert got == want, warmup
    if arch == "deeplabv3":
        assert got["layer3.2.bn2.weight"] == jstate.LABEL_1X  # BN affine trains in v3
        assert got["assp.bnf.bias"] == got["conv_1.weight"] == jstate.LABEL_10X
        assert got["layer2.0.conv2.weight"] == got["bn1.weight"] == jstate.LABEL_FROZEN


def test_configs_and_build_models_take_every_arch():
    for arch, cls, out in (("deeplab_multi", ResNetMulti, tuple),
                           ("deeplab_single", DeeplabSingle, tuple),
                           ("deeplab_vgg", DeeplabVGG, tuple),
                           ("deeplabv3", DeepLabv3, torch.Tensor)):
        cfg = TrainConfig(stage="warmup", model=ModelConfig(arch=arch))
        model, teacher = build_models(cfg)
        assert isinstance(model, cls) and teacher is None
    with pytest.raises(ValueError, match="unknown arch"):
        ModelConfig(arch="resnet")
    with pytest.raises(ValueError, match="4 branches"):
        ModelConfig(aspp_effective_branches=5)
    multi, _ = build_models(TrainConfig(stage="warmup",
                                        model=ModelConfig(aspp_effective_branches=3)))
    assert multi.layer6.effective_branches == 3
    # Res_Deeplab sums all 4 branches, so its config holds 4 however it is built, and
    # its optimizer trains every branch.
    single_cfg = TrainConfig(stage="warmup", model=ModelConfig(
        arch="deeplab_single", aspp_effective_branches=2))
    assert single_cfg.model.aspp_effective_branches == 4
    single, _ = build_models(single_cfg)
    create_warmup_state(single, single_cfg, "cpu")
    assert all(conv.weight.requires_grad for conv in single.layer5.conv2d_list)
    v3, _ = build_models(TrainConfig(stage="simt", model=ModelConfig(
        arch="deeplabv3", openset=True)))
    assert v3.conv_1.out_channels == 15 and v3.bn1.weight.requires_grad


# arch: (JAX model, port model, aspp_effective_branches, crop (h, w)). DeepLabv3 is
# stride 16: its crop gives layer3 and the ASPP 4x8 maps for the batch statistics.
WARMUP = {
    "deeplab_single": (lambda: JDeeplabSingle(num_classes=C, layers=TINY,
                                              dtype=jnp.float32),
                       lambda: DeeplabSingle(C, layers=TINY, dtype=torch.float32), 4, HW),
    "deeplab_vgg": (lambda: JDeeplabVGG(num_classes=C, dtype=jnp.float32),
                    lambda: DeeplabVGG(C, dtype=torch.float32), 2, HW),
    "deeplabv3": (lambda: JDeepLabv3(num_classes=C, dtype=jnp.float32),
                  lambda: DeepLabv3(C, dtype=torch.float32), 2, (64, 128)),
}


@pytest.mark.parametrize("arch", list(WARMUP))
def test_three_warmup_steps_match_jax(arch):
    make_j, make_t, eff, hw = WARMUP[arch]
    jcfg = JTrainConfig(stage="warmup", model=JModelConfig(
        arch=arch, num_classes=C, compute_dtype="float32", aspp_effective_branches=eff),
        optim=JOptimConfig())
    tcfg = TrainConfig(stage="warmup", model=ModelConfig(
        arch=arch, num_classes=C, compute_dtype="float32", aspp_effective_branches=eff),
        optim=OptimConfig())
    jm = make_j()
    jvars = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *hw, 3)), False))(
        jax.random.PRNGKey(0))
    js = j_create(jm, jvars, jcfg)
    got = warmup_state_from_jax(jax.tree.map(np.asarray, js))
    model = make_t()
    model.load_state_dict(got["model"], strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    st = create_warmup_state(model, tcfg, "cpu")
    jstep, step = j_make(jm, jcfg), make_warmup_step(tcfg)
    for i in range(3):
        batch = synthetic_batch(1, hw, C, seed=10 * i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        met = step(st, batch)
        for k in ("loss_seg1", "loss_seg2"):
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-3), (i, k)
    want_sd = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    sd = model.state_dict()
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    for k in trained:
        want_d = want_sd[k].numpy() - start[k].numpy()
        got_d = sd[k].numpy() - start[k].numpy()
        if arch == "deeplabv3":
            # Ill-conditioned in float32 (module docstring): by the change's norm.
            rel = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
            assert rel <= V3_REL, (k, rel)
            continue
        np.testing.assert_allclose(got_d, want_d, rtol=0,
                                   atol=5e-2 * np.abs(want_d).max(), err_msg=k)
    moved = {k for k in trained if np.abs(want_sd[k].numpy() - start[k].numpy()).max() > 0}
    assert moved, arch
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, start[n]), n
    for k in (k for k in want_sd if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=k)
    if arch == "deeplabv3":  # BN affine trains in v3's groups; the stem stays frozen
        assert "layer3.0.bn2.weight" in trained and "conv1.weight" not in trained
        assert not torch.equal(sd["layer3.0.bn2.weight"], start["layer3.0.bn2.weight"])
