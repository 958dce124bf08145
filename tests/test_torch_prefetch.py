"""Port vs JAX: ``device_prefetch`` and ``build_loader`` (simt_tpu_torch/data/pipeline.py,
train/loop.py), and the slice as a whole.

  - ``device_prefetch`` keeps order and content, passes non-array entries through,
    keeps ``size`` batches in flight and closes the loader it wraps; a tensor it placed
    is not copied again by the steps' ``torch.as_tensor``;
  - ``build_loader(source="gta5")`` (tests/test_prefetch.py's case), by argument and by
    config, equal to the JAX package's batches;
  - without a card, ``build_loader`` and ``device_prefetch`` raise unless the CPU is
    named;
  - the slice: the first batch of each package's ``build_loader`` over one fixture
    (equal bytes) goes through one SimT step and one warmup step of each package, from
    the same weights (``simt_state_from_jax`` / ``warmup_state_from_jax``); the losses
    agree to the existing step tests' tolerances (SimT rel 2e-3 / abs 2e-4, the golden
    trace's; warmup rel 2e-4 / abs 2e-5);
  - a uint8 batch from the loader and the same batch as float32 / int32 give equal
    losses in both steps.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.config import DataConfig as JDataConfig
from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import SimTConfig as JSimTConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.train import create_simt_state as j_create_simt
from simt_tpu.train import create_warmup_state as j_create_warmup
from simt_tpu.train import make_simt_step as j_make_simt
from simt_tpu.train import make_warmup_step as j_make_warmup
from simt_tpu.train.loop import build_loader as j_build_loader
from simt_tpu_torch.config import (IMG_MEAN_BGR, DataConfig, ModelConfig, SimTConfig,
                                   TrainConfig)
from simt_tpu_torch.data import device_prefetch, synthetic
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import simt_state_from_jax, warmup_state_from_jax
from simt_tpu_torch.train import (build_loader, create_simt_state, create_warmup_state,
                                  make_simt_step, make_warmup_step)

C, O = 5, 3
HW = (32, 64)  # crops of the 128x64 fixture: a 2x downscale


def _needs_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")


def test_device_prefetch_keeps_order_content_and_size():
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield {"image": np.full((1, 2, 2, 3), i, np.uint8), "name": [f"n{i}"],
                   "mirror": [i % 2 == 1]}

    it = device_prefetch(source(), size=2, device="cpu")
    first = next(it)
    assert pulled == [0, 1, 2]  # two more batches in flight behind the first
    out = [first, *it]
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["image"], torch.Tensor) and b["image"].dtype == torch.uint8
        assert int(b["image"][0, 0, 0, 0]) == i
        assert b["name"] == [f"n{i}"] and b["mirror"] == [i % 2 == 1]


def test_device_prefetch_closes_what_it_wraps_and_places_once():
    closed = []

    def source():
        try:
            for i in range(10):
                yield {"label": np.full((1, 2), i, np.uint8)}
        finally:
            closed.append(True)

    it = device_prefetch(source(), size=1, device="cpu")
    b = next(it)
    it.close()
    assert closed == [True]
    # The steps' torch.as_tensor on a tensor already on the device is the tensor itself.
    assert torch.as_tensor(b["label"], device="cpu") is b["label"]


def _gta5_root(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    names = []
    for i in range(2):
        name = f"{i:05d}.png"
        Image.fromarray(rng.randint(0, 255, (16, 32, 3), dtype=np.uint8)).save(
            tmp_path / "images" / name)
        Image.fromarray(rng.randint(0, 34, (16, 32), dtype=np.uint8)).save(
            tmp_path / "labels" / name)
        names.append(name)
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(names) + "\n")
    return str(tmp_path), str(lst)


def test_build_loader_gta5_source_equals_jax(tmp_path):
    root, lst = _gta5_root(tmp_path)
    data = dict(root=root, list_path=lst, crop_size=(16, 8), batch_size=1, num_workers=1,
                process_workers=False)
    cfg = TrainConfig(data=dataclasses.replace(DataConfig(), **data))
    jcfg = JTrainConfig(data=dataclasses.replace(JDataConfig(), **data))
    it = build_loader(cfg, source="gta5", device="cpu")
    batch = next(it)
    it.close()
    assert batch["image"].shape == (1, 8, 16, 3) and batch["image"].dtype == torch.uint8
    assert set(np.unique(batch["label"].numpy())) <= set(range(19)) | {255}
    want = next(j_build_loader(jcfg, source="gta5"))
    np.testing.assert_array_equal(batch["image"].numpy(), np.asarray(want["image"]))
    np.testing.assert_array_equal(batch["label"].numpy(), np.asarray(want["label"]))
    assert batch["name"] == want["name"] and batch["mirror"] == want["mirror"]
    # The same through the config (DataConfig.source), as the CLIs' --source-domain.
    cfg2 = cfg.replace(data=dataclasses.replace(cfg.data, source="gta5"))
    it = build_loader(cfg2, device="cpu")
    np.testing.assert_array_equal(next(it)["label"].numpy(), batch["label"].numpy())
    it.close()


def test_build_loader_and_prefetch_need_a_card_unless_the_cpu_is_named(tmp_path):
    _needs_a_host_without_a_card()
    root, lst = _gta5_root(tmp_path)
    cfg = TrainConfig(data=dataclasses.replace(DataConfig(), root=root, list_path=lst,
                                               source="gta5"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_loader(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        device_prefetch(iter([]))


@pytest.fixture(scope="module")
def first_batches(tmp_path_factory):
    """The first batch of each package's build_loader over one fixture (5 classes,
    128x64 images, 64x32 crops, mirror on, the port with 2 process workers)."""
    root = str(tmp_path_factory.mktemp("slice"))
    paths = synthetic.make_cityscapes_fixture(root, n_train=4, n_val=0,
                                              image_wh=(128, 64), num_classes=C)
    data = dict(root=root, list_path=paths["pseudo_lst"], crop_size=(HW[1], HW[0]),
                num_workers=2)
    cfg = TrainConfig(data=dataclasses.replace(DataConfig(), **data))
    jcfg = JTrainConfig(data=dataclasses.replace(JDataConfig(), process_workers=False,
                                                 **data))
    it = build_loader(cfg, device="cpu")
    got = next(it)
    it.close()
    want = next(j_build_loader(jcfg))
    assert got["name"] == want["name"] and got["mirror"] == want["mirror"]
    for k in ("image", "label"):
        assert got[k].dtype == torch.uint8 and want[k].dtype == jnp.uint8
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    return ({"image": got["image"], "label": got["label"]},
            {"image": want["image"], "label": want["label"]})


def _float_twin(batch):
    image = batch["image"].numpy().astype(np.float32) - np.asarray(IMG_MEAN_BGR, np.float32)
    return {"image": torch.from_numpy(image),
            "label": batch["label"].to(torch.int32)}


def test_simt_step_from_both_loaders_agrees(first_batches, tmp_path):
    batch, jbatch = first_batches
    cd = str(tmp_path / "cd.npy")
    np.save(cd, (np.ones(C) / C).astype(np.float32))
    simt = dict(class_dist=cd, inner_w_steps=3)
    jcfg = JTrainConfig(model=JModelConfig(num_classes=C, open_classes=O, openset=True,
                                           compute_dtype="float32"),
                        simt=dataclasses.replace(JSimTConfig(), **simt))
    cfg = TrainConfig(model=ModelConfig(num_classes=C, open_classes=O,
                                        compute_dtype="float32"),
                      simt=dataclasses.replace(SimTConfig(), **simt))
    jstudent = JResNetMulti(num_classes=C, open_classes=O, openset=True,
                            layers=(1, 1, 1, 1), dtype=jnp.float32)
    jteacher = JResNetMulti(num_classes=C, layers=(1, 1, 1, 1), dtype=jnp.float32)
    sv = jstudent.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), False)
    tv = jteacher.init(jax.random.PRNGKey(1), jnp.zeros((1, *HW, 3)), False)
    js = j_create_simt(sv, tv, jcfg, jax.random.PRNGKey(2))
    _, want = j_make_simt(jstudent, jteacher, jcfg)(js, jbatch)

    got = simt_state_from_jax(jax.tree.map(np.asarray, js))
    student = ResNetMulti(C, O, True, layers=(1, 1, 1, 1), dtype=torch.float32)
    teacher = ResNetMulti(C, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
    student.load_state_dict(got["student"], strict=True)
    teacher.load_state_dict(got["teacher"], strict=True)
    states = []
    for _ in range(2):
        st = create_simt_state(copy.deepcopy(student), copy.deepcopy(teacher), cfg,
                               torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            for k in ("t1", "t2", "w1", "w2"):
                getattr(st, k).param.copy_(got[k])
        st.step = got["step"]
        states.append(st)
    step = make_simt_step(cfg)
    m = step(states[0], batch)
    for k in ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=2e-3, abs=2e-4), k
    m32 = step(states[1], _float_twin(batch))
    for k in m:
        assert torch.equal(m[k], m32[k]), k


def test_warmup_step_from_both_loaders_agrees(first_batches):
    batch, jbatch = first_batches
    jcfg = JTrainConfig(model=JModelConfig(num_classes=C, openset=False,
                                           compute_dtype="float32"), stage="warmup")
    cfg = TrainConfig(model=ModelConfig(num_classes=C, compute_dtype="float32"))
    jmodel = JResNetMulti(num_classes=C, layers=(1, 1, 1, 1), dtype=jnp.float32)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), False)
    js = j_create_warmup(jmodel, jvars, jcfg)
    _, want = j_make_warmup(jmodel, jcfg)(js, jbatch)

    got = warmup_state_from_jax(jax.tree.map(np.asarray, js))
    model = ResNetMulti(C, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.load_state_dict(got["model"], strict=True)
    step = make_warmup_step(cfg)
    metrics = []
    for b in (batch, _float_twin(batch)):
        st = create_warmup_state(copy.deepcopy(model), cfg, "cpu")
        st.step = got["step"]
        metrics.append(step(st, b))
    for k in ("loss_seg1", "loss_seg2"):
        assert float(metrics[0][k]) == pytest.approx(float(want[k]), rel=2e-4, abs=2e-5), k
        assert torch.equal(metrics[0][k], metrics[1][k]), k
