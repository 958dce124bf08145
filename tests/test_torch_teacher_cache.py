"""Port vs JAX: the teacher-posterior cache (simt_tpu_torch/train/teacher_cache.py) and
the SimT step fed from it (train/simt.py, train/loop.py), the counterparts of
tests/test_teacher_cache.py:

  - a cached step (float32 storage) equals the uncached one from the same state within
    1e-5, a hit equals the miss bit for bit, and the cached step equals the JAX
    package's cached step at the tolerance of test_torch_simt_step.py's golden trace
    (rel 2e-3, abs 2e-4), on the layers (1,1,1,1) models at 32x64, 5 + 3 classes;
  - mirror flags get entries of their own; the port's ``Loader`` emits them;
  - the float16 storage rounds on the first visit, so the first and later visits are
    equal bit for bit;
  - ``train()`` with ``cache_teacher`` runs the teacher once an image (a forward hook
    counts), with ``iter_size`` 1 and 2 (``teacher_prob8`` stacked like the image).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.train import create_simt_state as j_create, make_simt_step as j_make
from simt_tpu.train.teacher_cache import TeacherCache as JTeacherCache
from simt_tpu_torch.config import IMG_MEAN_BGR
from simt_tpu_torch.data.pipeline import Loader, SegDataset
from simt_tpu_torch.data.synthetic import make_cityscapes_fixture, synthetic_batch
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import load_state, simt_state_from_jax
from simt_tpu_torch.train import create_simt_state, loop, make_simt_step
from simt_tpu_torch.train.teacher_cache import TeacherCache

from torch_loop_helpers import C, HW, LAYERS, O, configs, tiny_models

KEYS = ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX configs, models, initial SimT state (numpy) and step."""
    jcfg, tcfg = configs(tmp_path_factory.mktemp("tc"), "simt")
    from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti

    student = JResNetMulti(num_classes=C, open_classes=O, openset=True, layers=LAYERS,
                           dtype=jnp.float32)
    teacher = JResNetMulti(num_classes=C, layers=LAYERS, dtype=jnp.float32)
    def init(model, seed):
        return jax.jit(lambda r: model.init(r, jnp.zeros((1, *HW, 3)), False))(
            jax.random.PRNGKey(seed))

    js = j_create(init(student, 0), init(teacher, 1), jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, teacher, js, j_make(student, teacher, jcfg)


def _port_state(js, tcfg):
    st = create_simt_state(ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32),
                           ResNetMulti(C, 0, False, layers=LAYERS, dtype=torch.float32),
                           tcfg, torch.Generator().manual_seed(0), "cpu")
    load_state(st, simt_state_from_jax(jax.tree.map(np.asarray, js)))
    return st


def _floats(m):
    return {k: float(m[k]) for k in KEYS}


def test_cached_step_matches_uncached_and_jax(jax_side):
    jcfg, tcfg, jteacher, js, jstep = jax_side
    b = synthetic_batch(1, HW, C, seed=0)
    named = {**b, "name": ["img0"], "mirror": [False]}

    plain = _floats(make_simt_step(tcfg)(_port_state(js, tcfg), b))
    st = _port_state(js, tcfg)
    cache = TeacherCache(st.teacher, store_dtype=torch.float32)  # exact storage
    miss_batch = cache.attach(named)
    assert cache.misses == 1 and cache.hits == 0 and len(cache) == 1
    assert set(miss_batch) == {"image", "label", "teacher_prob8"}
    miss = _floats(make_simt_step(tcfg)(st, miss_batch))
    for k in KEYS:
        assert miss[k] == pytest.approx(plain[k], rel=1e-5, abs=1e-5), k

    # Second epoch: a hit, no teacher forward, the same metrics bit for bit.
    calls = []
    handle = st.teacher.register_forward_hook(lambda *a: calls.append(1))
    hit_batch = cache.attach(named)
    handle.remove()
    assert cache.hits == 1 and not calls
    assert torch.equal(hit_batch["teacher_prob8"], miss_batch["teacher_prob8"])
    hit = _floats(make_simt_step(tcfg)(_port_state(js, tcfg), hit_batch))
    assert hit == miss

    jcache = JTeacherCache(jteacher, js.teacher_params, js.teacher_batch_stats,
                           store_dtype=np.float32)
    _, jm = jstep(js, jcache.attach({**{k: jnp.asarray(v) for k, v in b.items()},
                                     "name": ["img0"], "mirror": [False]}))
    np.testing.assert_allclose(miss_batch["teacher_prob8"][0].numpy(),
                               np.asarray(jcache._cache[("img0", False)]), rtol=1e-4,
                               atol=1e-5)
    for k in KEYS:
        assert miss[k] == pytest.approx(float(jm[k]), rel=2e-3, abs=2e-4), k


def test_cache_distinguishes_mirror(jax_side):
    _, tcfg, _, js, _ = jax_side
    cache = TeacherCache(_port_state(js, tcfg).teacher)
    b = synthetic_batch(1, HW, C, seed=1)
    cache.attach({**b, "name": ["x"], "mirror": [False]})
    cache.attach({**b, "name": ["x"], "mirror": [True]})
    assert cache.misses == 2 and len(cache) == 2  # separate entries per mirror flag


def test_float16_storage_rounds_on_the_first_visit(jax_side):
    _, tcfg, _, js, _ = jax_side
    st = _port_state(js, tcfg)
    cache = TeacherCache(st.teacher)
    b = synthetic_batch(2, HW, C, seed=2)
    named = {**b, "name": ["a", "b"], "mirror": [False, True]}
    first = cache.attach(named)["teacher_prob8"]
    again = cache.attach(named)["teacher_prob8"]
    assert first.dtype == torch.float32 and torch.equal(first, again)
    assert (cache.misses, cache.hits) == (2, 2)
    exact = cache.forward(b["image"])
    assert torch.equal(first, exact.half().float())
    assert 0 < float((first - exact).abs().max()) <= 5e-4
    # A batch of one hit and one miss: the miss from this forward, the hit from storage.
    mixed = cache.attach({**b, "name": ["a", "c"], "mirror": [False, False]})
    assert torch.equal(mixed["teacher_prob8"][0], first[0]) and len(cache) == 3
    unnamed = cache.attach(b)  # no names: computed, not cached
    assert torch.equal(unnamed["teacher_prob8"], exact) and len(cache) == 3


def test_loader_emits_name_and_mirror_flag(tmp_path):
    paths = make_cityscapes_fixture(str(tmp_path), n_train=2, image_wh=(32, 16))
    ds = SegDataset.cityscapes_pseudo(paths["root"], paths["pseudo_lst"], crop_wh=(16, 8),
                                      mean_bgr=IMG_MEAN_BGR, mirror=True)
    b = next(iter(Loader(ds, batch_size=2, seed=0, num_workers=1, process_workers=False)))
    assert len(b["mirror"]) == 2 and len(b["name"]) == 2


@pytest.mark.parametrize("iter_size", [1, 2])
def test_train_runs_the_teacher_once_an_image(tmp_path, monkeypatch, iter_size):
    tiny_models(monkeypatch)
    _, cfg = configs(tmp_path, "simt", num_steps_stop=3)
    cfg = cfg.replace(simt=cfg.simt.__class__(**{**cfg.simt.__dict__, "cache_teacher": True}),
                      optim=cfg.optim.__class__(**{**cfg.optim.__dict__,
                                                   "iter_size": iter_size}))
    calls = []
    real_build = loop.build_models

    def counted(c):
        student, teacher = real_build(c)
        teacher.register_forward_hook(lambda *a: calls.append(1))
        return student, teacher

    monkeypatch.setattr(loop, "build_models", counted)

    def named():
        for i in range(100):
            yield {**synthetic_batch(1, HW, C, seed=i % 2), "name": [f"img{i % 2}"],
                   "mirror": [False]}

    lines = []
    out = loop.train(cfg, batch_iter=named(), print_fn=lines.append, device="cpu")
    assert any("teacher cache enabled" in s for s in lines)
    assert out["state"].step == 3 and len(calls) == 2  # two images, one miss each
    assert all(np.isfinite(v) for v in out["final_metrics"].values())
