"""Port vs JAX: the host input pipeline (simt_tpu_torch/data/pipeline.py, data/lists.py).

The cases of tests/test_data.py on the same synthetic fixture (seeded numpy), each held
to the JAX package's functions bit for bit: the pseudo dataset's shapes and wire
format, ``load_image_bgr_u8`` / ``load_image_bgr`` / ``load_label`` with the native
library and with PIL, the mirror, ``remap_gta5_ids`` on all 256 ids, and the
``Loader``'s batches (names, mirror flags, image and label bytes) over 2+ epochs with
threads and with processes, with the crop cache off and on, the short last batch and
``process_shard``; the crop cache (a hit equals a miss, an mtime change misses, a
truncated entry is recomputed); the lists and presets; ``evaluate(process_workers=True)``
equal to threads and to the JAX package's histogram. Process pools use 2 workers.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu import config as jconfig
from simt_tpu.data import lists as jlists
from simt_tpu.data import pipeline as jp
from simt_tpu.eval import evaluate as jax_evaluate
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu_torch import config
from simt_tpu_torch.config import IMG_MEAN_BGR
from simt_tpu_torch.data import lists, synthetic
from simt_tpu_torch.data import pipeline as tp
from simt_tpu_torch.eval import evaluate
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.from_jax import state_dict_from_flax

CROP = (32, 16)  # (w, h): a 2x downscale of the 64x32 fixture


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    return synthetic.make_cityscapes_fixture(str(root), n_train=5, n_val=2,
                                             image_wh=(64, 32))


@pytest.fixture
def use_native(request):
    """Sets both packages' native switch to ``request.param`` for one test."""
    old = tp.USE_NATIVE, jp.USE_NATIVE
    tp.USE_NATIVE = jp.USE_NATIVE = request.param
    yield request.param
    tp.USE_NATIVE, jp.USE_NATIVE = old


def _pseudo(mod, paths, **kw):
    return mod.SegDataset.cityscapes_pseudo(paths["root"], paths["pseudo_lst"],
                                            crop_wh=CROP, mean_bgr=IMG_MEAN_BGR, **kw)


def test_pseudo_dataset_shapes(fixture_root):
    ds = _pseudo(tp, fixture_root)
    assert len(ds) == 5
    item = ds.get(0)
    assert item["image"].shape == (16, 32, 3) and item["image"].dtype == np.uint8
    assert item["label"].shape == (16, 32) and item["label"].dtype == np.uint8
    assert item["mirror"] is False
    names = [s.name for s in ds.samples]
    assert names == [s.name for s in _pseudo(jp, fixture_root).samples]


def test_wire_format_composes_to_the_reference_math(fixture_root):
    """uint8 on the host + ``normalize_image`` on the device = resize -> float32 ->
    BGR -> mean-sub (cityscapes_dataset.py:100,105,117-118)."""
    from PIL import Image

    ds = _pseudo(tp, fixture_root)
    s = ds.samples[0]
    img = Image.open(s.image_path).convert("RGB").resize(CROP, Image.BICUBIC)
    want = np.asarray(img, np.float32)[:, :, ::-1] - np.asarray(IMG_MEAN_BGR, np.float32)
    got = tp.normalize_image(torch.from_numpy(ds.get(0)["image"]), IMG_MEAN_BGR)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tp.load_image_bgr(s.image_path, CROP, IMG_MEAN_BGR), want,
                               atol=1e-5)
    lab = torch.from_numpy(ds.get(0)["label"])
    assert tp.normalize_label(lab).dtype == torch.int32
    assert torch.equal(tp.normalize_label(lab), lab.to(torch.int32))
    # The mean is made on the device once, not copied from the host at every call.
    assert tp._mean_on(got.device, IMG_MEAN_BGR) is tp._mean_on(got.device, IMG_MEAN_BGR)
    f = torch.zeros(2, dtype=torch.float32)
    assert tp.normalize_image(f, IMG_MEAN_BGR) is f
    i = torch.zeros(2, dtype=torch.int32)
    assert tp.normalize_label(i) is i


@pytest.mark.parametrize("use_native", [True, False], indirect=True,
                         ids=["native", "pil"])
def test_load_functions_equal_jax(fixture_root, use_native):
    ds = _pseudo(tp, fixture_root)
    for s in ds.samples[:3]:
        for mirror in (False, True):
            got = tp.load_image_bgr_u8(s.image_path, CROP, mirror=mirror)
            want = jp.load_image_bgr_u8(s.image_path, CROP, mirror=mirror)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tp.load_image_bgr(s.image_path, CROP, IMG_MEAN_BGR, mirror=mirror),
                jp.load_image_bgr(s.image_path, CROP, IMG_MEAN_BGR, mirror=mirror))
        got, want = tp.load_label(s.label_path, CROP), jp.load_label(s.label_path, CROP)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    a, b = ds.get(0), _pseudo(jp, fixture_root).get(0)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])


def test_mirror_only_flips_width(fixture_root):
    ds = _pseudo(tp, fixture_root, mirror=True)
    base = ds.get(0, rng=None)
    seen = set()
    for seed in range(8):
        item = ds.get(0, np.random.default_rng(seed))
        want_image = base["image"][:, ::-1] if item["mirror"] else base["image"]
        want_label = base["label"][:, ::-1] if item["mirror"] else base["label"]
        np.testing.assert_array_equal(item["image"], want_image)
        np.testing.assert_array_equal(item["label"], want_label)
        assert item["mirror"] == _pseudo(jp, fixture_root, mirror=True).get(
            0, np.random.default_rng(seed))["mirror"]
        seen.add(item["mirror"])
    assert seen == {False, True}


def test_remap_gta5_ids_equals_jax_on_all_ids():
    label = np.arange(256, dtype=np.int32).reshape(16, 16)
    got = tp.remap_gta5_ids(label)
    np.testing.assert_array_equal(got, jp.remap_gta5_ids(label))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(tp.remap_gta5_ids(np.array([[7, 8, 0], [33, 34, 255]])),
                                  [[0, 1, 255], [18, 255, 255]])
    assert lists.GTA5_ID_TO_TRAINID == jlists.GTA5_ID_TO_TRAINID


def _batches(mod, ds, n, **kw):
    it = iter(mod.Loader(ds, batch_size=kw.pop("batch_size", 2), **kw))
    try:
        return [next(it) for _ in range(n)] if n else list(it)
    finally:
        it.close()


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["name"] == b["name"]
        assert a["mirror"] == b["mirror"]
        assert a["image"].dtype == b["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["image"], b["image"])
        if "label" in b:
            assert a["label"].dtype == b["label"].dtype == np.uint8
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("process_workers", [False, True], ids=["threads", "processes"])
@pytest.mark.parametrize("cache", [False, True], ids=["no_cache", "crop_cache"])
def test_loader_yields_jax_batches(fixture_root, tmp_path, process_workers, cache):
    """Six batches of 2 over 5 samples: 2.4 epochs, each reshuffled, mirror on. The
    reference is the JAX loader with threads (its own tests hold processes to them)."""
    want = _batches(jp, _pseudo(jp, fixture_root, mirror=True), 6, seed=3, num_workers=2)
    ds = _pseudo(tp, fixture_root, mirror=True,
                 cache_dir=str(tmp_path / "cc") if cache else "")
    got = _batches(tp, ds, 6, seed=3, num_workers=2, process_workers=process_workers)
    _assert_same_batches(got, want)
    assert {n for b in got for n in b["name"]} == {s.name for s in ds.samples}
    assert {m for b in got for m in b["mirror"]} == {False, True}
    if cache:  # every image and label went through the cache
        assert len(list((tmp_path / "cc").glob("*.npy"))) == 2 * len(ds)
    other = _batches(tp, ds, 3, seed=4, num_workers=2)
    assert [b["name"] for b in other] != [b["name"] for b in got[:3]]


def test_short_last_batch_and_no_repeat(fixture_root):
    kw = dict(shuffle=False, loop=False, drop_last=False, num_workers=2)
    ds = tp.SegDataset.cityscapes_eval(fixture_root["root"], fixture_root["val_txt"],
                                       crop_wh=(64, 32), mean_bgr=IMG_MEAN_BGR)
    jds = jp.SegDataset.cityscapes_eval(fixture_root["root"], fixture_root["val_txt"],
                                        crop_wh=(64, 32), mean_bgr=IMG_MEAN_BGR)
    assert "label" not in ds.get(0) and ds.get(0)["image"].shape == (32, 64, 3)
    got = _batches(tp, _pseudo(tp, fixture_root), 0, **kw)
    assert [len(b["name"]) for b in got] == [2, 2, 1]
    _assert_same_batches(got, _batches(jp, _pseudo(jp, fixture_root), 0, **kw))
    _assert_same_batches(_batches(tp, ds, 0, batch_size=1, **kw),
                         _batches(jp, jds, 0, batch_size=1, **kw))
    kw["drop_last"] = True
    assert [len(b["name"]) for b in _batches(tp, _pseudo(tp, fixture_root), 0, **kw)] \
        == [2, 2]


def test_process_shard_yields_jax_blocks(fixture_root):
    ds, jds = _pseudo(tp, fixture_root, mirror=True), _pseudo(jp, fixture_root, mirror=True)
    whole = _batches(tp, ds, 4, batch_size=2, seed=5, num_workers=2)
    for idx in range(2):
        got = _batches(tp, ds, 4, batch_size=1, seed=5, num_workers=2,
                       process_shard=(idx, 2))
        _assert_same_batches(got, _batches(jp, jds, 4, batch_size=1, seed=5,
                                           num_workers=2, process_shard=(idx, 2)))
        for g, w in zip(got, whole):  # block idx of each global batch of 2
            assert g["name"] == w["name"][idx:idx + 1]
            np.testing.assert_array_equal(g["image"][0], w["image"][idx])


def test_crop_cache_hit_equals_miss_and_mtime_misses(fixture_root, tmp_path):
    import shutil

    root = tmp_path / "data"
    shutil.copytree(fixture_root["root"], root)
    lst = os.path.join(root, "lists", "pseudo.lst")
    cache = tmp_path / "cc"
    plain = tp.SegDataset.cityscapes_pseudo(str(root), lst, crop_wh=CROP,
                                            mean_bgr=IMG_MEAN_BGR, mirror=True)
    cached = tp.SegDataset.cityscapes_pseudo(str(root), lst, crop_wh=CROP,
                                             mean_bgr=IMG_MEAN_BGR, mirror=True,
                                             cache_dir=str(cache))
    for _ in range(2):  # pass 1 fills the cache (misses), pass 2 reads it (hits)
        for i in range(len(plain)):
            for seed in (0, 1, 7):
                a = plain.get(i, np.random.default_rng(seed))
                b = cached.get(i, np.random.default_rng(seed))
                assert a["mirror"] == b["mirror"]
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["label"], b["label"])
    files = sorted(cache.glob("*.npy"))
    assert len(files) == 2 * len(plain)
    # A regenerated label at the same path misses: a new entry, the new content.
    s = plain.samples[0]
    lab = np.asarray(tp.load_label(s.label_path, (64, 32)), np.uint8)
    from PIL import Image

    Image.fromarray(np.where(lab == 255, 255, 0).astype(np.uint8), mode="L").save(
        s.label_path)
    st = os.stat(s.label_path)
    os.utime(s.label_path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    item = cached.get(0)
    assert len(list(cache.glob("*.npy"))) == 2 * len(plain) + 1
    np.testing.assert_array_equal(item["label"], plain.get(0)["label"])
    assert set(np.unique(item["label"])) <= {0, 255}
    # A truncated entry (a writer that died) is recomputed and rewritten: the regenerated
    # label's new entry, which the next pass reads (sample 0's old label entry is stale
    # and never read again, so it cannot be the victim).
    victim = next(p for p in cache.glob("*.npy") if p not in files)
    data = victim.read_bytes()
    victim.write_bytes(data[: len(data) // 2])
    for i in range(len(plain)):
        np.testing.assert_array_equal(cached.get(i)["image"], plain.get(i)["image"])
    assert victim.read_bytes() == data
    # The JAX cache keys the same way: its entries land on the same names.
    jcache = tmp_path / "jcc"
    jp.SegDataset.cityscapes_pseudo(str(root), lst, crop_wh=CROP, mean_bgr=IMG_MEAN_BGR,
                                    cache_dir=str(jcache)).get(1)
    tp.SegDataset.cityscapes_pseudo(str(root), lst, crop_wh=CROP, mean_bgr=IMG_MEAN_BGR,
                                    cache_dir=str(tmp_path / "tcc")).get(1)
    assert sorted(p.name for p in jcache.glob("*.npy")) == \
        sorted(p.name for p in (tmp_path / "tcc").glob("*.npy"))


def test_gta5_dataset_remaps_before_the_cache(tmp_path):
    from PIL import Image

    root = tmp_path / "gta"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (16, 32, 3), np.uint8)).save(root / "images" / "a.png")
    Image.fromarray(rng.integers(0, 40, (16, 32)).astype(np.uint8), mode="L").save(
        root / "labels" / "a.png")
    (root / "train.txt").write_text("a.png\n")
    args = (str(root), str(root / "train.txt"))
    kw = dict(crop_wh=(16, 8), mean_bgr=IMG_MEAN_BGR)
    want = jp.SegDataset.gta5(*args, **kw).get(0)
    ds = tp.SegDataset.gta5(*args, cache_dir=str(tmp_path / "cc"), **kw)
    for _ in range(2):  # a decode, then a cache read
        item = ds.get(0)
        np.testing.assert_array_equal(item["label"], want["label"])
        np.testing.assert_array_equal(item["image"], want["image"])
        assert set(np.unique(item["label"])) <= set(range(19)) | {255}


def test_read_pair_list_and_assets(tmp_path):
    bad = tmp_path / "bad.lst"
    bad.write_text("a.png\tb.png\n\nc.png\n")
    with pytest.raises(ValueError, match="2 columns"):
        lists.read_pair_list(str(bad))
    bad.write_text("a.png\tb.png\n\nc.png d.png\n")
    assert lists.read_pair_list(str(bad)) == [("a.png", "b.png"), ("c.png", "d.png")]
    for sub, name in [("cityscapes_list", n) for n in (
            "train.txt", "label.txt", "val.txt", "pseudo_adapt.lst", "pseudo_bapa.lst",
            "pseudo_dsp.lst", "pseudo_ltir.lst", "pseudo_sfdaseg.lst",
            "pseudo_sfdaseg_so.lst")] + [("gta5_list", "train.txt")]:
        mine = os.path.join(lists.ASSETS_DIR, sub, name)
        with open(mine, "rb") as a, open(os.path.join(jlists.ASSETS_DIR, sub, name),
                                         "rb") as b:
            assert a.read() == b.read(), name
        if name.endswith(".lst"):
            assert lists.read_pair_list(mine) == jlists.read_pair_list(mine)


def test_data_config_and_presets_match_jax():
    mine, theirs = config.DataConfig(), jconfig.DataConfig()
    for f in dataclasses.fields(mine):
        want = getattr(theirs, f.name)
        got = getattr(mine, f.name)
        if f.name == "list_path":
            assert os.path.basename(got) == os.path.basename(want)
            assert got.startswith(lists.ASSETS_DIR)
        else:
            assert got == want, f.name
    for name in ("simt_bapa_lr25", "simt_bapa_lr6", "simt_sfda", "warmup_bapa"):
        assert os.path.basename(config.preset(name).data.list_path) == \
            os.path.basename(jconfig.preset(name).data.list_path), name


def test_evaluate_process_workers_equal_threads_and_jax(tmp_path):
    paths = synthetic.make_cityscapes_fixture(str(tmp_path), n_train=0, n_val=3,
                                              image_wh=(64, 32))
    jmodel = JResNetMulti(num_classes=19, layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 3)), False)
    model = ResNetMulti(19, layers=(1, 1, 1, 1), dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, variables)))
    kw = dict(data_root=paths["root"], val_list=paths["val_txt"], gt_dir=paths["gt_dir"],
              scales=((32, 16), (40, 20)), out_hw=(32, 64), return_hist=True,
              print_fn=lambda s: None)
    _, threads = evaluate(model, device="cpu", **kw)
    _, procs = evaluate(model, device="cpu", process_workers=True, **kw)
    np.testing.assert_array_equal(procs, threads)
    _, want = jax_evaluate(jmodel, variables, **kw)
    counted = 3 * 32 * 64
    assert procs.sum() == want.sum() == counted
    # The tolerance of tests/test_torch_evaluate.py: float32 summation order may flip
    # near-tie argmaxes.
    assert np.abs(procs - want).sum() <= 0.01 * counted


@pytest.mark.parametrize("num_classes", [19, 5])
def test_fixture_equals_jax_fixture(tmp_path, num_classes):
    """The port's fixture writes the JAX fixture's files, for any class count (a
    5-class fixture used to raise an IndexError in the port's label-id table)."""
    from PIL import Image

    from simt_tpu.data import synthetic as jsynthetic

    kw = dict(n_train=2, n_val=2, image_wh=(32, 16), num_classes=num_classes, seed=3)
    a = synthetic.make_cityscapes_fixture(str(tmp_path / "port"), **kw)
    b = jsynthetic.make_cityscapes_fixture(str(tmp_path / "jax"), **kw)
    files = []
    for key in ("pseudo_lst", "val_txt"):
        with open(a[key]) as fa, open(b[key]) as fb:
            text = fa.read()
            assert text == fb.read()
        files += text.split()
    for name in files:
        for sub in ("", "val"):
            pa, pb = os.path.join(a["root"], sub, name), os.path.join(b["root"], sub, name)
            if os.path.exists(pb):
                np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                              np.asarray(Image.open(pb)))
    gts = sorted(os.listdir(os.path.join(b["gt_dir"], "city")))
    assert gts == sorted(os.listdir(os.path.join(a["gt_dir"], "city"))) and len(gts) == 2
    for gt in gts:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(a["gt_dir"], "city", gt))),
            np.asarray(Image.open(os.path.join(b["gt_dir"], "city", gt))))
