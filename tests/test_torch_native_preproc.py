"""Port vs JAX and PIL: the native preprocessing library
(simt_tpu_torch/data/_native_preproc.py, data/_native/preproc.cpp).

The cases of tests/test_native_preproc.py: bicubic bit-identical to Pillow at every
parametrised size and nearest at the production label sizes, each equal to the JAX
package's native output too; the fused preprocess against PIL's float path; the pipeline
with the native path on and off. Then what the port adds: the library is built from the
port's own source into the git-ignored ``build/native/`` under a name that changes with
the source, nothing built is kept in the package, and a failed build raises instead of
falling back to PIL.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from simt_tpu.data import _native_preproc as jnative
from simt_tpu_torch.config import IMG_MEAN_BGR
from simt_tpu_torch.data import _native_preproc as native
from simt_tpu_torch.data import pipeline, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1024, 2048), (512, 1024)),  # the pseudo-label training geometry
    ((37, 53), (16, 24)),
    ((16, 24), (37, 53)),
    ((50, 50), (50, 50)),
])
def test_bicubic_bit_exact(src_hw, dst_hw):
    src = np.random.RandomState(0).randint(0, 256, (*src_hw, 3), dtype=np.uint8)
    pil = np.asarray(Image.fromarray(src).resize((dst_hw[1], dst_hw[0]), Image.BICUBIC))
    got = native.resize_bicubic(src, *dst_hw)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jnative.resize_bicubic(src, *dst_hw))
    np.testing.assert_array_equal(native.resize_bicubic(src[:, :, 0], *dst_hw), pil[:, :, 0])


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1024, 2048), (512, 1024)),  # the only label resize of Cityscapes training
    ((1052, 1914), (512, 1024)),  # the GTA5 label geometry
    ((64, 128), (16, 32)),
])
def test_nearest_bit_exact_at_production_sizes(src_hw, dst_hw):
    src = np.random.RandomState(1).randint(0, 34, src_hw).astype(np.uint8)
    pil = np.asarray(Image.fromarray(src).resize((dst_hw[1], dst_hw[0]), Image.NEAREST))
    got = native.resize_nearest(src, *dst_hw)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jnative.resize_nearest(src, *dst_hw))


def test_fused_preprocess_matches_pil_path():
    src = np.random.RandomState(2).randint(0, 256, (64, 96, 3), dtype=np.uint8)
    for mirror in (False, True):
        got = native.preprocess_image(src, 32, 48, IMG_MEAN_BGR, mirror=mirror)
        ref = np.asarray(Image.fromarray(src).resize((48, 32), Image.BICUBIC), np.float32)
        if mirror:
            ref = ref[:, ::-1]
        ref = ref[:, :, ::-1] - np.asarray(IMG_MEAN_BGR, np.float32)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_array_equal(
            got, jnative.preprocess_image(src, 32, 48, IMG_MEAN_BGR, mirror=mirror))
    with pytest.raises(ValueError, match="RGB"):
        native.preprocess_image(src[:, :, :2], 32, 48, IMG_MEAN_BGR)


def test_pipeline_native_vs_pil_identical(tmp_path):
    paths = synthetic.make_cityscapes_fixture(str(tmp_path), n_train=2, image_wh=(64, 32))
    ds = pipeline.SegDataset.cityscapes_pseudo(paths["root"], paths["pseudo_lst"],
                                               crop_wh=(32, 16), mean_bgr=IMG_MEAN_BGR)
    old = pipeline.USE_NATIVE
    try:
        pipeline.USE_NATIVE = True
        assert pipeline._native() is native
        a = ds.get(0)
        pipeline.USE_NATIVE = False
        assert pipeline._native() is None
        b = ds.get(0)
    finally:
        pipeline.USE_NATIVE = old
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])


def test_built_from_the_ports_own_source_into_build(tmp_path, monkeypatch):
    assert native.SOURCE == os.path.join(REPO, "simt_tpu_torch", "data", "_native",
                                         "preproc.cpp")
    with open(native.SOURCE) as f:
        assert "simt_preprocess_image" in f.read()
    assert native.load()  # built at first use
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()
    # Nothing built is kept inside the package.
    for _, _, files in os.walk(os.path.join(REPO, "simt_tpu_torch")):
        assert not [f for f in files if f.endswith((".so", ".o"))], files
    # The name follows the source: an edited source is built anew.
    edited = tmp_path / "preproc.cpp"
    shutil.copy(native.SOURCE, edited)
    with open(edited, "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(edited))
    assert native.library_path() != path


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="build failed"):
        native.load()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="build failed"):
        native.load()
    paths = synthetic.make_cityscapes_fixture(str(tmp_path / "fx"), n_train=1, n_val=0,
                                              image_wh=(64, 32))
    image = os.path.join(paths["root"], "train", "city",
                         "city_000000_000019_leftImg8bit.png")
    monkeypatch.setattr(pipeline, "USE_NATIVE", True)
    with pytest.raises(RuntimeError, match="build failed"):
        pipeline.load_image_bgr_u8(image, (32, 16))
    monkeypatch.setattr(pipeline, "USE_NATIVE", False)  # PIL only when asked for
    assert pipeline.load_image_bgr_u8(image, (32, 16)).shape == (16, 32, 3)
    assert not os.listdir(tmp_path / "native")  # no partial library left behind
