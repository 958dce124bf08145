"""Port vs JAX: confusion histogram and IoU metrics (simt_tpu_torch/ops/metrics.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.ops import metrics as jm
from simt_tpu_torch.ops import metrics as tm


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_hist_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 19
    label = rng.randint(-3, 40, size=(7, 300))  # negatives and ids >= n
    label[rng.rand(7, 300) < 0.2] = 255
    pred = rng.randint(0, n, size=(7, 300))
    want = np.asarray(jm.fast_hist(jnp.asarray(label), jnp.asarray(pred), n))
    got = tm.fast_hist(torch.from_numpy(label), torch.from_numpy(pred), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_per_class_iu_and_mean_iou_match_jax():
    rng = np.random.RandomState(2)
    hist = rng.randint(0, 50, size=(19, 19)).astype(np.float64)
    hist[3] = 0
    hist[:, 3] = 0  # an absent class: NaN IoU, skipped by nanmean
    np.testing.assert_array_equal(tm.per_class_iu(hist), jm.per_class_iu(hist))
    np.testing.assert_array_equal(tm.per_class_iu(torch.from_numpy(hist)),
                                  jm.per_class_iu(hist))
    assert tm.mean_iou(hist) == jm.mean_iou(hist)


def test_label_mapping_matches_jax():
    from simt_tpu_torch.data.lists import load_info

    rng = np.random.RandomState(3)
    mapping = load_info()["label2train"]
    label = rng.randint(0, 34, size=(20, 30)).astype(np.uint8)
    label[0, :5] = 255
    got = tm.label_mapping(label, mapping)
    np.testing.assert_array_equal(got, jm.label_mapping(label, mapping))
