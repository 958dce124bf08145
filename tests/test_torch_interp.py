"""Port vs JAX: align-corners bilinear upsample (simt_tpu_torch/ops/interp.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.ops.interp import _interp_matrix as jax_interp_matrix
from simt_tpu.ops.interp import upsample_bilinear_align_corners as jax_upsample
from simt_tpu_torch.ops.interp import _interp_matrix, interp_taps
from simt_tpu_torch.ops.interp import upsample_bilinear_align_corners

SHAPES = [
    ((5, 9), (16, 32)),
    ((65, 129), (512, 1024)),  # the training interp geometry
    ((7, 7), (7, 7)),  # identity
    ((16, 16), (5, 3)),  # downsample
    ((1, 4), (8, 8)),  # degenerate single row
    ((1, 1), (8, 16)),  # single source pixel (warmup's zero operand)
    ((4, 6), (1, 1)),  # single output pixel
]


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_upsample_matches_jax(in_hw, out_hw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x), out_hw))
    got = upsample_bilinear_align_corners(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(65, 1024), (161, 2048), (1, 8), (6, 1), (2, 2),
                                        (16, 5)])
def test_interp_taps_rebuild_the_jax_matrix(n_in, n_out):
    a = jax_interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(_interp_matrix(n_in, n_out), a)
    lo, hi, w0, w1 = interp_taps(n_in, n_out)
    assert lo.dtype == hi.dtype == np.int32 and w0.dtype == w1.dtype == np.float32
    assert (lo >= 0).all() and (hi < n_in).all() and (hi >= lo).all()
    rebuilt = np.zeros_like(a)
    rows = np.arange(n_out)
    rebuilt[rows, lo] += w0
    rebuilt[rows, hi] += w1
    np.testing.assert_array_equal(rebuilt, a)
