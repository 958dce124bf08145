"""Port vs JAX: the noise transition matrices (simt_tpu_torch/models/ntm.py).

Same parameters from numpy into both packages; float32, rtol = atol = 1e-6 (one
sigmoid / softmax and a row sum apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models import ntm as jntm
from simt_tpu_torch.models import ntm

NAMES = ["bapa", "sfdaseg", "adapt", "dsp", "ltir"]


@pytest.mark.parametrize("name", NAMES)
def test_class_dist_assets_equal_jax(name):
    np.testing.assert_array_equal(ntm.load_class_dist(name), jntm.load_class_dist(name))


@pytest.mark.parametrize("c,o", [(6, 4), (19, 15), (5, 0)])
def test_ntm_forward_matches_jax(c, o):
    rng = np.random.RandomState(c + o)
    param = rng.randn(c + o, c).astype(np.float32)
    cd = rng.rand(c).astype(np.float32) + 0.1
    cd /= cd.sum()
    want = np.asarray(jntm.ntm_forward(jnp.asarray(param), jnp.asarray(cd), c, o))
    got = ntm.ntm_forward(torch.from_numpy(param), torch.from_numpy(cd), c, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ntm_init_matches_jax_distribution():
    """Different generators, so the draws differ; shape, dtype and the kaiming
    fan_out std sqrt(2/(C+O)) agree (to 2% over 646 draws x 20)."""
    c, o = 19, 15
    got = torch.stack([ntm.ntm_init(torch.Generator().manual_seed(s), c, o)
                       for s in range(20)])
    want = np.stack([np.asarray(jntm.ntm_init(jax.random.PRNGKey(s), c, o))
                     for s in range(20)])
    assert got.shape[1:] == want.shape[1:] == (c + o, c)
    assert got.dtype == torch.float32
    assert float(got.std()) == pytest.approx(float(want.std()), rel=0.02)
    assert float(got.std()) == pytest.approx(np.sqrt(2.0 / (c + o)), rel=0.02)


def test_w_init_and_forward_match_jax():
    n_c, n_o = 19, 15
    np.testing.assert_array_equal(ntm.w_init(n_c, n_o).numpy(),
                                  np.asarray(jntm.w_init(n_c, n_o)))
    param = np.random.RandomState(2).randn(10, 10).astype(np.float32)
    want = np.asarray(jntm.w_forward(jnp.asarray(param)))
    got = ntm.w_forward(torch.from_numpy(param))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_w_forward_gradient_matches_jax_with_zero_diagonal():
    n = 6
    param = np.random.RandomState(3).randn(n, n).astype(np.float32)
    want = np.asarray(jax.grad(lambda p: jnp.sum(jntm.w_forward(p) ** 2))(
        jnp.asarray(param)))
    p = torch.from_numpy(param).requires_grad_(True)
    (ntm.w_forward(p) ** 2).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-7)
    assert torch.all(torch.diagonal(p.grad) == 0)
