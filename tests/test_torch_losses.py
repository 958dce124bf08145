"""Port vs JAX: the unfused losses (simt_tpu_torch/ops/losses.py) and the schedule.

Inputs from numpy seeds into both packages, float32. Tolerance rtol 1e-5 / atol 1e-5
(sums over a few hundred pixels in another order), 1e-4 for the volume term (a
log-determinant of a near-singular Gram matrix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu import ops as jops
from simt_tpu.ops.schedules import poly_lr as jpoly_lr
from simt_tpu_torch.ops import losses
from simt_tpu_torch.ops.schedules import poly_lr


def _logits_labels(seed=0, b=2, h=6, w=7, c=5, ignore_frac=0.3):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, h, w, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, size=(b, h, w)).astype(np.int32)
    labels[rng.rand(b, h, w) < ignore_frac] = 255
    return logits, labels


def _close(got, want, tol=1e-5):
    assert float(got) == pytest.approx(float(want), rel=tol, abs=tol)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    logits, labels = _logits_labels()
    cw = np.linspace(0.5, 2.0, 5).astype(np.float32) if weighted else None
    want = jops.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(labels),
                                 class_weight=None if cw is None else jnp.asarray(cw))
    got = losses.cross_entropy_2d(torch.from_numpy(logits), torch.from_numpy(labels),
                                  class_weight=None if cw is None else torch.from_numpy(cw))
    _close(got, want)


@pytest.mark.parametrize("fn", ["cross_entropy_2d", "nll_from_probs_2d"])
def test_all_ignored_gives_zero(fn):
    x = torch.rand(1, 2, 2, 3) + 0.1
    labels = torch.full((1, 2, 2), 255, dtype=torch.int32)
    assert float(getattr(losses, fn)(x, labels)) == 0.0


def test_nll_from_probs_matches_jax():
    logits, labels = _logits_labels(1)
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    want = jops.nll_from_probs_2d(jnp.asarray(probs), jnp.asarray(labels))
    _close(losses.nll_from_probs_2d(torch.from_numpy(probs), torch.from_numpy(labels)), want)


def test_entropy_matches_jax():
    logits, _ = _logits_labels(2)
    _close(losses.entropy_loss(torch.from_numpy(logits)),
           jops.entropy_loss(jnp.asarray(logits)))


@pytest.mark.parametrize("threshold,seed", [(0.5, 3), (None, 4), (0.8, 5)])
def test_placeholder_matches_jax(threshold, seed):
    logits, _ = _logits_labels(seed, c=10)
    kw = dict(num_classes=6, open_classes=4, lambda_place=0.1, threshold=threshold)
    _close(losses.placeholder_loss(torch.from_numpy(logits), **kw),
           jops.placeholder_loss(jnp.asarray(logits), **kw), tol=1e-4)


def test_placeholder_negative_open_logits_pick_a_known_channel():
    """Every open logit negative: the unknown label is channel 0 (a known channel at
    value 0), as in the reference's zeros_like fill."""
    logits = -np.abs(np.random.RandomState(6).randn(1, 3, 4, 8)).astype(np.float32)
    logits[..., 0] = 5.0  # argmax is known class 0 everywhere
    kw = dict(num_classes=5, open_classes=3, lambda_place=1.0, threshold=None)
    _close(losses.placeholder_loss(torch.from_numpy(logits), **kw),
           jops.placeholder_loss(jnp.asarray(logits), **kw), tol=1e-5)


@pytest.mark.parametrize("eps,tol", [(None, 1e-5), (1e-2, 1e-4), (1e-3, 2e-3)])
def test_volume_loss_matches_jax(eps, tol):
    """An NTM-like T (identity prior plus noise, rows normalised); with ``eps`` two
    columns nearly equal, a near-singular Gram matrix. The tolerance grows with the
    conditioning: at eps 1e-3 both packages' float32 results sit about 1e-3 from the
    float64 value."""
    rng = np.random.RandomState(7)
    t = rng.rand(34, 19).astype(np.float32) * 0.3
    t[:19] += np.eye(19, dtype=np.float32)
    if eps:
        t[:, 1] = t[:, 0] + eps * t[:, 1]
    t /= t.sum(1, keepdims=True)
    got = losses.volume_loss(torch.from_numpy(t))
    assert torch.isfinite(got)
    _close(got, jops.volume_loss(jnp.asarray(t)), tol=tol)


def test_finite_or_zero_and_mse_sum():
    x = torch.tensor([np.inf, -np.inf, np.nan, -3.5])
    assert losses.finite_or_zero(x).tolist() == [0.0, 0.0, 0.0, -3.5]
    rng = np.random.RandomState(8)
    a, b = rng.randn(7, 5).astype(np.float32), rng.randn(7, 5).astype(np.float32)
    _close(losses.mse_sum(torch.from_numpy(a), torch.from_numpy(b)),
           jops.mse_sum(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("step", [0, 1, 1234, 249_999])
def test_poly_lr_matches_jax(step):
    """The port computes in double, JAX in float32: they agree to the float32
    rounding of 1 - step/max_steps (1e-7 of the base rate)."""
    assert poly_lr(2.5e-4, step, 250_000) == pytest.approx(
        float(jpoly_lr(2.5e-4, step, 250_000)), rel=1e-6, abs=2.5e-4 * 1e-7)
