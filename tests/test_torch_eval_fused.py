"""Port vs JAX: the fused multi-scale eval head (simt_tpu_torch/ops/kernels/eval_fused.py).

On the CPU the port's wrapper runs its plain version; the JAX side runs the Pallas
kernel in interpret mode. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py. Here a numpy emulation of the kernel's loop, reading the
packed tap tables the wrapper hands the kernel, checks the tables and the kernel's
order of operations against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.kernels import eval_fused as tef

C = 19
OUT_HW = (64, 128)


@pytest.fixture
def jax_kernel(monkeypatch):
    import simt_tpu.ops.pallas.eval_fused as ef
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(ef.pl, "pallas_call", interp_call)

    def run(la, lb, gt):  # batched numpy in, summed (C, C) numpy out
        return sum(
            np.asarray(ef.multiscale_argmax_hist(
                jnp.asarray(la[i]), jnp.asarray(lb[i]), jnp.asarray(gt[i]),
                out_hw=OUT_HW, num_classes=C, chunk_rows=16))
            for i in range(la.shape[0])
        )

    return run


def _inputs(seed, batch=1, hw_b=(11, 21), zero_b=False):
    rng = np.random.RandomState(seed)
    la = (rng.randn(batch, 9, 17, C) * 3).astype(np.float32)
    lb = (rng.randn(batch, *hw_b, C) * 3).astype(np.float32)
    if zero_b:
        lb[:] = 0.0
    gt = rng.randint(-2, 40, (batch, *OUT_HW)).astype(np.int32)
    gt[rng.rand(batch, *OUT_HW) < 0.2] = 255
    return la, lb, gt


def _emulate_kernel(la, lb, gt):
    """The CUDA kernel's arithmetic in numpy float32, from the wrapper's tap tables."""
    hh, ww = OUT_HW
    taps_i, taps_f = (t.numpy() for t in tef.device_taps(
        la.shape[1], la.shape[2], lb.shape[1], lb.shape[2], OUT_HW, torch.device("cpu")))
    hist = np.zeros((C, C), np.int64)
    for n in range(la.shape[0]):
        outs = []
        for s, x in enumerate((la[n], lb[n])):
            lo, hi = taps_i[2 * s], taps_i[2 * s + 1]
            w0, w1 = taps_f[2 * s], taps_f[2 * s + 1]
            # H step per output row, then W step per output column.
            z = w0[:hh, None, None] * x[lo[:hh]] + w1[:hh, None, None] * x[hi[:hh]]
            outs.append(w0[None, hh:, None] * z[:, lo[hh:]]
                        + w1[None, hh:, None] * z[:, hi[hh:]])
        pred = np.argmax(outs[0] + outs[1], axis=-1)
        g = gt[n]
        k = (g >= 0) & (g < C)
        hist += np.bincount(C * g[k] + pred[k], minlength=C * C).reshape(C, C)
    return hist


CASES = {
    "seed0": dict(seed=0),
    "seed1": dict(seed=1),
    "warmup_zero_operand": dict(seed=2, hw_b=(1, 1), zero_b=True),
    "batch2": dict(seed=3, batch=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_pallas(case, jax_kernel):
    la, lb, gt = _inputs(**CASES[case])
    tef.multiscale_argmax_hist.launches = 0
    got = tef.multiscale_argmax_hist(torch.from_numpy(la), torch.from_numpy(lb),
                                     torch.from_numpy(gt), out_hw=OUT_HW, num_classes=C)
    want = jax_kernel(la, lb, gt)
    assert got.dtype == torch.int32 and got.shape == (C, C)
    got = got.numpy().astype(np.int64)
    # Same count of valid pixels; f32 sum-order differences may flip a near-tie argmax.
    assert got.sum() == want.sum() == ((gt >= 0) & (gt < C)).sum()
    assert np.abs(got - want).sum() <= 2, np.abs(got - want).sum()
    assert tef.multiscale_argmax_hist.launches == 0  # CPU tensors: plain version only


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_matches_jax(case, jax_kernel):
    la, lb, gt = _inputs(**CASES[case])
    got = _emulate_kernel(la, lb, gt)
    want = jax_kernel(la, lb, gt)
    assert got.sum() == want.sum()
    assert np.abs(got - want).sum() <= 2, np.abs(got - want).sum()


def test_single_image_without_batch_dim():
    la, lb, gt = _inputs(4)
    batched = tef.multiscale_argmax_hist(torch.from_numpy(la), torch.from_numpy(lb),
                                         torch.from_numpy(gt), out_hw=OUT_HW)
    single = tef.multiscale_argmax_hist(torch.from_numpy(la[0]), torch.from_numpy(lb[0]),
                                        torch.from_numpy(gt[0]), out_hw=OUT_HW)
    assert torch.equal(batched, single)


@pytest.mark.parametrize("bad", ["channels", "gt_shape", "batch", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    la, lb, gt = (torch.from_numpy(a) for a in _inputs(5))
    if bad == "channels":
        la = la[..., :5]
    elif bad == "gt_shape":
        gt = gt[:, :32]
    elif bad == "batch":
        gt = torch.cat([gt, gt])
    else:
        la, lb, gt = la.to("meta"), lb.to("meta"), gt.to("meta")
    with pytest.raises(ValueError):
        tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW)


def test_work_counts_bytes_and_operations():
    nbytes, ops = tef.work(65, 129, 81, 161, (1024, 2048), 19, batch=1,
                           n_counted=1024 * 2048)
    assert nbytes == 1024 * 2048 * 4 + (65 * 129 + 81 * 161) * 19 * 4 \
        + 32 * (1024 + 2048) + 19 * 19 * 4
    assert ops == 1024 * (129 + 161) * 19 * 3 + 1024 * 2048 * 8 * 19
