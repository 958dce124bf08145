"""Port vs JAX: the SimT loss block (simt_tpu_torch/ops/fused_losses.py) and its core
(simt_tpu_torch/ops/kernels/loss_fused.py).

On the CPU the port's core is its plain version; the CUDA kernels B2/B3 are held against
it on the card by chip_smoke.py. Inputs come from numpy seeds and go to both packages.
Tolerances: values 2e-4 relative (the JAX block upsamples with two matmuls, the port
with the kernel's two-tap form, and sums in other orders); gradients rtol 2e-3 /
atol 2e-5, as the JAX package's own fused-vs-unfused test.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.ops.fused_losses import simt_loss_block as jax_block
from simt_tpu_torch.ops.fused_losses import simt_loss_block, teacher_conf
from simt_tpu_torch.ops.kernels import loss_fused as lf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("loss_p1", "loss_p2", "loss_y1", "loss_y2", "place", "anchor")


CELL = 16  # pixels a side of a ``regions`` label cell


def _inputs(seed, c=5, o=3, b=1, h8=9, w8=13, hh=40, ww=72, labels="iid"):
    """The tests/test_fused_losses.py fixture, made with numpy. ``labels="regions"``
    gives a label map constant over 16x16-pixel cells (15% of the cells 255), the
    structure of a real pseudo-label."""
    total = c + o
    rng = np.random.RandomState(seed)
    x1 = (rng.randn(b, h8, w8, total) * 2).astype(np.float32)
    x2 = (rng.randn(b, h8, w8, total) * 2).astype(np.float32)
    tl = rng.randn(b, h8, w8, c).astype(np.float32) * 3
    tp8 = np.array(jax.nn.softmax(jnp.asarray(tl), -1))
    if labels == "regions":
        cells = rng.randint(0, c, (b, -(-hh // CELL), -(-ww // CELL))).astype(np.int32)
        cells[rng.rand(*cells.shape) < 0.15] = 255
        label = np.repeat(np.repeat(cells, CELL, 1), CELL, 2)[:, :hh, :ww].copy()
    else:
        label = rng.randint(0, c, (b, hh, ww)).astype(np.int32)
        label[rng.rand(b, hh, ww) < 0.15] = 255
    t1, t2 = (np.array(jax.nn.softmax(jnp.asarray(rng.randn(total, c).astype(np.float32)), -1))
              for _ in range(2))
    return x1, x2, tp8, label, t1, t2


KW = dict(threshold_high=0.7, threshold_low=0.3, lambda_place=0.1, lambda_seg=0.1)


def _port(args, c=5, o=3, chunk_rows=8, **kw):
    x1, x2, tp8, label, t1, t2 = (torch.from_numpy(a) for a in args)
    return simt_loss_block(x1, x2, tp8, label, t1, t2, num_classes=c, open_classes=o,
                           chunk_rows=chunk_rows, **dict(KW, **kw))


def _jax(args, c=5, o=3, chunk_rows=8, fn=jax_block, **kw):
    return fn(*(jnp.asarray(a) for a in args), num_classes=c, open_classes=o,
              chunk_rows=chunk_rows, **dict(KW, **kw))


def _total(d):
    return (d["loss_p2"] + d["loss_y2"] + 0.1 * d["loss_p1"] + 0.1 * d["loss_y1"]
            + d["place"] + d["anchor"])


@pytest.mark.parametrize("seed,labels", [(0, "iid"), (1, "iid"), (2, "regions")],
                         ids=["0", "1", "2-regions"])
def test_values_match_jax(seed, labels):
    args = _inputs(seed, labels=labels)
    got, want = _port(args), _jax(args)
    for k in KEYS:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-4, abs=2e-5), k


def test_gradients_match_jax():
    args = _inputs(1)
    x1, x2, tp8, label, t1, t2 = args
    want = jax.grad(lambda a, b, c, d: _total(_jax((a, b, tp8, label, c, d))),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in (x1, x2, t1, t2)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x1, x2, t1, t2)]
    out = simt_loss_block(leaves[0], leaves[1], torch.from_numpy(tp8),
                          torch.from_numpy(label), leaves[2], leaves[3], num_classes=5,
                          open_classes=3, chunk_rows=8, **KW)
    _total(out).backward()
    for name, leaf, w in zip(("dx1", "dx2", "dt1", "dt2"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("chunks", [(4, 40), (7, 8), (64, 3)])
def test_chunk_invariance(chunks):
    """Any chunk size, a non-divisor of H included, gives the same losses."""
    args = _inputs(2)
    a, b = (_port(args, chunk_rows=r) for r in chunks)
    for k in KEYS:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=2e-6, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def pallas_block():
    """experiments/pallas_alternates/loss_fused.py::loss_block_pallas, imported by file
    path; on the CPU it runs its kernels in Pallas interpret mode, as
    experiments/pallas_alternates/test_pallas_loss.py does."""
    path = os.path.join(REPO, "experiments", "pallas_alternates", "loss_fused.py")
    spec = importlib.util.spec_from_file_location("pallas_loss_fused", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.loss_block_pallas


@pytest.mark.parametrize("b,labels", [(1, "iid"), (2, "iid"), (2, "regions")],
                         ids=["1", "2", "2-regions"])
def test_values_and_gradients_match_pallas_interpret(pallas_block, b, labels):
    """Against the TPU kernels B2/B3 themselves, at test_pallas_loss.py's geometry."""
    c, o = 4, 2
    args = _inputs(10 + b, c=c, o=o, b=b, h8=9, w8=17, hh=64, ww=128, labels=labels)
    kw = dict(c=c, o=o, chunk_rows=16, threshold_high=0.6, threshold_low=0.3)
    x1, x2, tp8, label, t1, t2 = args

    def total(d):  # every loss participates (test_pallas_loss.py's composition)
        return (d["loss_p1"] + 2.0 * d["loss_p2"] + 0.5 * d["loss_y1"] + d["loss_y2"]
                + d["place"] + 3.0 * d["anchor"])

    def jax_total(a, bb, cc, dd):
        return total(_jax((a, bb, tp8, label, cc, dd), fn=pallas_block, **kw))

    want_vals = _jax(args, fn=pallas_block, **kw)
    want_grads = jax.grad(jax_total, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x1, x2, t1, t2)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x1, x2, t1, t2)]
    got = simt_loss_block(leaves[0], leaves[1], torch.from_numpy(tp8),
                          torch.from_numpy(label), leaves[2], leaves[3], num_classes=c,
                          open_classes=o, chunk_rows=16, threshold_high=0.6,
                          threshold_low=0.3, lambda_place=0.1, lambda_seg=0.1)
    for k in KEYS:
        assert float(got[k].detach()) == pytest.approx(float(want_vals[k]), rel=2e-4,
                                              abs=2e-5), k
    total(got).backward()
    for name, leaf, w in zip(("dx1", "dx2", "dt1", "dt2"), leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-5, err_msg=name)


def _core_inputs(seed, b=2, c=5, o=3):
    x1, x2, tp8, label, t1, t2 = _inputs(seed, c=c, o=o, b=b)
    xcat = torch.from_numpy(np.concatenate([x1, x2], axis=-1))
    label = torch.from_numpy(label)
    conf = teacher_conf(torch.from_numpy(tp8), label.shape[1:], num_classes=c,
                        threshold_high=0.7, threshold_low=0.3)
    return xcat, label, conf, torch.from_numpy(t1), torch.from_numpy(t2)


CORE_KW = dict(num_classes=5, threshold_high=0.7)


def test_backward_reference_equals_autograd_of_forward_reference():
    """The hand-derived backward (the formulas kernel B3 computes) against autograd of
    the plain forward, for a cotangent on every sum (counts included). rtol 1e-4 /
    atol 1e-6 relative to float32 sums over 5760 pixels."""
    xcat, label, conf, t1, t2 = _core_inputs(3)
    g = torch.from_numpy(np.random.RandomState(4).randn(2, 8).astype(np.float32))
    leaves = [v.clone().requires_grad_(True) for v in (xcat, t1, t2)]
    sums, *_ = lf.loss_core_fwd_reference(leaves[0], label, conf, leaves[1], leaves[2],
                                          chunk_rows=16, **CORE_KW)
    want = torch.autograd.grad((sums * g).sum(), leaves)
    got = lf.loss_core_bwd_reference(g, xcat, label, conf, t1, t2, chunk_rows=16,
                                     **CORE_KW)
    for name, a, b in zip(("dxcat", "dt1", "dt2"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_autograd_function_on_cpu_runs_the_plain_versions():
    """SimTLossCore on CPU tensors: the plain forward and the hand-derived backward,
    equal to autograd of the plain forward; no kernel launch is counted."""
    xcat, label, conf, t1, t2 = _core_inputs(5, b=1)
    lf.loss_core_fwd.launches = lf.loss_core_bwd.launches = 0
    g = torch.from_numpy(np.random.RandomState(6).randn(2, 8).astype(np.float32))
    a = [v.clone().requires_grad_(True) for v in (xcat, t1, t2)]
    out = lf.SimTLossCore.apply(a[0], a[1], a[2], label, conf, 5, 0.7, 255)
    assert not out[2].requires_grad and out[2].dtype == torch.int32
    (out[0] * g).sum().backward()
    b = [v.clone().requires_grad_(True) for v in (xcat, t1, t2)]
    ref = lf.loss_core_fwd_reference(b[0], label, conf, b[1], b[2], **CORE_KW)
    (ref[0] * g).sum().backward()
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-4, atol=1e-6)
    assert lf.loss_core_fwd.launches == lf.loss_core_bwd.launches == 0


def test_anchor_is_global_batch_major_first_occurrence():
    """A planted tie across images and rows: the earliest global pixel wins."""
    xcat, label, conf, t1, t2 = _core_inputs(7)
    hh, ww = label.shape[1:]
    big = 50.0
    xcat[0, -1, 0, 2] = big   # image 0, last source row -> output row H-1, column 0
    xcat[1, 0, 0, 2] = big    # image 1, first pixel
    xcat[0, -1, -1, 2] = big  # image 0, last pixel
    _, amax, aidx, presence = lf.loss_core_fwd_reference(xcat, label, conf, t1, t2,
                                                         chunk_rows=7, **CORE_KW)
    assert float(amax[0, 2]) == big
    assert int(aidx[0, 2]) == (hh - 1) * ww
    assert float(presence[0, 2]) == 1.0


def test_all_ignored_labels_and_all_unknown_conf_stay_finite():
    xcat, label, conf, t1, t2 = _core_inputs(8)
    label = torch.full_like(label, 255)
    conf = torch.full_like(conf, 5)  # every pixel unknown (class C)
    sums, *_ = lf.loss_core_fwd_reference(xcat, label, conf, t1, t2, **CORE_KW)
    assert float(sums[0, 7]) == float(sums[1, 7]) == 0.0
    assert torch.isfinite(sums).all()
    g = torch.ones(2, 8)
    for v in lf.loss_core_bwd_reference(g, xcat, label, conf, t1, t2, **CORE_KW):
        assert torch.isfinite(v).all()


@pytest.mark.parametrize("bad", ["total", "batch", "shape", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    xcat, label, conf, t1, t2 = _core_inputs(9, b=1)
    if bad == "shape":
        conf = conf[:, :8]
    elif bad == "total":
        t1 = t1[:4]
    elif bad == "device":
        xcat, label, conf, t1, t2 = (v.to("meta") for v in (xcat, label, conf, t1, t2))
    else:
        label = label[:1]
        xcat = torch.cat([xcat, xcat])
    with pytest.raises(ValueError):
        lf.loss_core_fwd(xcat, label, conf, t1, t2, **CORE_KW)


def test_work_counts_bytes_and_operations():
    w = lf.work(1, 65, 129, 512, 1024, 19, 15)
    x_bytes = 65 * 129 * 68 * 4
    in_bytes = x_bytes + 512 * 1024 * 5 + 2 * 34 * 19 * 4
    assert w["fwd"][0] == in_bytes + (16 + 6 * 34) * 4
    assert w["bwd"][0] == in_bytes + 64 + x_bytes + 2 * 34 * 19 * 4
    assert w["fwd"][1] == 512 * 1024 * 34 * 34 + 512 * 129 * 68 * 3
    # Special-function operations: per head and pixel 34 expf, a reciprocal and (the
    # forward) a logf; with every head-pixel labelled and placed, the suppressed
    # softmax's 34 expf and a logf or reciprocal, and the posterior's logf or reciprocal.
    head_pixels = 2 * 512 * 1024
    assert w["bwd"][2] == head_pixels * (35 + 35 + 1)
    assert w["fwd"][2] == head_pixels * (35 + 35 + 1 + 1)
    few = lf.work(1, 65, 129, 512, 1024, 19, 15, place=0, labelled=1000)
    assert few["bwd"][2] == head_pixels * 35 + 1000
    assert few["fwd"][2] == head_pixels * 36 + 1000
    # The bound: the largest of the three times, named.
    ms, by, term = lf.bound(*w["fwd"])
    assert (by, term) == ("operations", "sfu")
    assert ms == pytest.approx(w["fwd"][2] / (16 * 132 * 1.98e9) * 1e3)
    assert lf.bound(3.35e9, 1.0, 1.0)[1:] == ("bytes", "bytes")
    ms, by, term = lf.bound(1.0, 67e9, 1.0)
    assert ms == pytest.approx(1.0) and (by, term) == ("operations", "float32")
