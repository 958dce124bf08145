"""Port vs JAX: the fused train-mode bottleneck (simt_tpu_torch/ops/bottleneck.py,
ops/kernels/bottleneck.py; kernels B6/B7 run only on a card, so here the Function runs
their plain versions in the same forward/backward structure).

  - forward against the Pallas ``fused_bottleneck`` (interpret mode on the CPU) and
    ``reference_bottleneck`` of experiments/pallas_bottleneck/bottleneck.py, at d 1, 2,
    4 and an odd 9x13 image: the output within one bf16 ulp of its max (2**-7: both
    sides round exactly representable sums once, in other orders), each statistics
    vector within 1e-3 of its max;
  - the hand backward against the Pallas custom VJP (2e-2 of each gradient's max),
    ``jax.grad`` of the reference (the JAX test's own 5e-2) and autograd through the
    port's plain forward (5e-2);
  - a flax ``Bottleneck`` in train mode, bf16, batch 1, carried across by
    ``state_dict_from_flax`` and ``block_args``: the output within 2**-7 of its max
    (flax rounds bn3's output before the residual add, the fused block adds in float32
    and rounds once), the statistics equal to flax's ``batch_stats`` update within 1e-3;
  - ``needs_input_grad``, batch 2, the wrappers' checks, ``work()`` and the benchmark
    tool on the CPU.
"""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models.layers import Bottleneck as JBottleneck
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.models.layers import Bottleneck
from simt_tpu_torch.ops import bottleneck as op_lib
from simt_tpu_torch.ops.bottleneck import block_args, fused_bottleneck
from simt_tpu_torch.ops.kernels import bottleneck as kernels
from simt_tpu_torch.tools import bench_fused_bottleneck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7
NAMES = ("x", "w1", "w2", "w3", "g1", "b1", "g2", "b2", "g3", "b3")


@functools.lru_cache(maxsize=None)
def _pallas():
    """experiments/pallas_bottleneck/bottleneck.py, imported by path; on the CPU its
    pallas_calls run in interpret mode."""
    path = os.path.join(REPO, "experiments", "pallas_bottleneck", "bottleneck.py")
    spec = importlib.util.spec_from_file_location("pallas_bottleneck", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(h, w, p, ct, seed):
    """NHWC x and HWIO-style weights (the JAX test's scales), as numpy float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(h, w, ct).astype(np.float32)
    w1 = (rng.randn(ct, p) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, p, p) * 0.1).astype(np.float32)
    w3 = (rng.randn(p, ct) * 0.1).astype(np.float32)
    vecs = [(1.0 + 0.1 * rng.randn(n)).astype(np.float32) if i % 2 == 0
            else (0.1 * rng.randn(n)).astype(np.float32)
            for i, n in enumerate((p, p, p, p, ct, ct))]
    return [x, w1, w2, w3, *vecs]


def _jax_args(a):
    return [jnp.asarray(t) for t in a]


def _port_args(a):
    """The port's layouts: x (1, Ct, H, W) bf16, OIHW weights, float32 vectors."""
    x, w1, w2, w3, *vecs = a
    xt = torch.from_numpy(x).permute(2, 0, 1)[None].to(torch.bfloat16)
    ws = [torch.from_numpy(np.ascontiguousarray(w1.T))[:, :, None, None],
          torch.from_numpy(np.ascontiguousarray(w2.transpose(3, 2, 0, 1))),
          torch.from_numpy(np.ascontiguousarray(w3.T))[:, :, None, None]]
    return [xt, *ws, *(torch.from_numpy(v) for v in vecs)]


def _as_jax_layout(grads):
    """The port's gradients (x, w1, w2, w3 in its layouts, vectors) as JAX's numpy."""
    dx, dw1, dw2, dw3, *dv = (g.detach().float() for g in grads)
    return [dx[0].permute(1, 2, 0).numpy(), dw1[:, :, 0, 0].T.numpy(),
            dw2.permute(2, 3, 1, 0).numpy(), dw3[:, :, 0, 0].T.numpy(),
            *(v.numpy() for v in dv)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# (d, h, w): the JAX test's three dilations on its 10x16 image (12x20 at d 4, so that
# the padding is no wider than the image everywhere) and its odd 9x13 image.
FWD_CASES = [(1, 10, 16), (2, 10, 16), (4, 12, 20), (2, 9, 13)]


@pytest.mark.parametrize("against", ["pallas", "reference"])
@pytest.mark.parametrize("d,h,w", FWD_CASES)
def test_forward_matches_jax(d, h, w, against):
    a = _inputs(h, w, 8, 32, seed=d + h)
    fn = _pallas().fused_bottleneck if against == "pallas" else _pallas().reference_bottleneck
    want_out, want_stats = fn(*_jax_args(a), d)
    out, stats = fused_bottleneck(*_port_args(a), d)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 32, h, w)
    _close(out.float()[0].permute(1, 2, 0).numpy(), want_out, BF16_ULP, "out")
    for name, got, want in zip(("m1", "v1", "m2", "v2", "m3", "v3"), stats, want_stats):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, 1e-3, name)


def _loss(out):
    return jnp.sum(out.astype(jnp.float32) ** 2)


@functools.lru_cache(maxsize=None)
def _grads(d, against):
    """The ten gradients of sum(out^2) (JAX layouts, numpy) at the JAX test's backward
    geometry (8x12, P 8, Ct 16, seed 1)."""
    a = _inputs(8, 12, 8, 16, seed=1)
    if against == "port":
        targs = _port_args(a)
        for t in targs:
            t.requires_grad_(True)
        out, _ = fused_bottleneck(*targs, d)
        (out.float() ** 2).sum().backward()
        return _as_jax_layout([t.grad for t in targs])
    if against == "port_autograd":
        targs = _port_args(a)
        for t in targs:
            t.requires_grad_(True)
        out = kernels.bottleneck_fwd_plain(*targs, d)[0]
        (out.float() ** 2).sum().backward()
        return _as_jax_layout([t.grad for t in targs])
    fn = (_pallas().fused_bottleneck if against == "pallas_vjp"
          else _pallas().reference_bottleneck)
    g = jax.grad(lambda *t: _loss(fn(*t, d)[0]), argnums=tuple(range(10)))(*_jax_args(a))
    return [np.asarray(t, np.float32) for t in g]


@pytest.mark.parametrize("against,tol", [("pallas_vjp", 2e-2), ("reference_grad", 5e-2),
                                         ("port_autograd", 5e-2)])
@pytest.mark.parametrize("d", [1, 2])
def test_gradients_match(d, against, tol):
    got, want = _grads(d, "port"), _grads(d, against)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w, tol, f"grad {name}")


@pytest.mark.parametrize("d", [1, 2])
def test_matches_flax_block(d):
    planes, h, w = 8, 9, 11
    rng = np.random.RandomState(7 + d)
    x = (rng.randn(1, h, w, 4 * planes) * 2).astype(np.float32)
    jblock = JBottleneck(planes, dilation=d, dtype=jnp.bfloat16)
    variables = jax.tree.map(np.array, jblock.init(jax.random.PRNGKey(d), jnp.asarray(x),
                                                   False))  # writable numpy copies
    for bn in ("bn1", "bn2", "bn3"):  # a non-trivial affine
        p = variables["params"][bn]
        p["scale"] = (1 + 0.1 * rng.randn(*p["scale"].shape)).astype(np.float32)
        p["bias"] = (0.1 * rng.randn(*p["bias"].shape)).astype(np.float32)
    want, new = jblock.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])

    block = Bottleneck(4 * planes, planes, dilation=d)
    block.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        out, stats = fused_bottleneck(xt, *block_args(block))
    _close(out.float()[0].permute(1, 2, 0).numpy(), np.asarray(want, np.float32)[0],
           BF16_ULP, "out")
    old, upd = variables["batch_stats"], new["batch_stats"]
    for i, bn in enumerate(("bn1", "bn2", "bn3")):
        for j, stat in enumerate(("mean", "var")):
            batch = (np.asarray(upd[bn][stat]) - 0.9 * old[bn][stat]) / 0.1
            _close(stats[2 * i + j].numpy(), batch, 1e-3, f"{bn} {stat}")


@pytest.mark.parametrize("weights_train", [False, True], ids=["x_only", "x_and_weights"])
def test_needs_input_grad(monkeypatch, weights_train):
    seen = []
    bwd = op_lib.bottleneck_bwd

    def spy(*args, need):
        res = bwd(*args, need=need)
        seen.append((tuple(need), res[:4]))
        return res

    monkeypatch.setattr(op_lib, "bottleneck_bwd", spy)
    args = _port_args(_inputs(6, 7, 4, 16, seed=3))
    args[0].requires_grad_(True)
    for t in args[1:4]:
        t.requires_grad_(weights_train)
    out, stats = fused_bottleneck(*args, 2)  # BN affine frozen, as in the model
    assert all(not s.requires_grad for s in stats)
    (out.float() ** 2).sum().backward()
    (need, (dx, dw1, dw2, dw3)), = seen
    assert need == (True,) + (weights_train,) * 3
    assert args[0].grad is not None and args[0].grad.dtype == torch.bfloat16
    for t, dw in zip(args[1:4], (dw1, dw2, dw3)):
        assert (t.grad is not None) == weights_train == (dw is not None)
        if weights_train:
            assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
    assert all(v.grad is None for v in args[4:])


def test_batch_two_and_bad_inputs_raise():
    args = _port_args(_inputs(5, 6, 4, 16, seed=4))
    x2 = torch.cat([args[0], args[0]])
    with pytest.raises(ValueError, match="batch|1, Ct"):
        fused_bottleneck(x2, *args[1:], 1)
    with pytest.raises(ValueError, match="batch 1"):
        kernels.bottleneck_fwd(x2, *args[1:], 1)
    with pytest.raises(ValueError, match="w2"):
        kernels.bottleneck_fwd(args[0], args[1], args[2][:, :, :2], *args[3:], 1)
    with pytest.raises(ValueError, match="dilation"):
        kernels.bottleneck_fwd(*args, 0)
    meta = [t.to("meta") for t in args]  # neither CPU nor CUDA: no fallback
    with pytest.raises(ValueError, match="device"):
        kernels.bottleneck_fwd(*meta, 1)
    with pytest.raises(ValueError, match="identity"):
        block_args(Bottleneck(16, 4, downsample=True))


def test_work_counts_the_layer3_geometry():
    # 65x129, Ct 1024, P 256: forward 18.7 GFLOP and about 45 MB (bound by the tensor
    # cores at 989 TFLOP/s against 3.35 TB/s), backward 41.8 GFLOP.
    nbytes, ops = kernels.work(65, 129, 1024, 256, "fwd")
    assert ops == 2 * 65 * 129 * (2 * 1024 * 256 + 9 * 256 * 256)
    assert round(ops / 1e9, 1) == 18.7 and round(nbytes / 1e6) == 45
    assert ops / 989e12 > nbytes / 3.35e12
    assert round(kernels.work(65, 129, 1024, 256, "bwd")[1] / 1e9, 1) == 41.8
    with pytest.raises(ValueError):
        kernels.work(1, 1, 4, 1, "dx")


def test_bench_tool_on_the_cpu():
    res = bench_fused_bottleneck.main(["--device", "cpu", "--geometry", "9,13,8,32,2",
                                       "--reps", "1"])
    for key in ("fused_fwd_ms", "fused_fwdbwd_ms", "module_fwd_ms", "module_fwdbwd_ms",
                "agree_rel"):
        assert math.isfinite(res[key]) and res[key] >= 0, key
    assert res["finite"] and res["agree_rel"] <= 2.0 ** -6


def test_bench_tool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_fused_bottleneck.main(["--geometry", "9,13,8,32,2", "--reps", "1"])
