"""Port on gloo ranks vs one device: data parallelism (simt_tpu_torch/parallel/mesh.py,
models/layers.py::BatchNorm2d's global statistics, ops/fused_losses.py's global finish,
the steps' gradient reduction in train/simt.py and train/warmup.py).

Two spawned ranks (``RankPool``: a process each, gloo over localhost, one thread), each
holding one block of a global batch, against the whole batch on one device:

  - BatchNorm in train mode inside ``global_batch_stats`` against flax's ``BatchNorm``
    on the concatenated batch: outputs at rtol 1e-5 / atol 1e-5 and the running
    statistics at rtol 1e-5 / atol 1e-6 (the single-BatchNorm tolerances of
    tests/test_torch_model_train.py), the running variance the biased one; the input
    and affine gradients (each rank's affine gradient summed over the ranks, as the
    steps do) at rtol 1e-4 / atol 1e-5;
  - ``simt_loss_block`` with the data group against the single-process block on the
    concatenated batch (logits at the labels' size, so the planted values are the
    upsampled ones): the ranks' data losses and gradients summing to the single ones
    (rtol 1e-5), the anchor equal on every rank to the single one, on a cross-rank
    anchor tie (rank 0 must win: its pixel comes first in the batch-major order though
    rank 1's local index is lower), a rank whose labels are all ignored and a channel
    present on one rank only;
  - two SimT steps on the stub-logit setup of tests/test_torch_simt_step.py against the
    JAX step on the doubled batch, with a cross-rank anchor tie, at that test's
    tolerances (losses rel 2e-4 / abs 2e-4, post-step T1/T2/W1/W2 atol 2e-5),
    iter_size 1 and 2, ``clear_inner_t_grads`` both ways, the ranks' metrics and
    parameters equal bit for bit;
  - the warmup step, DeepLabv2 (layers (1,1,1,1), 32x64) and DeepLabv3 (64x128), two
    steps against the JAX step on the doubled batch at tests/test_torch_warmup_step.py's
    and test_torch_aux_models.py's tolerances, the ranks' states equal bit for bit.

JAX is imported inside the tests: the ranks re-import this module and need only torch.
"""

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch
from torch import nn

from simt_tpu_torch.config import ModelConfig, OptimConfig, SimTConfig, TrainConfig
from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import ResNetMulti
from simt_tpu_torch.models.deeplabv3 import DeepLabv3
from simt_tpu_torch.models.layers import BatchNorm2d
from simt_tpu_torch.ops.fused_losses import simt_loss_block
from simt_tpu_torch.parallel import global_batch_stats, make_mesh, shard_batch
from simt_tpu_torch.train import (create_simt_state, create_warmup_state, make_simt_step,
                                  make_warmup_step)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inbox, outbox):
    """A rank: joins the gloo group, then runs ``fn(rank, *args)`` for each job."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for fn, args in iter(inbox.get, None):
            try:
                outbox.put((rank, True, fn(rank, *args)))
            except BaseException:  # noqa: BLE001 -- reported to the parent
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` spawned processes in one gloo group, kept for a module's tests.
    ``run(fn, *args)`` runs ``fn(rank, *args)`` on every rank and returns the results
    in rank order (``submit`` then ``results``, so the caller can work meanwhile); a
    rank's exception or a timeout fails the call, and the next call starts new ranks
    (a peer may be left waiting in a collective)."""

    def __init__(self, world: int = WORLD, timeout: float = 240.0):
        self.world, self.timeout = world, timeout
        self._start()

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outbox = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, self.world, port, self.inboxes[r], self.outbox))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()
        self.broken = self.pending = False

    def run(self, fn, *args):
        self.submit(fn, *args)
        return self.results()

    def submit(self, fn, *args):
        """Start ``fn(rank, *args)`` on every rank; ``results()`` waits for it. A job
        left uncollected (its test failed first) retires the pool too."""
        if self.broken or self.pending:
            self.broken = True
            self.close()
            self._start()
        for q in self.inboxes:
            q.put((fn, args))
        self.pending = True

    def results(self):
        self.pending = False
        got = {}
        try:
            for _ in range(self.world):
                rank, ok, value = self.outbox.get(timeout=self.timeout)
                if not ok:
                    raise AssertionError(f"rank {rank}:\n{value}")
                got[rank] = value
        except (AssertionError, queue.Empty):
            self.broken = True
            raise
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=0 if self.broken else 10)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool()
    yield pool
    pool.close()


# ---------------------------------------------------------------------------
# BatchNorm: global batch statistics
# ---------------------------------------------------------------------------

def _bn_rank(rank, x, cot, mean0, var0, scale, bias):
    import torch.distributed as dist

    c = x.shape[-1]
    bn = BatchNorm2d(c, eps=1e-5, momentum=0.1).train()  # affine trainable, as in v3
    with torch.no_grad():
        for t, v in ((bn.running_mean, mean0), (bn.running_var, var0),
                     (bn.weight, scale), (bn.bias, bias)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x[rank]).permute(0, 3, 1, 2).requires_grad_()
    with global_batch_stats(dist.group.WORLD):
        y = bn(xt)
    (y * torch.from_numpy(cot[rank]).permute(0, 3, 1, 2)).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": xt.grad.permute(0, 2, 3, 1).numpy(), "dscale": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


@pytest.mark.parametrize("shape", [(2, 8, 9, 4), (1, 3, 5, 7)])
def test_batchnorm_global_statistics_equal_flax_on_the_whole_batch(ranks, shape):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    x = (rng.randn(WORLD, *shape) * 2 + rng.randn(WORLD, 1, 1, 1, c)).astype(np.float32)
    cot = rng.randn(WORLD, *shape).astype(np.float32)
    mean0, scale, bias = (rng.randn(c).astype(np.float32) for _ in range(3))
    var0 = (rng.rand(c) + 0.5).astype(np.float32)
    ranks.submit(_bn_rank, x, cot, mean0, var0, scale, bias)

    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    whole = jnp.asarray(x.reshape(-1, *shape[1:]))

    def f(xx, s, b):
        return bn.apply({"params": {"scale": s, "bias": b},
                         "batch_stats": {"mean": jnp.asarray(mean0),
                                         "var": jnp.asarray(var0)}},
                        xx, mutable=["batch_stats"])

    want_y, new = f(whole, jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda xx, s, b: f(xx, s, b)[0], whole, jnp.asarray(scale),
                     jnp.asarray(bias))
    dx, dscale, dbias = vjp(jnp.asarray(cot.reshape(-1, *shape[1:])))
    got = ranks.results()
    b = shape[0]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], np.asarray(want_y)[r * b:(r + 1) * b],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["dx"], np.asarray(dx)[r * b:(r + 1) * b],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["mean"], np.asarray(new["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["var"], np.asarray(new["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(g["dscale"] for g in got), np.asarray(dscale),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(g["dbias"] for g in got), np.asarray(dbias),
                               rtol=1e-4, atol=1e-5)
    # The biased variance of the global batch, not torch's unbiased one.
    n = x.size // c
    biased = x.reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(got[0]["var"], 0.9 * var0 + 0.1 * biased, rtol=1e-5)
    assert not np.allclose(got[0]["var"], 0.9 * var0 + 0.1 * biased * n / (n - 1),
                           rtol=1e-6, atol=0)


def test_batchnorm_without_a_group_is_unchanged():
    x = torch.randn(2, 3, 4, 5)
    a, b = BatchNorm2d(3).train(), BatchNorm2d(3).train()
    with global_batch_stats(None):
        ya = a(x)
    assert torch.equal(ya, b(x)) and torch.equal(a.running_var, b.running_var)


# ---------------------------------------------------------------------------
# The loss block's global finish
# ---------------------------------------------------------------------------

C, O = 5, 3
TOTAL = C + O
BLOCK_HW = (8, 12)  # logits at the labels' size: the upsample is the identity
KW = dict(num_classes=C, open_classes=O, threshold_high=0.8, threshold_low=0.2,
          lambda_place=0.1, lambda_seg=0.1)
DATA_KEYS = ("loss_p1", "loss_p2", "loss_y1", "loss_y2", "place")


def _block_inputs(case):
    """Two images (one a rank) of stride-8 logits at the labels' size."""
    rng = np.random.RandomState({"tie": 1, "ignored": 2, "presence": 3}[case])
    h, w = BLOCK_HW
    x1 = rng.randn(WORLD, h, w, TOTAL).astype(np.float32) * 2
    x2 = rng.randn(WORLD, h, w, TOTAL).astype(np.float32) * 2
    teacher = rng.randn(WORLD, h, w, C).astype(np.float32) * 4
    label = np.where(rng.rand(WORLD, h, w) < 0.15, 255,
                     rng.randint(0, C, (WORLD, h, w))).astype(np.int64)
    if case == "tie":
        # Channel 6's maximum in both images: image 0 at (5, 7), image 1 at (2, 3).
        for x in (x1, x2):
            x[0, 5, 7, 6] = x[1, 2, 3, 6] = 9.0
    elif case == "ignored":
        label[1] = 255
        teacher[1] = 0.0
        teacher[1, ..., :2] = 3.0  # two classes at ~0.45: no confident teacher label
    else:  # channel 7 is the argmax at one pixel of image 0 and nowhere in image 1
        for x in (x1, x2):
            x[..., 7] = -9.0
            x[0, 3, 4, 7] = 9.0
    prob = np.exp(teacher) / np.exp(teacher).sum(-1, keepdims=True)
    t = [rng.randn(TOTAL, C).astype(np.float32) for _ in range(2)]
    t = [np.exp(a) / np.exp(a).sum(-1, keepdims=True) for a in t]
    return x1, x2, prob.astype(np.float32), label, t[0], t[1]


def _block(x1, x2, prob, label, t1, t2, group):
    xs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in (x1, x2, t1, t2)]
    losses = simt_loss_block(xs[0], xs[1], torch.from_numpy(prob),
                             torch.from_numpy(label), xs[2], xs[3], group=group, **KW)
    data = sum(losses[k] for k in DATA_KEYS)
    grads = torch.autograd.grad(data, xs)
    return ({k: float(v.detach()) for k, v in losses.items()}, [g.numpy() for g in grads])


def _block_rank(rank, x1, x2, prob, label, t1, t2):
    import torch.distributed as dist

    sl = slice(rank, rank + 1)
    return _block(x1[sl], x2[sl], prob[sl], label[sl], t1, t2, dist.group.WORLD)


@pytest.mark.parametrize("case", ["tie", "ignored", "presence"])
def test_loss_block_global_finish_equals_the_whole_batch(ranks, case):
    inputs = _block_inputs(case)
    ranks.submit(_block_rank, *inputs)
    want, want_g = _block(*inputs, group=None)
    got = ranks.results()
    for k in DATA_KEYS:
        assert sum(g[0][k] for g in got) == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    for losses, _ in got:
        assert np.isfinite(list(losses.values())).all()
        assert losses["anchor"] == pytest.approx(want["anchor"], rel=1e-6), case
    for i in (0, 1):  # the logits' gradients: each rank its own image's
        for r, (_, g) in enumerate(got):
            np.testing.assert_allclose(g[i], want_g[i][r:r + 1], rtol=1e-5, atol=1e-7)
    for i in (2, 3):  # T's: the data part summed over the ranks
        np.testing.assert_allclose(got[0][1][i] + got[1][1][i], want_g[i], rtol=1e-5,
                                   atol=1e-7)
    if case == "tie":
        # The images swapped: now rank 1's pixel comes first, and only the tied
        # channel's winner changes. Its teacher row differs, and so does the anchor.
        swapped = [a[::-1].copy() for a in inputs[:4]] + list(inputs[4:])
        other = _block(*swapped, group=None)[0]["anchor"]
        assert other != pytest.approx(want["anchor"], rel=1e-3)
    if case == "ignored":
        assert got[1][0]["loss_y1"] == got[1][0]["loss_y2"] == 0.0
        assert want["loss_y1"] > 0


# ---------------------------------------------------------------------------
# The SimT step (stub logits) against the JAX step on the doubled batch
# ---------------------------------------------------------------------------

class _StubStudent(nn.Module):
    """Forward slices precomputed logits out of the (NCHW) image: channels [0, T) are
    head 1, [T, 2T) head 2 (tests/test_reference_oracle.py's stub)."""

    def __init__(self, total=TOTAL):
        super().__init__()
        self.total = total
        self.layer3 = nn.Conv2d(1, 1, 1)  # a parameter for the optimizer; unused

    def forward(self, x):
        return x[:, :self.total], x[:, self.total:2 * self.total]


class _StubTeacher(nn.Module):
    def forward(self, x):
        return None, x[:, 2 * TOTAL:2 * TOTAL + C]


def _simt_rank(rank, tcfg, got, batch, iter_size):
    mesh = make_mesh(WORLD, 1, device="cpu")
    st = create_simt_state(_StubStudent(), _StubTeacher(), tcfg,
                           torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for k in ("t1", "t2", "w1", "w2"):
            getattr(st, k).param.copy_(got[k])
    st.step = got["step"]
    # A rank's block of each sub-batch (the stacked batch's axis 1).
    local = (shard_batch(batch, mesh) if iter_size == 1 else
             {k: v[:, rank:rank + 1] for k, v in batch.items()})
    step = make_simt_step(tcfg, mesh)
    metrics = [{k: float(v) for k, v in step(st, local).items()} for _ in range(SIMT_STEPS)]
    return metrics, {k: getattr(st, k).param.detach().numpy()
                     for k in ("t1", "t2", "w1", "w2")}


SIMT_STEPS = 2  # Adam's first update is sign(g): the second weighs the gradients' sizes


@pytest.mark.parametrize("iter_size,clear", [(1, False), (2, False), (1, True), (2, True)])
def test_simt_step_on_two_ranks_matches_the_jax_step(ranks, tmp_path, iter_size, clear):
    import importlib.util

    import jax
    import jax.numpy as jnp

    from simt_tpu.config import ModelConfig as JModelConfig
    from simt_tpu.config import OptimConfig as JOptimConfig
    from simt_tpu.config import SimTConfig as JSimTConfig
    from simt_tpu.config import TrainConfig as JTrainConfig
    from simt_tpu.train import create_simt_state as j_create, make_simt_step as j_make
    from simt_tpu_torch.models.from_jax import simt_state_from_jax

    spec = importlib.util.spec_from_file_location(
        "_ref_oracle", os.path.join(HERE, "test_reference_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    assert (oracle.C, oracle.O) == (C, O)
    rng = np.random.RandomState(17 + iter_size + 10 * clear)
    shp8 = (WORLD, oracle.H8, oracle.W8)
    images = np.stack([np.concatenate(
        [rng.randn(*shp8, TOTAL) * 2, rng.randn(*shp8, TOTAL) * 2,
         rng.randn(*shp8, C) * 4], axis=-1).astype(np.float32) for _ in range(iter_size)])
    labels = np.stack([np.where(rng.rand(WORLD, oracle.HH, oracle.WW) < 0.15, 255,
                                rng.randint(0, C, (WORLD, oracle.HH, oracle.WW)))
                       .astype(np.int32) for _ in range(iter_size)])
    # A tie across the ranks on channel 2 of head 1, in every sub-batch: the same
    # logit plane in both images, so both upsampled maxima are equal.
    images[:, 1, ..., 2] = images[:, 0, ..., 2]
    batch = {"image": images, "label": labels}
    if iter_size == 1:
        batch = {k: v[0] for k, v in batch.items()}
    class_dist = rng.rand(C).astype(np.float32) + 0.5
    cd = str(tmp_path / "cd.npy")
    np.save(cd, class_dist / class_dist.sum())
    simt = dict(class_dist=cd, inner_w_steps=oracle.INNER, clear_inner_t_grads=clear)
    optim = dict(learning_rate_t=oracle.LR_T, num_steps=10**9, iter_size=iter_size)
    jcfg = JTrainConfig(model=JModelConfig(num_classes=C, open_classes=O, openset=True,
                                           compute_dtype="float32"),
                        optim=JOptimConfig(**optim),
                        simt=dataclasses.replace(JSimTConfig(), **simt))
    tcfg = TrainConfig(model=ModelConfig(num_classes=C, open_classes=O,
                                         compute_dtype="float32"),
                       optim=OptimConfig(**optim),
                       simt=dataclasses.replace(SimTConfig(), **simt))
    stub_params = {"layer3_0": {"conv1": {"kernel": jnp.zeros((1, 1, 1, 1))}}}
    js = j_create({"params": stub_params}, {"params": {}}, jcfg, jax.random.PRNGKey(0))
    js = js.replace(t1=js.t1.replace(param=jnp.asarray(rng.randn(TOTAL, C) * 0.5,
                                                       jnp.float32)),
                    t2=js.t2.replace(param=jnp.asarray(rng.randn(TOTAL, C) * 0.5,
                                                       jnp.float32)))
    got = simt_state_from_jax(jax.tree.map(np.asarray, js))
    got = {k: got[k] for k in ("t1", "t2", "w1", "w2", "step")}
    ranks.submit(_simt_rank, tcfg, got, batch, iter_size)
    jstep = j_make(oracle._StubStudent(), oracle._StubTeacher(), jcfg)
    j_metrics = []
    for _ in range(SIMT_STEPS):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        j_metrics.append({k: float(v) for k, v in m.items()})

    (m0, p0), (m1, p1) = ranks.results()
    assert m0 == m1
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k
    for i, (want, have) in enumerate(zip(j_metrics, m0)):
        for k in ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor",
                  "place"):
            assert have[k] == pytest.approx(want[k], rel=2e-4, abs=2e-4), (i, k)
    for k in ("t1", "t2", "w1", "w2"):
        np.testing.assert_allclose(p0[k], np.asarray(getattr(js, k).param), atol=2e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The warmup step against the JAX step on the doubled batch
# ---------------------------------------------------------------------------

WARMUP_STEPS = 2
V3_REL = 1e-1  # tests/test_torch_aux_models.py: DeepLabv3 held by the change's norm


def _warmup_rank(rank, arch, tcfg, sd, step0, batches):
    mesh = make_mesh(WORLD, 1, device="cpu")
    model = (ResNetMulti(C, 0, False, layers=(1, 1, 1, 1), dtype=torch.float32)
             if arch == "deeplab_multi" else DeepLabv3(C, dtype=torch.float32))
    model.load_state_dict(sd, strict=True)
    st = create_warmup_state(model, tcfg, "cpu")
    st.step = step0
    step = make_warmup_step(tcfg, mesh)
    metrics = [{k: float(v) for k, v in step(st, shard_batch(b, mesh)).items()}
               for b in batches]
    return metrics, {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("arch", ["deeplab_multi", "deeplabv3"])
def test_warmup_step_on_two_ranks_matches_the_jax_step(ranks, arch):
    import jax
    import jax.numpy as jnp

    from simt_tpu.config import ModelConfig as JModelConfig
    from simt_tpu.config import OptimConfig as JOptimConfig
    from simt_tpu.config import TrainConfig as JTrainConfig
    from simt_tpu.models.deeplabv3 import DeepLabv3 as JDeepLabv3
    from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
    from simt_tpu.train import create_warmup_state as j_create, make_warmup_step as j_make
    from simt_tpu_torch.models.from_jax import state_dict_from_flax, warmup_state_from_jax

    v3 = arch == "deeplabv3"
    hw = (64, 128) if v3 else (32, 64)
    jcfg = JTrainConfig(stage="warmup", model=JModelConfig(
        arch=arch, num_classes=C, openset=False, compute_dtype="float32"),
        optim=JOptimConfig())
    tcfg = TrainConfig(stage="warmup", model=ModelConfig(
        arch=arch, num_classes=C, compute_dtype="float32"), optim=OptimConfig())
    jm = (JDeepLabv3(num_classes=C, dtype=jnp.float32) if v3 else
          JResNetMulti(num_classes=C, layers=(1, 1, 1, 1), dtype=jnp.float32))
    jvars = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *hw, 3)), False))(
        jax.random.PRNGKey(0))
    js = j_create(jm, jvars, jcfg)
    got = warmup_state_from_jax(jax.tree.map(np.asarray, js))
    batches = [synthetic_batch(WORLD, hw, C, seed=10 * i) for i in range(WARMUP_STEPS)]
    ranks.submit(_warmup_rank, arch, tcfg, got["model"], got["step"], batches)

    jstep = j_make(jm, jcfg)
    jmet = []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        jmet.append({k: float(v) for k, v in m.items()})
    (met0, sd0), (met1, sd1) = ranks.results()
    assert met0 == met1
    for k in sd0:
        assert np.array_equal(sd0[k], sd1[k]), k
    for i, (want, have) in enumerate(zip(jmet, met0)):
        for k in ("loss_seg1", "loss_seg2"):
            if v3:
                assert have[k] == pytest.approx(want[k], rel=1e-3), (i, k)
            else:
                assert have[k] == pytest.approx(want[k], rel=2e-4, abs=2e-5), (i, k)
    want_sd = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": js.model.params, "batch_stats": js.model.batch_stats}))
    start = got["model"]
    model = DeepLabv3(C) if v3 else ResNetMulti(C, 0, False, layers=(1, 1, 1, 1))
    create_warmup_state(model, tcfg, "cpu")
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trained
    for k in trained:
        want_d = want_sd[k].numpy() - start[k].numpy()
        got_d = sd0[k] - start[k].numpy()
        assert np.abs(want_d).max() > 0, k
        if v3:
            rel = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
            assert rel <= V3_REL, (k, rel)
        else:
            np.testing.assert_allclose(got_d, want_d, rtol=0,
                                       atol=5e-2 * np.abs(want_d).max(), err_msg=k)
    for k in (k for k in want_sd if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(sd0[k], want_sd[k].numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=k)
