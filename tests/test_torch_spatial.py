"""Port on gloo ranks over the spatial axis: H-sharded training (simt_tpu_torch/
parallel/mesh.py's ``fetch_rows``/``gather_rows``/``spatial_rows``, ops/conv.py's
``*_rows``, models/layers.py's rows forwards, the band of ops/kernels/loss_fused.py
and ops/fused_losses.py, the steps of train/simt.py and train/warmup.py).

Spawned ranks (``RankPool`` of tests/test_torch_parallel.py: 2 and 4 processes, gloo
over localhost, one thread each), every image split by height into blocks of
ceil(H / S) rows (the last ones shorter or empty), float32:

  - the exchange for S = 2, 3, 4 at heights that leave empty blocks, with windows inside
    a block, reaching the neighbours, reaching past them (a halo of 24 on 5 rows) and
    past both edges: forward and gradient equal to the slice of the whole tensor
    exactly (integer-valued cotangents, so sums in any order are exact);
  - each sharded op (the stem, the ceil-mode pool, the strided 1x1, ``dilated_conv3x3``
    at d = 1/2/4, the ASPP heads with their largest halo, and Res_Deeplab's 4-branch
    head) against the op on the whole tensor on meshes (1,2) and (1,4) at the heights
    the trunk gives inputs of 32 and 44 rows: output and input gradient at rtol 1e-5 /
    atol 1e-5;
  - the layers (1,1,1,1) ``ResNetMulti`` forward in train mode on (1,2), (1,4) and
    (2,2): the gathered logits and the running statistics against the port's own
    unsharded forward at rtol 1e-5 / atol 1e-5 (statistics atol 1e-6, the
    single-BatchNorm tolerances of tests/test_torch_parallel.py) and against the JAX
    model at the whole network's 2e-3 (tests/test_torch_model_train.py);
  - the SimT step (C, O = 5, 3 at 32x64, iter_size 1 and 2) and the warmup step
    (DeepLabv2 and Res_Deeplab) on (1,2), (1,4) and (2,2), two steps against the JAX
    step on the whole global batch: losses at rel 2e-4 / abs 2e-4, T1/T2/W1/W2 at atol
    2e-5, the warmup's parameter changes within 3e-2 of each tensor's change by norm
    (``WARMUP_CHANGE``) and its batch statistics at 2e-3, every rank's parameters equal
    bit for bit;
  - the band loss on one process: the plain core over bands [0, R) and [R, H) against
    the whole image (counts, anchors, presence exactly; sums and dxcat at rtol 1e-6),
    ``upsample_ce`` and the teacher labels over bands (an empty one included), the
    schedule of a band covering its rows once; and the loss block over bands on ranks
    with an anchor tie across them (the earlier row wins), with a rank whose band is
    empty, and across data indices.

JAX is imported inside the tests and their fixtures: the ranks re-import this module
and need only torch.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import DeeplabSingle, ResNetMulti
from simt_tpu_torch.models.layers import ClassifierModule, aspp_rows
from simt_tpu_torch.ops import conv as conv_ops
from simt_tpu_torch.ops.fused_losses import simt_loss_block, teacher_conf, upsample_ce
from simt_tpu_torch.ops.kernels import loss_fused as lf
from simt_tpu_torch.parallel import (fetch_rows, global_batch_stats, make_mesh, row_block,
                                     shard_batch, spatial_rows)
from simt_tpu_torch.parallel.mesh import RowSharding
from simt_tpu_torch.train import (create_simt_state, create_warmup_state, make_simt_step,
                                  make_warmup_step)

from test_torch_parallel import RankPool

C, O = 5, 3
HW = (32, 64)
LAYERS = (1, 1, 1, 1)
STEPS = 2  # Adam's first update is sign(g): the second weighs the gradients' sizes
MESHES = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


def _rows(spatial: int, height: int) -> RowSharding:
    """This rank's rows of the first ``spatial`` ranks' group (a new group of them when
    the world is larger; every rank creates it)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD if spatial == world else dist.new_group(list(range(spatial)))
    return RowSharding(group, rank, spatial, height) if rank < spatial else None


# ---------------------------------------------------------------------------
# 1. The exchange
# ---------------------------------------------------------------------------

def _window_cases(height: int, size: int):
    """Every rank's window for each kind of reach (the output blocks those of the
    same height, so empty blocks read nothing)."""
    blocks = [row_block(height, r, size) for r in range(size)]

    def each(lo_pad, hi_pad):
        return [(lo - lo_pad, hi + hi_pad) if hi > lo else (0, 0) for lo, hi in blocks]

    inside = [(lo, max(lo, hi - 1)) if hi > lo else (0, 0) for lo, hi in blocks]
    return {"inside": inside, "neighbours": each(1, 2), "beyond": each(24, 24),
            "edges": [(-3, height + 3) for _ in blocks]}


def _exchange_rank(rank, size, height, cases, x, cots):
    rows = _rows(size, height)
    if rows is None:
        return None
    lo, hi = rows.block(height)
    out = {}
    for name, windows in cases.items():
        xl = torch.from_numpy(x[:, :, lo:hi].copy()).requires_grad_()
        y = fetch_rows(xl, rows, height, windows, fill=-5.0)
        (y * torch.from_numpy(cots[name][rank])).sum().backward()
        out[name] = (y.detach().numpy(), xl.grad.numpy())
    return out


@pytest.mark.parametrize("size,height", [(2, 5), (3, 5), (4, 5), (4, 9), (3, 2)])
def test_exchange_equals_the_slice_of_the_whole_tensor(pools, size, height):
    rng = np.random.RandomState(size * 10 + height)
    x = rng.randn(2, 3, height, 4)
    cases = _window_cases(height, size)
    cots = {name: [rng.randint(-4, 5, (2, 3, hi - lo, 4)).astype(np.float64)
                   for lo, hi in windows] for name, windows in cases.items()}
    got = pools(4).run(_exchange_rank, size, height, cases, x, cots)
    pad = 40
    xp = np.full((2, 3, height + 2 * pad, 4), -5.0)
    xp[:, :, pad:pad + height] = x
    for name, windows in cases.items():
        grad = np.zeros_like(xp)
        for r, (lo, hi) in enumerate(windows):
            grad[:, :, pad + lo:pad + hi] += cots[name][r]
        for r in range(size):
            lo, hi = windows[r]
            y, dx = got[r][name]
            np.testing.assert_array_equal(y, xp[:, :, pad + lo:pad + hi], err_msg=name)
            b0, b1 = row_block(height, r, size)
            np.testing.assert_array_equal(dx, grad[:, :, pad + b0:pad + b1], err_msg=name)


# ---------------------------------------------------------------------------
# 2. Each sharded op against the op on the whole tensor
# ---------------------------------------------------------------------------

def _trunk_heights(h0: int):
    h1 = conv_ops.out_rows(h0, 7, 2, 3)
    h2 = conv_ops.out_rows(h1, 3, 2, 1, ceil_mode=True)
    return h1, h2, conv_ops.out_rows(h2, 1, 2, 0)


def _op_cases(h0: int):
    """(name, input (B, C, H, W), whole op, rows op) at the heights the trunk gives an
    input of ``h0`` rows; the ops' parameters seeded."""
    h1, h2, h3 = _trunk_heights(h0)
    g = torch.Generator().manual_seed(h0)

    def w(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64) * 0.3

    stem, one = w(8, 3, 7, 7), w(6, 5, 1, 1)
    heads = [ClassifierModule(6, 3, 2).double(), ClassifierModule(6, 2, 2).double()]
    single = ClassifierModule(6, 3, 4).double()
    with torch.no_grad():
        for p in (p for m in (*heads, single) for p in m.parameters()):
            p.copy_(w(*p.shape))
    cases = [
        ("stem", (3, h0, 17), lambda x: F.conv2d(x, stem, None, 2, 3),
         lambda x, r: conv_ops.conv2d_rows(x, stem, None, r, h0, stride=2, padding=3)[0]),
        ("pool", (4, h1, 11), lambda x: F.max_pool2d(x, 3, 2, 1, ceil_mode=True),
         lambda x, r: conv_ops.max_pool_rows(x, r, h1)[0]),
        ("strided_1x1", (5, h2, 9), lambda x: F.conv2d(x, one, None, 2),
         lambda x, r: conv_ops.conv2d_rows(x, one, None, r, h2, stride=2)[0]),
        ("aspp_known_open", (6, h3, 7),
         lambda x: torch.cat([h(x) for h in heads], dim=1),
         lambda x, r: aspp_rows(heads, x, r, h3)),
        ("aspp_4_branches", (6, h3, 7), single,
         lambda x, r: aspp_rows([single], x, r, h3)),
    ]
    for d, h in ((1, h2), (2, h3), (4, h3)):
        wd = w(4, 4, 3, 3)
        cases.append((f"conv3x3_d{d}", (4, h, 9),
                      lambda x, wd=wd, d=d: conv_ops.dilated_conv3x3(x, wd, d),
                      lambda x, r, wd=wd, d=d, h=h: conv_ops.dilated_conv3x3_rows(
                          x, wd, d, r, h)))
    return cases


def _ops_rank(rank, size, h0):
    rows = _rows(size, h0)
    if rows is None:
        return None
    torch.set_default_dtype(torch.float64)
    try:
        out = {}
        for name, shape, whole, sharded in _op_cases(h0):
            g = torch.Generator().manual_seed(len(name))
            x = torch.randn(2, *shape, generator=g)
            y_whole = whole(x)
            cot = torch.randn(y_whole.shape, generator=g)
            lo, hi = rows.block(shape[1])
            xl = x[:, :, lo:hi].clone().requires_grad_()
            y = sharded(xl, rows)
            o0, o1 = rows.block(y_whole.shape[2])
            (y * cot[:, :, o0:o1]).sum().backward()
            out[name] = (y.detach().numpy(), xl.grad.numpy(), (o0, o1), (lo, hi))
        return out
    finally:
        torch.set_default_dtype(torch.float32)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("h0", [32, 44])
def test_each_sharded_op_equals_the_op_on_the_whole_tensor(pools, size, h0):
    pools(4).submit(_ops_rank, size, h0)
    want = {}
    torch.set_default_dtype(torch.float64)
    try:
        for name, shape, whole, _ in _op_cases(h0):
            g = torch.Generator().manual_seed(len(name))
            x = torch.randn(2, *shape, generator=g).requires_grad_()
            y = whole(x)
            cot = torch.randn(y.shape, generator=g)
            (y * cot).sum().backward()
            want[name] = (y.detach().numpy(), x.grad.numpy())
    finally:
        torch.set_default_dtype(torch.float32)
    got = pools(4).results()[:size]
    empty = 0
    for r, res in enumerate(got):
        for name, (y, dx, (o0, o1), (lo, hi)) in res.items():
            np.testing.assert_allclose(y, want[name][0][:, :, o0:o1], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(dx, want[name][1][:, :, lo:hi], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} rank {r}")
            empty += o0 == o1
    assert (empty > 0) == (size == 4)  # at S=4 some rank owns no rows of the stride-8 map


# ---------------------------------------------------------------------------
# 3. The ResNetMulti forward in train mode
# ---------------------------------------------------------------------------

def _forward_rank(rank, data, spatial, sd, x):
    mesh = make_mesh(data, spatial, device="cpu")
    model = ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32)
    model.load_state_dict(sd)
    local = shard_batch({"image": x}, mesh)["image"]
    with global_batch_stats(mesh.group), spatial_rows(mesh, x.shape[1]):
        y1, y2 = model.train()(torch.from_numpy(local).permute(0, 3, 1, 2))
    return ([y.detach().permute(0, 2, 3, 1).numpy() for y in (y1, y2)],
            {k: v.numpy() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def jax_forward():
    import jax
    import jax.numpy as jnp

    from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
    from simt_tpu_torch.models.from_jax import state_dict_from_flax

    jm = JResNetMulti(num_classes=C, open_classes=O, openset=True, layers=LAYERS,
                      dtype=jnp.float32)
    x = (np.random.RandomState(0).randn(2, *HW, 3) * 50).astype(np.float32)
    variables = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *HW, 3)), False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    (w1, w2), new = jax.jit(lambda v, xx: jm.apply(v, xx, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    sd = state_dict_from_flax(variables)
    want_sd = state_dict_from_flax({"params": variables["params"],
                                    "batch_stats": jax.tree.map(np.asarray,
                                                                new["batch_stats"])})
    port = ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32)
    port.load_state_dict(sd)
    p1, p2 = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (sd, x, [np.asarray(w1), np.asarray(w2)], want_sd,
            [p.detach().permute(0, 2, 3, 1).numpy() for p in (p1, p2)], port.state_dict())


@pytest.mark.parametrize("data,spatial", MESHES)
def test_train_forward_on_rows_equals_the_whole_batch(pools, jax_forward, data, spatial):
    sd, x, jax_logits, jax_sd, port_logits, port_sd = jax_forward
    got = pools(data * spatial).run(_forward_rank, data, spatial, sd, x)
    b = len(x) // data
    stats = [k for k in jax_sd if k.endswith(("running_mean", "running_var"))]
    for rank, (logits, running) in enumerate(got):
        d = rank // spatial
        for y, want_port, want_jax in zip(logits, port_logits, jax_logits):
            np.testing.assert_allclose(y, want_port[d * b:(d + 1) * b], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(y, want_jax[d * b:(d + 1) * b], rtol=2e-3,
                                       atol=2e-3)
        for k in stats:
            np.testing.assert_allclose(running[k], port_sd[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(running[k], jax_sd[k].numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=k)


# ---------------------------------------------------------------------------
# 4. The SimT and warmup steps against the JAX step on the whole batch
# ---------------------------------------------------------------------------

def _configs(lib, stage, arch, iter_size, cd):
    base = lib.TrainConfig()
    return lib.TrainConfig(
        stage=stage,
        model=lib.ModelConfig(arch=arch, num_classes=C, open_classes=O,
                              openset=stage == "simt", compute_dtype="float32",
                              aspp_effective_branches=4 if arch == "deeplab_single" else 2),
        optim=lib.OptimConfig(num_steps=100, iter_size=iter_size),
        simt=dataclasses.replace(lib.SimTConfig(), class_dist=cd, inner_w_steps=2),
        data=dataclasses.replace(base.data, crop_size=(HW[1], HW[0]), batch_size=1))


def _jax_models(arch, stage):
    import jax.numpy as jnp

    from simt_tpu.models import DeeplabSingle as JDeeplabSingle
    from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti

    if arch == "deeplab_single":
        return JDeeplabSingle(num_classes=C, layers=LAYERS, dtype=jnp.float32), None
    student = JResNetMulti(num_classes=C, open_classes=O, openset=stage == "simt",
                           layers=LAYERS, dtype=jnp.float32)
    teacher = (JResNetMulti(num_classes=C, layers=LAYERS, dtype=jnp.float32)
               if stage == "simt" else None)
    return student, teacher


STEP_CASES = {"simt_iter1": ("simt", "deeplab_multi", 1),
              "simt_iter2": ("simt", "deeplab_multi", 2),
              "warmup_multi": ("warmup", "deeplab_multi", 1),
              "warmup_single": ("warmup", "deeplab_single", 1)}
SIMT_KEYS = ("loss", "loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place")
# The warmup's parameter change after two steps against JAX's, each tensor by its norm:
# the one-process port is itself up to 1.5e-2 from JAX on these batches (float32 sums
# in another order, amplified by the random-init trunk's batch statistics, as
# tests/test_torch_warmup_step.py finds), so twice that. A wrong learning-rate group or
# a missed update is off by 90% or more.
WARMUP_CHANGE = 3e-2


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """Each case's JAX steps on the whole global batch of 2, computed once: (port
    config, port start state, batches, metrics, end state)."""
    import jax
    import jax.numpy as jnp

    from simt_tpu import config as jconfig
    from simt_tpu.train import (create_simt_state as j_simt, create_warmup_state as j_warm,
                                make_simt_step as j_make_simt,
                                make_warmup_step as j_make_warm)
    from simt_tpu_torch import config as tconfig
    from simt_tpu_torch.models.from_jax import (simt_state_from_jax, state_dict_from_flax,
                                                warmup_state_from_jax)

    cd = str(tmp_path_factory.mktemp("spatial") / "cd.npy")
    rng = np.random.RandomState(5)
    np.save(cd, (rng.rand(C) + 0.5).astype(np.float32) / 4)
    out = {}

    def init(model, seed):
        return jax.jit(lambda r: model.init(r, jnp.zeros((1, *HW, 3)), False))(
            jax.random.PRNGKey(seed))

    def case(name):
        if name in out:
            return out[name]
        stage, arch, iter_size = STEP_CASES[name]
        jcfg = _configs(jconfig, stage, arch, iter_size, cd)
        tcfg = _configs(tconfig, stage, arch, iter_size, cd)
        student, teacher = _jax_models(arch, stage)
        whole = [synthetic_batch(2 * iter_size, HW, C, seed=11 * i + iter_size)
                 for i in range(STEPS)]
        if iter_size > 1:
            whole = [{k: v.reshape(iter_size, 2, *v.shape[1:]) for k, v in b.items()}
                     for b in whole]
        if stage == "simt":
            js = j_simt(init(student, 0), init(teacher, 1), jcfg, jax.random.PRNGKey(2))
            start = simt_state_from_jax(jax.tree.map(np.asarray, js))
            step = j_make_simt(student, teacher, jcfg)
        else:
            js = j_warm(student, init(student, 0), jcfg)
            start = warmup_state_from_jax(jax.tree.map(np.asarray, js))
            step = j_make_warm(student, jcfg)
        metrics = []
        for b in whole:
            js, m = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        end = {"model": state_dict_from_flax(jax.tree.map(np.asarray, {
            "params": js.model.params, "batch_stats": js.model.batch_stats}))}
        if stage == "simt":
            end.update({k: np.asarray(getattr(js, k).param) for k in ("t1", "t2", "w1",
                                                                      "w2")})
        out[name] = (tcfg, start, whole, metrics, end)
        return out[name]

    return case


def _local(batch, mesh, iter_size):
    """This rank's block of one optimizer step's batch (sub-batches on axis 0)."""
    if iter_size == 1:
        return shard_batch(batch, mesh)
    subs = [shard_batch({k: v[i] for k, v in batch.items()}, mesh)
            for i in range(iter_size)]
    return {k: np.stack([s[k] for s in subs]) for k in subs[0]}


def _step_rank(rank, data, spatial, tcfg, start, batches):
    from simt_tpu_torch.models.from_jax import load_state

    mesh = make_mesh(data, spatial, device="cpu")
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, batch_size=2 // data))
    arch = tcfg.model.arch
    if tcfg.stage == "simt":
        st = create_simt_state(ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32),
                               ResNetMulti(C, 0, False, layers=LAYERS, dtype=torch.float32),
                               tcfg, torch.Generator().manual_seed(0), "cpu")
        load_state(st, start)
        step = make_simt_step(tcfg, mesh)
    else:
        model = (DeeplabSingle(C, layers=LAYERS, dtype=torch.float32)
                 if arch == "deeplab_single" else
                 ResNetMulti(C, 0, False, layers=LAYERS, dtype=torch.float32))
        model.load_state_dict(start["model"], strict=True)
        st = create_warmup_state(model, tcfg, "cpu")
        st.step = start["step"]
        step = make_warmup_step(tcfg, mesh)
    it = tcfg.optim.iter_size
    metrics = [{k: float(v) for k, v in step(st, _local(b, mesh, it)).items()}
               for b in batches]
    params = {k: v.numpy() for k, v in st.model.state_dict().items()}
    if tcfg.stage == "simt":
        params.update({k: getattr(st, k).param.detach().numpy()
                       for k in ("t1", "t2", "w1", "w2")})
    return metrics, params


@pytest.mark.parametrize("name", list(STEP_CASES))
@pytest.mark.parametrize("data,spatial", MESHES)
def test_steps_on_rows_match_the_jax_step(pools, jax_steps, name, data, spatial):
    tcfg, start, batches, want, end = jax_steps(name)
    got = pools(data * spatial).run(_step_rank, data, spatial, tcfg, start, batches)
    m0, p0 = got[0]
    for m, p in got[1:]:
        assert m == m0
        for k in p0:
            assert np.array_equal(p[k], p0[k]), k
    keys = SIMT_KEYS if tcfg.stage == "simt" else ("loss_seg1", "loss_seg2")
    for i, (w, have) in enumerate(zip(want, m0)):
        for k in keys:
            assert have[k] == pytest.approx(w[k], rel=2e-4, abs=2e-4), (i, k)
    if tcfg.stage == "simt":
        for k in ("t1", "t2", "w1", "w2"):
            np.testing.assert_allclose(p0[k], end[k], atol=2e-5, err_msg=k)
        return
    trained = [k for k, v in start["model"].items()
               if k.endswith(("weight", "bias")) and not k.startswith("bn")
               and ".bn" not in k and "downsample.1" not in k]
    moved = 0
    for k in trained:
        want_d = end["model"][k].numpy() - start["model"][k].numpy()
        got_d = p0[k] - start["model"][k].numpy()
        if np.abs(want_d).max() == 0:  # an ASPP branch past the count: frozen
            assert np.abs(got_d).max() == 0, k
            continue
        moved += 1
        rel = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
        assert rel <= WARMUP_CHANGE, (k, rel)
    assert moved
    for k in (k for k in end["model"] if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(p0[k], end["model"][k].numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def _cache_rank(rank, tcfg, start, batch):
    from simt_tpu_torch.models.from_jax import load_state
    from simt_tpu_torch.parallel import shard_rows
    from simt_tpu_torch.train.teacher_cache import TeacherCache

    mesh = make_mesh(1, 2, device="cpu")
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, batch_size=2))
    out = {}
    for cached in (False, True):
        st = create_simt_state(ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32),
                               ResNetMulti(C, 0, False, layers=LAYERS, dtype=torch.float32),
                               tcfg, torch.Generator().manual_seed(0), "cpu")
        load_state(st, start)
        b = batch
        if cached:
            cache = TeacherCache(st.teacher, store_dtype=torch.float32, mesh=mesh)
            b = cache.attach({**batch, "name": ["a", "b"], "mirror": [False, False]})
            out["prob"] = b["teacher_prob8"].numpy()
        m = make_simt_step(tcfg, mesh)(st, shard_rows(b, mesh))
        out[cached] = {k: float(v) for k, v in m.items()}
    return out


def test_cached_teacher_on_rows_equals_the_uncached_step(pools, jax_steps):
    """The teacher cache on a spatial axis: its H-sharded teacher stores the whole
    posterior (the one-process cache's at rtol 1e-5), which the loop cuts into rows and
    the step gathers back; the cached step equals the uncached one at 1e-5."""
    from simt_tpu_torch.models.from_jax import load_state
    from simt_tpu_torch.train.teacher_cache import TeacherCache

    tcfg, start, batches, _, _ = jax_steps("simt_iter1")
    got = pools(2).run(_cache_rank, tcfg, start, batches[0])
    st = create_simt_state(ResNetMulti(C, O, True, layers=LAYERS, dtype=torch.float32),
                           ResNetMulti(C, 0, False, layers=LAYERS, dtype=torch.float32),
                           tcfg, torch.Generator().manual_seed(0), "cpu")
    load_state(st, start)
    want = TeacherCache(st.teacher, store_dtype=torch.float32).forward(batches[0]["image"])
    for r in got:
        np.testing.assert_allclose(r["prob"], want.numpy(), rtol=1e-5, atol=1e-6)
        for k in SIMT_KEYS:
            assert r[True][k] == pytest.approx(r[False][k], rel=1e-5, abs=1e-5), k
    assert got[0][True] == got[1][True]


# ---------------------------------------------------------------------------
# 5. The band loss
# ---------------------------------------------------------------------------

KW = dict(num_classes=C, threshold_high=0.8, ignore_label=255)


def _core_inputs(seed, h8=5, w8=9, hh=32, ww=64, b=2):
    rng = np.random.RandomState(seed)
    total = C + O
    xcat = torch.from_numpy((rng.randn(b, h8, w8, 2 * total) * 2).astype(np.float32))
    label = torch.from_numpy(np.where(rng.rand(b, hh, ww) < 0.15, 255,
                                      rng.randint(0, C, (b, hh, ww))).astype(np.int64))
    conf = torch.from_numpy(np.where(rng.rand(b, hh, ww) < 0.3, C,
                                     rng.randint(0, C, (b, hh, ww))).astype(np.uint8))
    t = [np.exp(rng.randn(total, C)) for _ in range(2)]
    t1, t2 = (torch.from_numpy((a / a.sum(-1, keepdims=True)).astype(np.float32))
              for a in t)
    return xcat, label, conf, t1, t2


@pytest.mark.parametrize("split", [1, 13, 16, 31])
def test_band_core_over_two_bands_equals_the_whole_image(split):
    xcat, label, conf, t1, t2 = _core_inputs(split)
    hh = label.shape[1]
    whole = lf.loss_core_fwd_reference(xcat, label, conf, t1, t2, chunk_rows=7, **KW)
    bands = [lf.loss_core_fwd_reference(xcat, label[:, r0:r1], conf[:, r0:r1], t1, t2,
                                        chunk_rows=7, band=(r0, hh), **KW)
             for r0, r1 in ((0, split), (split, hh))]
    sums = bands[0][0] + bands[1][0]
    assert torch.equal(sums[:, 1::2], whole[0][:, 1::2])  # the counts
    torch.testing.assert_close(sums[:, ::2], whole[0][:, ::2], rtol=1e-6, atol=0)
    amax = torch.maximum(bands[0][1], bands[1][1])
    # The first occurrence in batch-major order: the lower index on a tie.
    aidx = torch.where(bands[1][1] > bands[0][1], bands[1][2],
                       torch.where(bands[1][1] == bands[0][1],
                                   torch.minimum(bands[0][2], bands[1][2]), bands[0][2]))
    assert torch.equal(amax, whole[1]) and torch.equal(aidx, whole[2])
    assert torch.equal(torch.maximum(bands[0][3], bands[1][3]), whole[3])
    g = torch.from_numpy(np.random.RandomState(0).randn(2, 8).astype(np.float32))
    dwhole = lf.loss_core_bwd_reference(g, xcat, label, conf, t1, t2, chunk_rows=7, **KW)
    dbands = [lf.loss_core_bwd_reference(g, xcat, label[:, r0:r1], conf[:, r0:r1], t1,
                                         t2, chunk_rows=5, band=(r0, hh), **KW)
              for r0, r1 in ((0, split), (split, hh))]
    for i in range(3):
        torch.testing.assert_close(dbands[0][i] + dbands[1][i], dwhole[i], rtol=1e-6,
                                   atol=1e-6 * float(dwhole[i].abs().max()))


@pytest.mark.parametrize("split", [0, 11, 32])
def test_band_upsample_ce_and_teacher_labels_equal_the_whole_image(split):
    """``upsample_ce`` over bands [0, R) and [R, H): the sums of CE and counts add up to
    the whole image's, an empty band included (0, still a node of the logits); the
    teacher labels of a band are the whole image's rows."""
    rng = np.random.RandomState(split)
    logits = torch.from_numpy(rng.randn(2, 5, 9, C).astype(np.float32)).requires_grad_()
    label = torch.from_numpy(np.where(rng.rand(2, *HW) < 0.1, 255,
                                      rng.randint(0, C, (2, *HW))).astype(np.int64))
    hh = HW[0]
    n_all = float((label != 255).sum())
    whole = upsample_ce(logits, label, chunk_rows=7)
    (g_whole,) = torch.autograd.grad(whole, logits)
    total, grads = 0.0, 0.0
    for r0, r1 in ((0, split), (split, hh)):
        band = upsample_ce(logits, label[:, r0:r1], chunk_rows=5, band=(r0, hh))
        n = float((label[:, r0:r1] != 255).sum())
        (g,) = torch.autograd.grad(band, logits)
        total, grads = total + float(band.detach()) * n / n_all, grads + g * n / n_all
        if r0 == r1:
            assert float(band.detach()) == 0.0 and float(g.abs().max()) == 0.0
    assert total == pytest.approx(float(whole.detach()), rel=1e-6)
    torch.testing.assert_close(grads, g_whole, rtol=1e-5, atol=1e-7)
    prob = torch.softmax(torch.from_numpy(rng.randn(2, 5, 9, C).astype(np.float32)), -1)
    kw = dict(num_classes=C, threshold_high=0.3, threshold_low=0.25)
    conf = teacher_conf(prob, HW, **kw)
    assert torch.equal(teacher_conf(prob, HW, rows=(split, hh), **kw), conf[:, split:])


@pytest.mark.parametrize("band", [(0, 512), (0, 256), (256, 512), (129, 131), (511, 512)])
def test_band_schedule_covers_the_band_once(band):
    r_lo, r_hi = band
    s = lf.schedule(1, 65, 129, 512, 1024, 2 * (C + O), C, r_lo, r_hi)
    seen = np.zeros((512, 1024), np.int64)
    for b, r0, r1, c0, c1, *_ in s.blocks:
        seen[r0:r1, c0:c1] += 1
    assert (seen[r_lo:r_hi] == 1).all() and seen.sum() == (r_hi - r_lo) * 1024
    if band == (0, 512):
        whole = lf.schedule(1, 65, 129, 512, 1024, 2 * (C + O), C)
        assert np.array_equal(s.blocks, whole.blocks)
        assert np.array_equal(s.row_blk, whole.row_blk) and s.part_floats == whole.part_floats


def _block_inputs(case):
    """A global batch of 2 images (stride-8 logits at the labels' 8x12, 3x12 for
    ``short``: the upsample is the identity) with a planted anchor tie on channel 6."""
    rng = np.random.RandomState(7)
    h, w, total = (3 if case == "short" else 8), 12, C + O
    x1, x2 = (rng.randn(2, h, w, total).astype(np.float32) * 2 for _ in range(2))
    teacher = rng.randn(2, h, w, C).astype(np.float32) * 4
    label = np.where(rng.rand(2, h, w) < 0.15, 255,
                     rng.randint(0, C, (2, h, w))).astype(np.int64)
    for x in (x1, x2):
        x[TIES[case]["first"]] = x[TIES[case]["later"]] = 9.0
    prob = np.exp(teacher) / np.exp(teacher).sum(-1, keepdims=True)
    t = [np.exp(rng.randn(total, C)) for _ in range(2)]
    t = [(a / a.sum(-1, keepdims=True)).astype(np.float32) for a in t]
    return x1, x2, prob.astype(np.float32), label, t[0], t[1]


# The planted tie's pixels (image, row, column, channel) in batch-major order: one image
# in two bands (row 2 before row 6; with 3 rows over 4 ranks, one band empty), or two
# images (image 0's later row before image 1's earlier one).
TIES = {"rows": {"first": (0, 2, 9, 6), "later": (0, 6, 1, 6)},
        "short": {"first": (0, 0, 9, 6), "later": (0, 2, 1, 6)},
        "images": {"first": (0, 6, 1, 6), "later": (1, 1, 9, 6)}}
BLOCK_KW = dict(num_classes=C, open_classes=O, threshold_high=0.8, threshold_low=0.2,
                lambda_place=0.1, lambda_seg=0.1)
DATA_KEYS = ("loss_p1", "loss_p2", "loss_y1", "loss_y2", "place")


def _block(x1, x2, prob, label, t1, t2, **kw):
    xs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in (x1, x2, t1, t2)]
    losses = simt_loss_block(xs[0], xs[1], torch.from_numpy(prob),
                             torch.from_numpy(label), xs[2], xs[3], **BLOCK_KW, **kw)
    grads = torch.autograd.grad(sum(losses[k] for k in DATA_KEYS), xs)
    return {k: float(v.detach()) for k, v in losses.items()}, [g.numpy() for g in grads]


def _block_rank(rank, data, spatial, inputs):
    mesh = make_mesh(data, spatial, device="cpu")
    x1, x2, prob, label, t1, t2 = inputs
    b = len(label) // data
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    lo, hi = row_block(label.shape[1], mesh.spatial_index, spatial)
    return _block(x1[sl], x2[sl], prob[sl], label[sl, lo:hi], t1, t2, group=mesh.group,
                  band=(lo, label.shape[1]), first_image=mesh.data_index * b)


@pytest.mark.parametrize("data,spatial,case", [(1, 2, "rows"), (1, 4, "rows"),
                                               (1, 4, "short"), (2, 2, "images")])
def test_band_loss_block_equals_the_whole_batch(pools, data, spatial, case):
    inputs = _block_inputs(case)
    pools(data * spatial).submit(_block_rank, data, spatial, inputs)
    want, want_g = _block(*inputs)
    got = pools(data * spatial).results()
    for k in DATA_KEYS:
        assert sum(g[0][k] for g in got) == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    for losses, _ in got:
        assert losses["anchor"] == pytest.approx(want["anchor"], rel=1e-6)
    b = 2 // data
    for d in range(data):  # a data index's logits: the gradient summed over its bands
        for i in (0, 1):
            have = sum(got[d * spatial + s][1][i] for s in range(spatial))
            np.testing.assert_allclose(have, want_g[i][d * b:(d + 1) * b], rtol=1e-5,
                                       atol=1e-7)
    for i in (2, 3):
        np.testing.assert_allclose(sum(g[1][i] for g in got), want_g[i], rtol=1e-5,
                                   atol=1e-7)
    # The first occurrence won the tie: without the other pixel's maximum the anchor
    # stays, without the winner's it moves.
    for pixel, same in ((TIES[case]["later"], True), (TIES[case]["first"], False)):
        other = [a.copy() for a in inputs]
        for x in other[:2]:
            x[pixel] = 0.0
        moved = _block(*other)[0]["anchor"]
        assert (moved == pytest.approx(want["anchor"], rel=1e-6)) == same, pixel
