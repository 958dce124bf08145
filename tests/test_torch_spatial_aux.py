"""Port on gloo ranks over the spatial axis: H-sharded training of the other two
families, DeepLabv3 and DeepLab-VGG (simt_tpu_torch/ops/conv.py's generalised
``max_pool_rows``, ops/interp.py's ``upsample_bilinear_half_pixel_rows``,
models/deeplabv3.py's and models/deeplab_vgg.py's rows forwards, the band case of
train/warmup.py's plain masked CE).

Spawned ranks (``RankPool`` of tests/test_torch_parallel.py: 2 and 4 processes, gloo
over localhost, one thread each), every image split by height into blocks of
ceil(H / S) rows (the last ones shorter or empty):

  - the pools of the three families (the ResNet stem's 3x3/2 pad-1 ceil mode,
    DeepLabv3's 3x3/2 pad-1 floor mode, DeepLab-VGG's 2x2/2 floor mode on odd heights)
    and the rows half-pixel upsample (stride-16 rows to the input's, with the first
    and last ranks' source rows clamped at the edges) against the whole call on S = 2
    and 4 ranks, float64: output and input gradient at rtol 1e-5 / atol 1e-5;
  - DeepLabv3 (closed and open set, full width, 70x24: a stride-16 map of 5 rows, so at
    S = 4 layer2's map of 9 rows leaves the last rank empty, and so does the
    stride-16 one; strided 3x3s on blocks whose first row is odd) and DeepLab-VGG
    (full width, 44x24: a 2x2 pool on the odd height 11, a stride-8 map of 5 rows) in
    train mode on meshes (1,2), (1,4) and (2,2): the logits (DeepLabv3's rank band of
    the input-size rows, VGG's gathered stride-8 map) and the running statistics
    against the port's own forward of the whole batch at rtol 1e-5 / atol 1e-5
    (statistics atol 1e-6) and against the JAX model's at 2e-3
    (tests/test_torch_spatial.py's tolerances). The port runs these forwards in
    float64: at its random init DeepLabv3's float32 forward is ill-conditioned (the
    batch statistics of small stride-16 maps; tests/test_torch_aux_models.py), so its
    float32 logits sit ~1e-4 from float64 ones however the sums are ordered (the JAX
    model's ~3e-4), and only float64 holds the rows' arithmetic to the whole's at 1e-5;
  - one warmup step of each on the same meshes against the JAX warmup step on the
    whole global batch of 2: the losses at rel 2e-4 / abs 2e-4, each trained tensor's
    change within ``WARMUP_CHANGE`` of JAX's by its norm (DeepLabv3: ``V3_REL``, the
    gate of its one-process and data-axis steps, tests/test_torch_aux_models.py and
    tests/test_torch_parallel.py: its float32 changes sit 3.0-3.4% from JAX's on the
    ranks and 2.7% in one process), the running statistics at 2e-3, every rank's state
    equal bit for bit; and the same step in float64 against the port's one-process
    float64 step, each change within ``TOL_F64`` by its norm (the ranks' arithmetic
    against the whole's, which float32 cannot resolve for DeepLabv3).

JAX is imported inside the tests and their fixtures: the ranks re-import this module
and need only torch.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from simt_tpu_torch.data.synthetic import synthetic_batch
from simt_tpu_torch.models import DeepLabv3, DeeplabVGG
from simt_tpu_torch.ops import conv as conv_ops
from simt_tpu_torch.ops.interp import upsample_bilinear_half_pixel_rows
from simt_tpu_torch.parallel import (global_batch_stats, make_mesh, row_block, shard_batch,
                                     spatial_rows)
from simt_tpu_torch.train import create_warmup_state, make_warmup_step

from test_torch_parallel import V3_REL, RankPool
from test_torch_spatial import WARMUP_CHANGE, _rows

C, O = 5, 3
MESHES = [(1, 2), (1, 4), (2, 2)]
# (arch, openset) -> input (h, w). DeepLabv3: 70 -> 35 -> 18 -> 9 -> 5 rows (stride 16);
# VGG: 44 -> 22 -> 11 -> 5 rows (stride 8, the 2x2 pool dropping row 10 of 11).
# The float64 step's changes against the port's one-process float64 step, by norm: the
# losses' float32 cross entropy bounds the agreement (~8e-7 measured for DeepLabv3).
TOL_F64 = 1e-5
ARCHS = {("deeplabv3", False): (70, 24), ("deeplabv3", True): (70, 24),
         ("deeplab_vgg", False): (44, 24)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread: the tests' tensors are small, and several threads per process under
    the suite's parallel workers only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# 1. The generalised pool and the rows half-pixel upsample
# ---------------------------------------------------------------------------

POOLS = {"stem_ceil": (3, 2, 1, True), "v3_floor": (3, 2, 1, False),
         "vgg_floor": (2, 2, 0, False)}


def _op_cases(h: int):
    """(name, input (C, H, W), whole op, rows op) on inputs of ``h`` rows: the three
    pools, and the half-pixel upsample of an ``h``-row map to 16 h - 10 rows."""
    cases = []
    for name, (k, s, p, ceil) in POOLS.items():
        cases.append((name, (3, h, 7),
                      lambda x, k=k, s=s, p=p, ceil=ceil: F.max_pool2d(x, k, s, p,
                                                                       ceil_mode=ceil),
                      lambda x, r, k=k, s=s, p=p, ceil=ceil: conv_ops.max_pool_rows(
                          x, r, h, k, s, p, ceil)[0]))
    out_hw = (16 * h - 10, 37)
    cases.append(("half_pixel", (3, h, 5),
                  lambda x: F.interpolate(x, size=out_hw, mode="bilinear",
                                          align_corners=False),
                  lambda x, r: upsample_bilinear_half_pixel_rows(x, r, h, out_hw)))
    return cases


def _ops_rank(rank, size, h):
    rows = _rows(size, h)
    if rows is None:
        return None
    torch.set_default_dtype(torch.float64)
    try:
        out = {}
        for name, shape, whole, sharded in _op_cases(h):
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
@pytest.mark.parametrize("h", [9, 11])
def test_pools_and_half_pixel_rows_equal_the_whole_call(pools, size, h):
    pools(4).submit(_ops_rank, size, h)
    want = {}
    torch.set_default_dtype(torch.float64)
    try:
        for name, shape, whole, _ in _op_cases(h):
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
    # At S = 4 the pools' outputs of 4-6 rows leave a rank empty.
    assert (empty > 0) == (size == 4)


# ---------------------------------------------------------------------------
# 2. The forwards in train mode
# ---------------------------------------------------------------------------

def _port_model(arch, openset):
    if arch == "deeplabv3":
        return DeepLabv3(C, O if openset else 0, openset, dtype=torch.float32)
    return DeeplabVGG(C, dtype=torch.float32)


def _nhwc(y):
    y = y[0] if isinstance(y, tuple) else y
    return y.detach().permute(0, 2, 3, 1).numpy()


def _forward_rank(rank, data, spatial, arch, openset, sd, x):
    mesh = make_mesh(data, spatial, device="cpu")
    model = _port_model(arch, openset)
    model.load_state_dict(sd)
    local = shard_batch({"image": x}, mesh)["image"]
    with global_batch_stats(mesh.group), spatial_rows(mesh, x.shape[1]):
        y = model.double().train()(torch.from_numpy(local).double().permute(0, 3, 1, 2))
    return (_nhwc(y), {k: v.numpy() for k, v in model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def jax_forwards():
    """Each (arch, openset): the JAX model's init and train-mode forward of a batch of
    2, and the port's forward of the same batch in one process."""
    import jax
    import jax.numpy as jnp

    from simt_tpu.models import DeepLabv3 as JDeepLabv3
    from simt_tpu.models import DeeplabVGG as JDeeplabVGG
    from simt_tpu_torch.models.from_jax import state_dict_from_flax

    @functools.lru_cache(maxsize=None)
    def case(key):
        arch, openset = key
        hw = ARCHS[(arch, openset)]
        jm = (JDeepLabv3(num_classes=C, open_classes=O if openset else 0, openset=openset,
                         dtype=jnp.float32) if arch == "deeplabv3" else
              JDeeplabVGG(num_classes=C, dtype=jnp.float32))
        x = (np.random.RandomState(len(arch)).randn(2, *hw, 3) * 50).astype(np.float32)
        variables = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *hw, 3)), False))(
            jax.random.PRNGKey(0))
        variables = jax.tree.map(np.asarray, variables)
        y, new = jax.jit(lambda v, xx: jm.apply(v, xx, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        y = y[0] if isinstance(y, tuple) else y
        sd = state_dict_from_flax(variables)
        want_sd = state_dict_from_flax({**variables, **jax.tree.map(np.asarray, new)})
        port = _port_model(arch, openset)
        port.load_state_dict(sd)
        py = port.double().train()(torch.from_numpy(x).double().permute(0, 3, 1, 2))
        return sd, x, np.asarray(y), want_sd, _nhwc(py), port.state_dict(), variables

    return case


@pytest.mark.parametrize("arch,openset", list(ARCHS))
@pytest.mark.parametrize("data,spatial", MESHES)
def test_train_forward_on_rows_equals_the_whole_batch(pools, jax_forwards, arch, openset,
                                                      data, spatial):
    sd, x, jax_y, jax_sd, port_y, port_sd, _ = jax_forwards((arch, openset))
    got = pools(data * spatial).run(_forward_rank, data, spatial, arch, openset, sd, x)
    b = len(x) // data
    stats = [k for k in jax_sd if k.endswith(("running_mean", "running_var"))]
    empty = 0
    for rank, (y, running) in enumerate(got):
        d, s = divmod(rank, spatial)
        want_port, want_jax = port_y[d * b:(d + 1) * b], jax_y[d * b:(d + 1) * b]
        if arch == "deeplabv3":  # the rank's band of the input-size rows
            lo, hi = row_block(x.shape[1], s, spatial)
            want_port, want_jax = want_port[:, lo:hi], want_jax[:, lo:hi]
        assert y.shape == want_port.shape
        np.testing.assert_allclose(y, want_port, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, want_jax, rtol=2e-3, atol=2e-3)
        for k in stats:
            np.testing.assert_allclose(running[k], port_sd[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(running[k], jax_sd[k].numpy(), rtol=2e-3,
                                       atol=2e-3, err_msg=k)


# ---------------------------------------------------------------------------
# 3. One warmup step against the JAX step on the whole batch
# ---------------------------------------------------------------------------

def _configs(lib, arch, hw):
    base = lib.TrainConfig()
    return lib.TrainConfig(
        stage="warmup",
        model=lib.ModelConfig(arch=arch, num_classes=C, compute_dtype="float32"),
        optim=lib.OptimConfig(num_steps=100),
        data=dataclasses.replace(base.data, crop_size=(hw[1], hw[0]), batch_size=1))


@pytest.fixture(scope="module")
def jax_steps(jax_forwards):
    """Each arch's JAX warmup step on the whole global batch of 2 from the forward
    test's closed-set initialisation: (port config, start state, batch, metrics, end
    state, the port's one-process step from the same start in float64)."""
    import jax
    import jax.numpy as jnp

    from simt_tpu import config as jconfig
    from simt_tpu.models import DeepLabv3 as JDeepLabv3
    from simt_tpu.models import DeeplabVGG as JDeeplabVGG
    from simt_tpu.train import create_warmup_state as j_warm, make_warmup_step as j_make
    from simt_tpu_torch import config as tconfig
    from simt_tpu_torch.models.from_jax import state_dict_from_flax, warmup_state_from_jax

    @functools.lru_cache(maxsize=None)
    def case(arch):
        hw = ARCHS[(arch, False)]
        jm = (JDeepLabv3(num_classes=C, dtype=jnp.float32) if arch == "deeplabv3" else
              JDeeplabVGG(num_classes=C, dtype=jnp.float32))
        jcfg, tcfg = _configs(jconfig, arch, hw), _configs(tconfig, arch, hw)
        js = j_warm(jm, jax_forwards((arch, False))[-1], jcfg)
        start = warmup_state_from_jax(jax.tree.map(np.asarray, js))
        batch = synthetic_batch(2, hw, C, seed=7)
        js, m = j_make(jm, jcfg)(js, {k: jnp.asarray(v) for k, v in batch.items()})
        end = state_dict_from_flax(jax.tree.map(np.asarray, {
            "params": js.model.params, "batch_stats": js.model.batch_stats}))
        # The port's one-process step on the whole batch, in float64.
        model = _port_model(arch, False)
        model.load_state_dict(start["model"], strict=True)
        st = create_warmup_state(model.double(), tcfg, "cpu")
        st.step = start["step"]
        make_warmup_step(tcfg)(st, {**batch, "image": batch["image"].astype(np.float64)})
        port64 = {k: v.numpy() for k, v in st.model.state_dict().items()}
        return tcfg, start, batch, {k: float(v) for k, v in m.items()}, end, port64

    return case


def _step_rank(rank, data, spatial, tcfg, start, batch, dtype):
    mesh = make_mesh(data, spatial, device="cpu")
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, batch_size=2 // data))
    model = _port_model(tcfg.model.arch, False)
    model.load_state_dict(start["model"], strict=True)
    st = create_warmup_state(model.to(dtype), tcfg, "cpu")
    st.step = start["step"]
    batch = {**batch, "image": batch["image"].astype(np.float64 if dtype == torch.float64
                                                     else np.float32)}
    metrics = {k: float(v) for k, v in
               make_warmup_step(tcfg, mesh)(st, shard_batch(batch, mesh)).items()}
    # Every rank's state against rank 0's, bit for bit (float64 holds float32 values
    # exactly); rank 0 alone sends its state back.
    sd = st.model.state_dict()
    mine = torch.cat([v.detach().reshape(-1).double() for v in sd.values()])
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    same = torch.tensor([int(torch.equal(mine, theirs))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return metrics, bool(same), ({k: v.numpy() for k, v in sd.items()} if rank == 0
                                 else None)


def _changes(start, params, want):
    """Each trained tensor's change against ``want``'s by its norm, and the frozen
    tensors' changes (all 0)."""
    rel, frozen = {}, []
    for k, v in start.items():
        if not k.endswith(("weight", "bias")):
            continue
        want_d = np.asarray(want[k], np.float64) - v.numpy()
        got_d = np.asarray(params[k], np.float64) - v.numpy()
        if np.abs(want_d).max() == 0:  # frozen (the stem, an ASPP branch past the count)
            frozen.append(np.abs(got_d).max())
            continue
        rel[k] = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
    return rel, frozen


@pytest.mark.parametrize("arch", ["deeplabv3", "deeplab_vgg"])
@pytest.mark.parametrize("data,spatial", MESHES)
def test_warmup_step_on_rows_matches_the_jax_step(pools, jax_steps, arch, data, spatial):
    tcfg, start, batch, want, end, port64 = jax_steps(arch)
    pool = pools(data * spatial)
    got = pool.run(_step_rank, data, spatial, tcfg, start, batch, torch.float32)
    got64 = pool.run(_step_rank, data, spatial, tcfg, start, batch, torch.float64)
    for res in (got, got64):
        assert all(m == res[0][0] and same for m, same, _ in res)
    m0, _, p0 = got[0]
    for k in ("loss_seg1", "loss_seg2"):
        assert m0[k] == pytest.approx(want[k], rel=2e-4, abs=2e-4), k
    rel, frozen = _changes(start["model"], p0, end)
    assert rel and not any(frozen)
    gate = WARMUP_CHANGE if arch == "deeplab_vgg" else V3_REL
    assert max(rel.values()) <= gate, max(rel.items(), key=lambda kv: kv[1])
    rel64, frozen64 = _changes(start["model"], got64[0][2], port64)
    assert not any(frozen64)
    assert max(rel64.values()) <= TOL_F64, max(rel64.items(), key=lambda kv: kv[1])
    for k in (k for k in end if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(p0[k], end[k].numpy(), rtol=2e-3, atol=2e-3, err_msg=k)
