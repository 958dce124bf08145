"""The host side of the eval head's kernel B1 (simt_tpu_torch/ops/kernels/eval_fused.py),
on the CPU: the block schedule the kernel walks, a numpy model of its argmax, the plain
version's uint8/int32 gt, ``out=`` and row blocks, and the row-sharded entry point
``multiscale_argmax_hist_spatial`` under ``gloo`` against the unsharded histogram and the
JAX package's ``multiscale_argmax_hist_spatial`` (Pallas in interpret mode). The kernel
itself runs only on the card (chip_smoke.py).
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.interp import interp_taps
from simt_tpu_torch.ops.kernels import eval_fused as tef
from simt_tpu_torch.tools import bench_eval_fused

C = 19
OUT_HW = (64, 128)
MAIN = (65, 129, 81, 161, (1024, 2048))
# (ha, wa, hb, wb, out_hw): the main path's, warmup's 1x1 second operand, and the
# edge shapes chip_smoke.py runs on the card.
SHAPES = {"main": MAIN, "warmup_1x1": (65, 129, 1, 1, (1024, 2048)),
          "ragged": (7, 13, 3, 4, (37, 301)), "single_pixel": (4, 6, 1, 1, (1, 1)),
          "wide_sources": (9, 400, 11, 300, (64, 1000))}
ROW_RANGES = [None, (0, 256), (256, 256), (768, 256), (1, 1), (5, 700), (1023, 1)]


def _hits(s, out_hw):
    hits = np.zeros(out_hw, np.int32)
    for r0, r1, c0, c1, *_ in s.blocks:
        hits[r0:r1, c0:c1] += 1
    return hits


@pytest.mark.parametrize("name", list(SHAPES))
def test_schedule_covers_every_pixel_once_with_the_taps_it_reads(name):
    ha, wa, hb, wb, out_hw = SHAPES[name]
    s = tef.schedule(ha, wa, hb, wb, out_hw, C)
    assert (_hits(s, out_hw) == 1).all()
    taps = {k: interp_taps(*v) for k, v in
            dict(ha=(ha, out_hw[0]), wa=(wa, out_hw[1]), hb=(hb, out_hw[0]),
                 wb=(wb, out_hw[1])).items()}
    for r0, r1, c0, c1, ia0, ia1, ja0, ja1, ib0, ib1, jb0, jb1 in s.blocks:
        assert 0 < r1 - r0 <= min(s.band, tef.MAX_BAND) and 0 < c1 - c0 <= s.threads
        assert c0 % 16 == 0  # 16-byte gt copies start on a segment
        for (i0, i1), (j0, j1), sh, sw in (((ia0, ia1), (ja0, ja1), "ha", "wa"),
                                             ((ib0, ib1), (jb0, jb1), "hb", "wb")):
            lo_h, hi_h = taps[sh][:2]
            lo_w, hi_w = taps[sw][:2]
            assert (i0, i1) == (lo_h[r0:r1].min(), hi_h[r0:r1].max())
            assert (j0, j1) == (lo_w[c0:c1].min(), hi_w[c0:c1].max())
            assert i1 - i0 < tef.MAX_SOURCE_ROWS  # the kernel holds 3 source rows
            assert j1 - j0 < (s.xca if sw == "wa" else s.xcb)  # z's columns fit


@pytest.mark.parametrize("row_range", ROW_RANGES, ids=str)
def test_schedule_covers_a_row_range_once_and_nothing_else(row_range):
    s = tef.schedule(*MAIN, C, row_range=row_range)
    row0, rows = row_range or (0, 1024)
    want = np.zeros((1024, 2048), np.int32)
    want[row0:row0 + rows] = 1
    np.testing.assert_array_equal(_hits(s, (1024, 2048)), want)


def test_schedule_covers_random_row_ranges_of_random_shapes():
    rng = np.random.default_rng(0)
    for _ in range(25):
        hh, ww = (int(v) for v in rng.integers(1, 1500, 2))
        row0 = int(rng.integers(0, hh))
        rows = int(rng.integers(1, hh - row0 + 1))
        h8, w8 = (int(v) for v in rng.integers(1, 90, 2))
        s = tef.schedule(h8, w8, 1, 1, (hh, ww), C, batch=int(rng.integers(1, 4)),
                         row_range=(row0, rows))
        want = np.zeros((hh, ww), np.int32)
        want[row0:row0 + rows] = 1
        np.testing.assert_array_equal(_hits(s, (hh, ww)), want)


@pytest.mark.parametrize("batch,row_range,waves", [(1, None, 2), (2, None, 4),
                                                   (1, (256, 256), 1), (4, None, 8)])
def test_schedule_fills_whole_waves_of_two_blocks_an_sm(batch, row_range, waves):
    s = tef.schedule(*MAIN, C, batch=batch, row_range=row_range)
    slots = tef.NUM_SMS * tef.BLOCKS_PER_SM
    assert len(s.blocks) * batch == waves * slots
    # Two blocks an SM: each takes at most half of the SM's 228 KB of shared memory
    # (1 KB of it reserved a block), and 512 threads at <= 64 registers.
    assert s.threads == tef.THREADS and s.smem <= 228 * 1024 // 2 - 1024
    assert s.cp == 20 and s.band <= tef.MAX_BAND


def test_schedule_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="row range"):
        tef.schedule(*MAIN, C, row_range=(1000, 25))
    with pytest.raises(ValueError, match="32 classes"):
        tef.schedule(*MAIN, 33)
    with pytest.raises(ValueError, match="shared memory"):
        tef.schedule(3, 9000, 3, 9000, (16, 4096), 32)


def test_smem_bytes_is_the_sum_of_the_parts():
    s = tef.schedule(*MAIN, C)
    assert (s.band, s.xca, s.xcb) == (8, 33, 41)  # 512 columns: 32 of a's intervals, 40 of b's
    parts = [s.band * s.xca * 20 * 4, s.band * s.xcb * 20 * 4, 16 * C * C * 4,
             2 * s.band * 16, s.band * 512]
    assert s.smem == sum(-(-p // 16) * 16 for p in parts)


def _combine(v, a, rv, ra, nan_rule):
    take = rv > v or (nan_rule and rv != rv and v == v)
    return (rv, ra) if take else (v, a)


def _kernel_argmax(vals, cp):
    """The kernel's argmax of one pixel (pixel_argmax): values padded to ``cp`` with
    -inf, a tree in each group of four, then left to right over the groups; the NaN
    rule only when the padded values sum to NaN (the kernel sums them only in a block
    whose z hold a NaN, an inf or a value that could overflow, so always when a pixel
    holds a NaN)."""
    v = np.full(cp, -np.inf, np.float32)
    v[:len(vals)] = vals
    with np.errstate(invalid="ignore", over="ignore"):
        total = np.float32(0)
        for q in range(cp // 4):
            total = total + ((v[4 * q] + v[4 * q + 1]) + (v[4 * q + 2] + v[4 * q + 3]))
    nan_rule = bool(np.isnan(total))
    best = None
    for q in range(cp // 4):
        x = [(v[4 * q + i], 4 * q + i) for i in range(4)]
        p = _combine(*x[0], *x[1], nan_rule)
        r = _combine(*x[2], *x[3], nan_rule)
        g = _combine(*p, *r, nan_rule)
        best = g if best is None else _combine(*best, *g, nan_rule)
    return best[1]


def _serial_argmax(vals):
    """The first port's scan: strict '>' in ascending order, the first NaN wins."""
    best, arg = vals[0], 0
    for k in range(1, len(vals)):
        if vals[k] > best or (vals[k] != vals[k] and best == best):
            best, arg = vals[k], k
    return arg


@pytest.mark.parametrize("c,cp", [(19, 20), (5, 32), (32, 32)])
def test_tree_argmax_matches_the_serial_scan(c, cp):
    rng = np.random.default_rng(c)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0], np.float32)
    for trial in range(3000):
        vals = rng.integers(-3, 4, c).astype(np.float32)  # many ties
        if trial % 3:
            idx = rng.integers(0, c, int(rng.integers(1, 4)))
            vals[idx] = specials[rng.integers(0, len(specials), len(idx))]
        assert _kernel_argmax(vals, cp) == _serial_argmax(vals), vals
        if not np.isnan(vals).any():
            assert _serial_argmax(vals) == int(np.argmax(vals))
        else:
            assert _serial_argmax(vals) == int(np.flatnonzero(np.isnan(vals))[0])


def _inputs(seed, batch=1):
    rng = np.random.RandomState(seed)
    la = (rng.randn(batch, 9, 17, C) * 3).astype(np.float32)
    lb = (rng.randn(batch, 11, 21, C) * 3).astype(np.float32)
    gt = rng.randint(0, C + 5, (batch, *OUT_HW)).astype(np.int32)
    gt[rng.rand(batch, *OUT_HW) < 0.2] = 255
    return la, lb, gt


def test_plain_version_takes_uint8_and_int32_gt_alike():
    la, lb, gt = (torch.from_numpy(a) for a in _inputs(0, batch=2))
    want = tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW)
    got = tef.multiscale_argmax_hist(la, lb, gt.to(torch.uint8), out_hw=OUT_HW)
    assert torch.equal(got, want) and int(want.sum()) == int(((gt >= 0) & (gt < C)).sum())


def test_out_adds_into_the_running_histogram():
    la, lb, gt = (torch.from_numpy(a) for a in _inputs(1))
    running = torch.from_numpy(np.random.default_rng(1).integers(0, 1000, (C, C))
                               .astype(np.int32))
    want = running + tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW)
    out = running.clone()
    got = tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW, out=out)
    assert got is out and torch.equal(out, want)
    with pytest.raises(ValueError, match="out must be"):
        tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW, out=out.long())


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_plain_row_blocks_add_up_to_the_whole(blocks):
    la, lb, gt = (torch.from_numpy(a) for a in _inputs(2, batch=2))
    whole = tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW)
    rows = OUT_HW[0] // blocks
    parts = [tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW, row_range=(i * rows, rows))
             for i in range(blocks)]
    assert torch.equal(sum(parts), whole)
    assert all(int(p.sum()) == int(((gt[:, i * rows:(i + 1) * rows] >= 0)
                                    & (gt[:, i * rows:(i + 1) * rows] < C)).sum())
               for i, p in enumerate(parts))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, la, lb, gt, queue):
    import torch.distributed as dist

    from simt_tpu_torch.ops.kernels import eval_fused

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        hist = eval_fused.multiscale_argmax_hist_spatial(
            torch.from_numpy(la), torch.from_numpy(lb), torch.from_numpy(gt),
            out_hw=gt.shape[-2:], num_classes=la.shape[-1])
        queue.put((rank, hist.numpy()))
    except Exception as e:  # noqa: BLE001 -- reported to the parent as the result
        queue.put((rank, repr(e)))
    finally:
        dist.destroy_process_group()


def _spatial(world, la, lb, gt, timeout=60.0):
    """multiscale_argmax_hist_spatial over ``world`` gloo ranks, each its own process;
    every rank's histogram."""
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, la, lb, gt, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


@pytest.fixture(scope="module")
def spatial_case():
    """One image (the JAX function's form), its unsharded port histogram and the JAX
    package's multiscale_argmax_hist_spatial on a (data=1, spatial=4) CPU mesh."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import simt_tpu.ops.pallas.eval_fused as ef
    from simt_tpu.parallel import make_mesh

    la, lb, gt = (a[0] for a in _inputs(3))
    orig = pl.pallas_call
    ef.pl.pallas_call = lambda *a, **kw: orig(*a, **dict(kw, interpret=True))
    try:
        jax_hist = np.asarray(ef.multiscale_argmax_hist_spatial(
            jnp.asarray(la), jnp.asarray(lb), jnp.asarray(gt), make_mesh(data=1, spatial=4),
            out_hw=OUT_HW, num_classes=C, chunk_rows=8))
    finally:
        ef.pl.pallas_call = orig
    whole = tef.multiscale_argmax_hist(torch.from_numpy(la), torch.from_numpy(lb),
                                       torch.from_numpy(gt), out_hw=OUT_HW).numpy()
    return la, lb, gt, whole, jax_hist


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_under_gloo_matches_unsharded_and_jax(world, spatial_case):
    la, lb, gt, whole, jax_hist = spatial_case
    for hist in _spatial(world, la, lb, gt):
        assert not isinstance(hist, str), hist
        np.testing.assert_array_equal(hist, whole)  # the row decomposition is exact
        # The same count of valid pixels as JAX; f32 sum-order differences may flip a
        # near-tie argmax (tests/test_torch_eval_fused.py holds the whole image so too).
        assert hist.sum() == jax_hist.sum() == ((gt >= 0) & (gt < C)).sum()
        assert np.abs(hist.astype(np.int64) - jax_hist).sum() <= 2


def test_spatial_refuses_rows_that_do_not_split():
    la, lb, gt = _inputs(4)
    (msg,) = set(_spatial(3, la[0], lb[0], gt[0]))
    assert msg == repr(ValueError("out height 64 not divisible by spatial=3"))


def test_work_counts_gt_at_its_own_width():
    args = (65, 129, 81, 161, (1024, 2048), 19)
    b4, ops4 = tef.work(*args, batch=1, n_counted=1000)
    b1, ops1 = tef.work(*args, batch=1, n_counted=1000, gt_bytes=1)
    assert b4 - b1 == 3 * 1024 * 2048 and ops4 == ops1


def test_fma32_rounds_a_product_and_sum_once():
    from fractions import Fraction

    rng = np.random.default_rng(0)
    n = 3000
    a, b = ((rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(np.float32)
            for _ in range(2))
    c = (rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))).astype(np.float32)
    c[::3] = -(a[::3].astype(np.float64) * b[::3]).astype(np.float32)  # cancellation
    got = bench_eval_fused.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, ai, bi, ci in zip(got, a, b, c):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        err = abs(Fraction(float(x)) - exact)
        for nb in (np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))):
            other = abs(Fraction(float(nb)) - exact)
            assert err < other or (err == other and not x.view(np.int32) & 1), (ai, bi, ci)


@pytest.mark.parametrize("gt_map", ["iid", "regions", "shifted"])
def test_kernel_arithmetic_matches_the_plain_version_and_its_row_blocks(gt_map):
    la, lb, gt = bench_eval_fused.head_inputs(np.random.default_rng(5), hw_a=(9, 17),
                                              hw_b=(11, 21), out_hw=OUT_HW, gt=gt_map,
                                              device="cpu")
    exact = bench_eval_fused.kernel_arithmetic(la, lb, gt, out_hw=OUT_HW, chunk=24)
    plain = tef.multiscale_argmax_hist(la, lb, gt, out_hw=OUT_HW)
    assert exact.sum() == plain.sum() == ((gt >= 0) & (gt < C)).sum()
    assert (exact - plain).abs().sum() <= 2
    parts = [bench_eval_fused.kernel_arithmetic(la, lb, gt, out_hw=OUT_HW,
                                                row_range=(16 * i, 16)) for i in range(4)]
    assert torch.equal(sum(parts), exact)


def test_kernel_arithmetic_takes_the_first_nan():
    la, lb, gt = bench_eval_fused.head_inputs(np.random.default_rng(6), hw_a=(2, 2),
                                              hw_b=(1, 1), out_hw=(2, 2), device="cpu")
    gt[:] = 0
    la[:, :, :, 7] = float("nan")  # every pixel: a NaN at 7, a larger value elsewhere
    la[:, :, :, 3] = float("nan")
    la[:, :, :, 1] = 1e30
    hist = bench_eval_fused.kernel_arithmetic(la, lb, gt, out_hw=(2, 2))
    assert hist[0, 3] == 4 and hist.sum() == 4


def test_gt_maps_are_shaped_as_documented():
    rng = np.random.default_rng(0)
    _, _, iid = bench_eval_fused.head_inputs(rng, out_hw=(256, 512), device="cpu")
    frac = (iid == 255).float().mean()
    assert 0.18 < frac < 0.22 and iid[iid != 255].max() == C + 4
    for name in ("regions", "shifted"):
        _, _, g = bench_eval_fused.head_inputs(np.random.default_rng(0), gt=name,
                                               out_hw=(256, 512), device="cpu")
        g = g[0].numpy()
        edges = np.flatnonzero((g[:, 1:] != g[:, :-1]).any(0)) + 1  # columns a cell starts
        assert len(edges) and g.max() == 255 and g[g != 255].max() < C
        if name == "regions":
            assert (edges % bench_eval_fused.CELL == 0).all()
        else:  # off the warps' 32 columns
            assert (edges % 32 != 0).all() and len(set(edges % bench_eval_fused.CELL)) == 1


def test_bench_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench_eval_fused.main(["--kernels"])
