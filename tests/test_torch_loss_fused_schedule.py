"""The host side of the loss core's kernels B2/B3 (simt_tpu_torch/ops/kernels/
loss_fused.py), on the CPU: the band/segment schedule both kernels walk, and numpy
models of what B3 does with it (its fixed-order finish of the dxcat partials and its
label-grouped dT reduction), held to the plain backward. Pure Python and the plain
versions: the kernels themselves run only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.interp import interp_taps
from simt_tpu_torch.ops.kernels import loss_fused as lf
from simt_tpu_torch.tools import bench_loss_fused

# (batch, h8, w8, H, W): the main path's, an edge shape, the main path at batch 2.
SHAPES = [(1, 65, 129, 512, 1024), (2, 6, 39, 37, 301), (2, 65, 129, 512, 1024)]
# Larger batches, at the main path's scale and at the eval's 1024x2048.
LARGE = [(16, 65, 129, 512, 1024), (64, 65, 129, 512, 1024), (4, 129, 257, 1024, 2048)]
C, CAT = 19, 68


@pytest.mark.parametrize("shape", SHAPES + LARGE[:1] + LARGE[2:],
                         ids=["main", "edge_37x301", "batch2", "batch16", "batch4_1024"])
def test_schedule_covers_every_output_once(shape):
    batch, h8, w8, hh, ww = shape
    s = lf.schedule(batch, h8, w8, hh, ww, CAT, C)
    lo_h, hi_h, _, _ = interp_taps(h8, hh)
    lo_w, hi_w, _, _ = interp_taps(w8, ww)
    hits = np.zeros((batch, hh, ww), np.int32)
    part = 0
    for b, r0, r1, c0, c1, jlo, jhi, i0, i1, off in s.blocks:
        assert 0 < c1 - c0 <= lf.PASS_PIXELS and r1 > r0
        hits[b, r0:r1, c0:c1] += 1
        # The source rows and columns the block reads, and its partial's place.
        assert (i0, i1) == (lo_h[r0:r1].min(), hi_h[r0:r1].max())
        assert (jlo, jhi) == (lo_w[c0:c1].min(), hi_w[c0:c1].max())
        assert off == part
        part += (i1 - i0 + 1) * (jhi - jlo + 1) * CAT
    assert (hits == 1).all()
    assert s.part_floats == part
    assert s.jmax == (s.blocks[:, 6] - s.blocks[:, 5]).max() + 1
    assert s.kmax == (s.blocks[:, 8] - s.blocks[:, 7]).max() + 1
    assert s.maxc == np.diff(s.row_off).max()


@pytest.mark.parametrize("shape", SHAPES, ids=["main", "edge_37x301", "batch2"])
def test_schedule_lists_each_source_rows_bands_in_ascending_order(shape):
    batch, h8, w8, hh, ww = shape
    s = lf.schedule(batch, h8, w8, hh, ww, CAT, C)
    assert len(s.row_off) == batch * h8 + 1 and s.row_off[0] == 0
    for b in range(batch):
        for i in range(h8):
            row = b * h8 + i
            got = list(s.row_blk[s.row_off[row]:s.row_off[row + 1]])
            want = [n for n, blk in enumerate(s.blocks)
                    if blk[0] == b and blk[7] <= i <= blk[8]]
            assert got == want and got == sorted(got)
            assert got, "every source row is read at these shapes"


def test_schedule_fills_whole_waves_and_two_blocks_fit_an_sm():
    s = lf.schedule(1, 65, 129, 512, 1024, CAT, C)
    assert s.n_blocks == lf.NUM_SMS * lf.BLOCKS_PER_SM == 264
    assert s.n_blocks % lf.NUM_SMS == 0
    # 8 segments of 128 columns, 33 bands of 15-16 rows, each reading at most 4 source
    # rows and 17 source columns.
    assert sorted(set(s.blocks[:, 4] - s.blocks[:, 3])) == [128]
    assert sorted(set(s.blocks[:, 2] - s.blocks[:, 1])) == [15, 16]
    assert (s.kmax, s.jmax) == (4, 17)
    # Two blocks' shared memory and their reserved 1 KB each fit the SM's 228 KB.
    assert 2 * (lf.bwd_smem_bytes(s, 129, 34, 19) + 1024) <= 228 * 1024
    assert s.n_groups == 17
    # A pure function of the shapes: the same object for the same arguments.
    assert lf.schedule(1, 65, 129, 512, 1024, CAT, C) is s


@pytest.mark.parametrize("shape", [(14,) + SHAPES[0][1:]] + LARGE,
                         ids=["batch14", "batch16", "batch64", "batch4_1024"])
def test_schedule_of_a_large_batch_fits_shared_memory(shape):
    """A larger batch gets more bands of fewer rows, not taller ones: B3's block (its
    band's accumulator grows with the source rows it reads) stays within what a block
    can take, and two fit an SM at 512x1024 as at batch 1."""
    batch, h8, w8, hh, ww = shape
    s = lf.schedule(batch, h8, w8, hh, ww, CAT, C)
    smem = lf.bwd_smem_bytes(s, w8, CAT // 2, C)
    assert smem <= lf._MAX_SMEM
    if (hh, ww) == (512, 1024):
        assert 2 * (smem + 1024) <= 228 * 1024
        assert s.n_blocks >= lf.NUM_SMS * lf.BLOCKS_PER_SM
    assert s.n_blocks % batch == 0 and len(s.row_off) == batch * h8 + 1


def test_schedule_of_more_source_rows_than_output_rows_leaves_rows_unread():
    """Downsampling (H < h8) reads some source rows from no output row: the schedule
    lists no block for them, and B3's block 0 writes their dxcat as 0."""
    s = lf.schedule(1, 9, 13, 4, 6, 16, 5)
    counts = np.diff(s.row_off)
    assert (counts == 0).any() and (counts > 0).any()


def _core_inputs(seed, b, c, o, h8, w8, hh, ww, labels):
    x1, x2, tp8, label, t1, t2 = _fixture(seed, b, c, o, h8, w8, hh, ww, labels)
    from simt_tpu_torch.ops.fused_losses import teacher_conf
    conf = teacher_conf(torch.from_numpy(tp8), (hh, ww), num_classes=c,
                        threshold_high=0.7, threshold_low=0.3)
    xcat = torch.from_numpy(np.concatenate([x1, x2], -1))
    return xcat, torch.from_numpy(label), conf, torch.from_numpy(t1), torch.from_numpy(t2)


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _fixture(seed, b, c, o, h8, w8, hh, ww, labels):
    rng = np.random.RandomState(seed)
    total = c + o
    x1 = (rng.randn(b, h8, w8, total) * 2).astype(np.float32)
    x2 = (rng.randn(b, h8, w8, total) * 2).astype(np.float32)
    tp8 = _softmax(rng.randn(b, h8, w8, c).astype(np.float32) * 3)
    if labels == "regions":
        cells = rng.randint(0, c, (b, -(-hh // 16), -(-ww // 16))).astype(np.int32)
        cells[rng.rand(*cells.shape) < 0.1] = 255
        label = np.repeat(np.repeat(cells, 16, 1), 16, 2)[:, :hh, :ww].copy()
    else:
        label = rng.randint(0, c, (b, hh, ww)).astype(np.int32)
        label[rng.rand(b, hh, ww) < 0.1] = 255
    t1, t2 = (_softmax(rng.randn(total, c).astype(np.float32)) for _ in range(2))
    return x1, x2, tp8, label, t1, t2


def _model_bwd(g, xcat, label, conf, t1, t2, c, th):
    """B3 in numpy on the plain per-pixel cotangents: each block of the schedule
    accumulates its rows' transposed W taps, weighted by their H taps, into its source
    rows' partial, and its pixels' sm * dq into the dT of their warp of 16 pixels at
    their label's column, in lane order (the kernel's order where a warp's labels
    differ; where a head's 16 lanes share one, it sums them by a reduce-scatter first);
    each source row is the sum of its
    blocks' partials in ascending order; dT the warps', then the blocks' in groups of
    DT_GROUP, then the groups' sums, in order."""
    b, h8, w8, cat = xcat.shape
    hh, ww = label.shape[1:]
    total = cat // 2
    taps = lf._taps(h8, w8, hh, ww, "cpu")
    dp, terms = lf._chunk_cotangents(g, xcat, label, conf, t1, t2, taps, 0, hh, c, th,
                                     255)
    dp = dp.numpy()
    smdq = [t[0].numpy() for t in terms]
    ylab, has_y = terms[0][1].numpy(), terms[0][2].numpy()
    lo_h, hi_h, w0_h, w1_h = interp_taps(h8, hh)
    lo_w, hi_w, w0_w, w1_w = interp_taps(w8, ww)
    s = lf.schedule(b, h8, w8, hh, ww, cat, c)
    part = np.zeros(s.part_floats, np.float32)
    dt_part = np.zeros((s.n_blocks, 2, total, c), np.float32)
    for n, (bi, r0, r1, c0, c1, jlo, jhi, i0, i1, off) in enumerate(s.blocks):
        nj, nk = jhi - jlo + 1, i1 - i0 + 1
        wt = np.zeros((c1 - c0, nj), np.float32)  # the transposed W taps of the segment
        for cc in range(c0, c1):
            wt[cc - c0, lo_w[cc] - jlo] += w0_w[cc]
            wt[cc - c0, hi_w[cc] - jlo] += w1_w[cc]
        acc = np.zeros((nk, nj, cat), np.float32)
        warps = np.zeros((lf.BLOCK_THREADS // 32, 2, total, c), np.float32)
        for r in range(r0, r1):
            v = wt.T @ dp[bi, r, c0:c1]
            acc[lo_h[r] - i0] += w0_h[r] * v
            acc[hi_h[r] - i0] += w1_h[r] * v
            for w in range((c1 - c0 + 15) // 16):
                cols = range(c0 + 16 * w, min(c0 + 16 * w + 16, c1))
                for hd in range(2):
                    for cc in cols:  # lane order
                        if has_y[bi, r, cc]:
                            warps[w, hd, :, ylab[bi, r, cc]] += smdq[hd][bi, r, cc]
        part[off:off + acc.size] = acc.ravel()
        for w in range(len(warps)):
            dt_part[n] += warps[w]
    dx = np.zeros((b, h8, w8, cat), np.float32)
    for bi in range(b):
        for i in range(h8):
            row = bi * h8 + i
            for n in s.row_blk[s.row_off[row]:s.row_off[row + 1]]:
                _, _, _, _, _, jlo, jhi, i0, i1, off = s.blocks[n]
                nj = jhi - jlo + 1
                blk = part[off:off + (i1 - i0 + 1) * nj * cat].reshape(-1, nj, cat)
                dx[bi, i, jlo:jhi + 1] += blk[i - i0]
    groups = [dt_part[k:k + lf.DT_GROUP].sum(0) for k in range(0, s.n_blocks, lf.DT_GROUP)]
    dt = np.zeros_like(groups[0])
    for grp in groups:
        dt += grp
    return dx, dt[0], dt[1]


# Small shapes: one-row bands of one segment; bands of several rows in three segments.
MODEL_SHAPES = [(2, 9, 13, 40, 72), (1, 9, 13, 200, 300)]


@pytest.mark.parametrize("labels", ["iid", "regions"])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=["rows", "bands"])
def test_model_of_b3_equals_the_plain_backward(shape, labels):
    """dxcat within 1e-5 and dT within 1e-4 of their max: chip_smoke.py's limits for
    the kernel against the same plain version."""
    b, h8, w8, hh, ww = shape
    c, o = 5, 3
    xcat, label, conf, t1, t2 = _core_inputs(20, b, c, o, h8, w8, hh, ww, labels)
    g = torch.from_numpy(np.random.RandomState(21).randn(2, 8).astype(np.float32))
    want = lf.loss_core_bwd_reference(g, xcat, label, conf, t1, t2, num_classes=c,
                                      threshold_high=0.7)
    got = _model_bwd(g, xcat, label, conf, t1, t2, c, 0.7)
    for name, a, w, tol in zip(("dxcat", "dt1", "dt2"), got, want, (1e-5, 1e-4, 1e-4)):
        w = w.numpy()
        assert np.abs(a - w).max() <= tol * np.abs(w).max(), name


def test_plain_forward_is_exact_across_chunk_rows():
    """B2's plain version: counts, anchors and presence equal whatever the streaming
    chunk (the kernel is held to them exactly); sums to float32 summation order."""
    c, o = 5, 3
    xcat, label, conf, t1, t2 = _core_inputs(22, 2, c, o, 9, 13, 40, 72, "regions")
    kw = dict(num_classes=c, threshold_high=0.7)
    a = lf.loss_core_fwd_reference(xcat, label, conf, t1, t2, chunk_rows=7, **kw)
    b = lf.loss_core_fwd_reference(xcat, label, conf, t1, t2, chunk_rows=64, **kw)
    assert torch.equal(a[0][:, 1::2], b[0][:, 1::2])
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-5, atol=1e-5)


def test_regions_label_map_is_constant_over_cells():
    rng = np.random.default_rng(0)
    _, label, conf, _, _ = bench_loss_fused.loss_inputs(rng, 1, 9, 13, 40, 72,
                                                        labels="regions", device="cpu")
    lab = label.numpy()[0]
    for r in range(0, 40, 16):
        for q in range(0, 72, 16):
            cell = lab[r:r + 16, q:q + 16]
            assert (cell == cell[0, 0]).all()
    assert conf.dtype == torch.uint8 and conf.shape == label.shape
    with pytest.raises(ValueError):
        bench_loss_fused.loss_inputs(rng, 1, 9, 13, 40, 72, labels="stripes",
                                     device="cpu")


def test_shifted_label_map_puts_a_cell_edge_inside_every_warp():
    """``shifted``: 16x16 cells whose grid starts 1-15 pixels off the warps' 16-column
    segments, so every segment of a row crosses one cell edge."""
    rng = np.random.default_rng(0)
    _, label, _, _, _ = bench_loss_fused.loss_inputs(rng, 2, 9, 13, 64, 96,
                                                     labels="shifted", device="cpu")
    lab = label.numpy()
    cols = np.nonzero((lab[:, :, 1:] != lab[:, :, :-1]).any((0, 1)))[0] + 1
    rows = np.nonzero((lab[:, 1:] != lab[:, :-1]).any((0, 2)))[0] + 1
    for edges in (cols, rows):  # the cell edges: one phase, never a multiple of 16
        assert len(edges) and len(set(edges % 16)) == 1 and edges[0] % 16 != 0
        assert (np.diff(edges) % 16 == 0).all()


def test_bench_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench_loss_fused.main(["--kernels"])
