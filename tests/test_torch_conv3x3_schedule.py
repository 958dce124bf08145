"""The host side of the trunk conv's wgmma kernels (simt_tpu_torch/ops/kernels/conv3x3.py),
pure Python, no card:

  - B4's tile chooser (``fwd_tiles``): one wave of 132 tiles at layers 2-4 of a
    512x1024 crop, and every output element in exactly one tile, ragged edges too;
  - B5's schedule (``wgrad_tiles``): every (tap, C tile, O tile) and every pixel in
    exactly one work item, splits of whole 64-pixel stages in a fixed order that the
    shapes alone determine;
  - the variant dispatch: bf16 at every trunk geometry of both eval scales to the wgmma
    kernels; float32, off-vector channel counts and unaligned tensors to the first
    port's kernels;
  - the wgmma kernel's weight packing holds the same taps as the first port's;
  - B5's ticket buffers, one per device and stream;
  - the timing tool's cuDNN yardsticks compute the functions of the calls they stand
    beside.
"""

import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.kernels import conv3x3 as k

# (H, W, channels) of the trunk's four stages at the 512x1024 crop and at the eval
# path's 640x1280 scale.
TRUNK_512 = ((129, 257, 64), (65, 129, 128), (65, 129, 256), (65, 129, 512))
TRUNK_640 = ((161, 321, 64), (81, 161, 128), (81, 161, 256), (81, 161, 512))


@pytest.mark.parametrize("h,w,n", TRUNK_512[1:])
def test_fwd_tiles_one_wave_at_layers_2_to_4(h, w, n):
    t = k.fwd_tiles(h * w, n)
    assert (t.bn, t.tiles, t.waves) == (n // 2, 132, 1)


def test_fwd_tiles_layer1_and_eval_scale():
    t = k.fwd_tiles(129 * 257, 64)
    assert (t.bn, t.m_tiles, t.tiles) == (64, 260, 260)
    for h, w, n in TRUNK_640:
        t = k.fwd_tiles(h * w, n)
        assert t.bn in k.FWD_BN and t.bn <= max(64, n)
        assert t.m_tiles == -(-h * w // k.FWD_BM) and t.n_tiles == -(-n // t.bn)


def _fwd_cover(pixels, n):
    """How often each output element (pixel, channel) falls in a tile of the grid."""
    t = k.fwd_tiles(pixels, n)
    count = np.zeros((pixels, n), np.int32)
    for mt in range(t.m_tiles):
        for nt in range(t.n_tiles):
            count[mt * k.FWD_BM:(mt + 1) * k.FWD_BM, nt * t.bn:(nt + 1) * t.bn] += 1
    return count


@pytest.mark.parametrize("pixels,n", [(8385, 16), (8385, 136), (130, 40), (1, 8),
                                      (128 * 3, 256), (257, 520)])
def test_fwd_tiles_cover_every_output_once(pixels, n):
    assert (_fwd_cover(pixels, n) == 1).all()


@pytest.mark.parametrize("h,w,n", TRUNK_512 + TRUNK_640)
def test_fwd_tiles_cover_the_trunk(h, w, n):
    t = k.fwd_tiles(h * w, n)
    assert (t.m_tiles - 1) * k.FWD_BM < h * w <= t.m_tiles * k.FWD_BM
    assert (t.n_tiles - 1) * t.bn < n <= t.n_tiles * t.bn


def _wgrad_items(pixels, c, o):
    """The work items of the kernel's grid in launch order: (split, c tile, o tile, tap)
    with their pixel, C and O ranges."""
    t = k.wgrad_tiles(pixels, c, o)
    for tap in range(9):
        for tile in range(t.c_tiles * t.o_tiles):
            ct, ot = tile % t.c_tiles, tile // t.c_tiles
            for s in range(t.splits):
                yield (tap, (ct * t.bc, min(c, (ct + 1) * t.bc)),
                       (ot * t.bo, min(o, (ot + 1) * t.bo)),
                       (s * t.per_split, min(pixels, (s + 1) * t.per_split)))


@pytest.mark.parametrize("pixels,c,o", [(99, 72, 40), (15, 8, 16), (377, 64, 64),
                                        (1000, 136, 264), (4097, 256, 128)])
def test_wgrad_tiles_cover_every_tap_tile_and_pixel_once(pixels, c, o):
    # Pixels summed into each (tap, c, o), and each tile's pixels: together, every
    # (tap, c, o, pixel) exactly once.
    cover = np.zeros((9, c, o), np.int64)
    pix = {}
    for tap, (c0, c1), (o0, o1), (p0, p1) in _wgrad_items(pixels, c, o):
        assert p0 < p1  # no empty split
        cover[tap, c0:c1, o0:o1] += p1 - p0
        pix.setdefault((tap, c0, o0), np.zeros(pixels, np.int32))[p0:p1] += 1
    assert (cover == pixels).all()
    assert all((v == 1).all() for v in pix.values())


@pytest.mark.parametrize("h,w,c", TRUNK_512 + TRUNK_640)
def test_wgrad_tiles_at_the_trunk(h, w, c):
    pixels = h * w
    t = k.wgrad_tiles(pixels, c, c)
    assert (t.bc, t.bo) in k.WGRAD_TILES and t.bc == (64 if c <= 64 else 128)
    assert t.per_split % k.WGRAD_PIX == 0
    assert (t.splits - 1) * t.per_split < pixels <= t.splits * t.per_split
    assert t.c_tiles * t.bc >= c > (t.c_tiles - 1) * t.bc
    assert t.o_tiles * t.bo >= c > (t.o_tiles - 1) * t.bo
    assert t.items == 9 * t.c_tiles * t.o_tiles * t.splits and t.waves >= 1


def test_wgrad_tiles_fixed_by_the_shapes():
    """The split (and so the order of the sum over splits) depends on the shapes alone:
    the same for batch 2 as for one image of twice the pixels, and ranges ascending."""
    a = k.wgrad_tiles(2 * 65 * 129, 256, 256)
    assert a == k.wgrad_tiles(2 * 65 * 129, 256, 256) == k.wgrad_tiles(130 * 129, 256, 256)
    ranges = sorted({p for *_, p in _wgrad_items(1000, 136, 264)})
    assert ranges[0][0] == 0 and ranges[-1][1] == 1000
    assert all(r[1] == n[0] for r, n in zip(ranges, ranges[1:]))


def _cl(shape, dtype):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("h,w,c", TRUNK_512 + TRUNK_640)
def test_variant_sends_trunk_bf16_to_wgmma(h, w, c):
    x = _cl((1, c, h, w), torch.bfloat16)
    y = _cl((1, c, h, w), torch.bfloat16)
    assert k.variant(torch.bfloat16, (c, c), (x, y)) == "wgmma"
    xf = _cl((1, c, h, w), torch.float32)
    assert k.variant(torch.float32, (c, c), (xf, xf)) == "fma"


def test_variant_off_the_vector_width_and_unaligned():
    x = _cl((2, 3, 13, 10), torch.bfloat16)
    y = _cl((2, 5, 13, 10), torch.bfloat16)
    assert k.variant(torch.bfloat16, (3, 5), (x, y)) == "wmma"
    x36 = _cl((1, 36, 9, 11), torch.bfloat16)
    assert k.variant(torch.bfloat16, (36, 16), (x36,)) == "wmma"
    base = torch.zeros(1 + 9 * 11 * 16, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 9, 11, 16).permute(0, 3, 1, 2)  # one element off 16 bytes
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert shifted.data_ptr() % 16 != 0
    assert k.variant(torch.bfloat16, (16, 16), (shifted,)) == "wmma"
    aligned = _cl((1, 16, 9, 11), torch.bfloat16)
    assert k.variant(torch.bfloat16, (16, 16), (aligned,)) == "wgmma"


@pytest.mark.parametrize("flip", [False, True])
def test_gemm_weights_hold_the_tap_matrices(flip):
    """The wgmma kernel's packing holds the first port's tap matrices; for dx its taps
    are read in reverse (tap t from row tap 8 - t), as the kernel does."""
    w = torch.randn(6, 4, 3, 3)
    taps = k.tap_weights(w, flip)  # (3, 3, Ck, N)
    rows = k.gemm_weights(w, flip)  # (N, 3, 3, Ck)
    assert rows.is_contiguous() and rows.shape == (taps.shape[3], 3, 3, taps.shape[2])
    want = taps.permute(3, 0, 1, 2)
    assert torch.equal(rows.flip(1, 2) if flip else rows, want)


def test_wrappers_count_launches_by_variant():
    for fn in (k.conv3x3_fwd, k.conv3x3_wgrad):
        assert set(fn.variants) == {"wgmma", "wmma", "fma"}
    x = torch.randn(1, 4, 5, 6)
    before = dict(k.conv3x3_fwd.variants), k.conv3x3_fwd.launches
    k.conv3x3_fwd(x, torch.randn(4, 4, 3, 3), 1)  # the CPU runs the plain version
    assert (dict(k.conv3x3_fwd.variants), k.conv3x3_fwd.launches) == before


def test_fwd_tiles_take_the_widest_tile_that_keeps_the_waves():
    # The eval scale's layer4 (102 pixel tiles, N 512): 204 tiles of 256 in two waves
    # beat 816 of 64 in seven; layer3 at 512x1024: one wave of 128-wide tiles beats two
    # of 64 and half a wave of 256.
    assert k.fwd_tiles(81 * 161, 512).bn == 256
    assert k.fwd_tiles(65 * 129, 256).bn == 128


def test_bench_tool_needs_a_card():
    from simt_tpu_torch.tools import bench_conv3x3

    with pytest.raises(SystemExit, match="CUDA"):
        bench_conv3x3.main(["--iters", "1"])


def test_tickets_one_buffer_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(k, "_TICKETS", {})
    cpu = torch.device("cpu")
    a = k._tickets(cpu, 11, 10)
    assert k._tickets(cpu, 11, 10) is a and not a.any()
    assert k._tickets(cpu, 12, 10) is not a  # another stream, another buffer
    assert k._tickets(cpu, 11, a.numel() + 1).numel() > a.numel()


@pytest.mark.parametrize("d", [1, 2])
def test_bench_calls_compute_the_same_function(d):
    """Each of the bench tool's cuDNN yardsticks computes what its wrapper call does
    (here both on the CPU: the plain version against aten's convolution)."""
    from simt_tpu_torch.tools import bench_conv3x3

    gen = torch.Generator().manual_seed(d)
    x = torch.randn(1, 8, 7, 9, generator=gen, dtype=torch.float64)
    wt = torch.randn(8, 8, 3, 3, generator=gen, dtype=torch.float64)
    g = torch.randn(1, 8, 7, 9, generator=gen, dtype=torch.float64)
    calls = bench_conv3x3.conv_calls(k, x, wt, g, d)
    assert set(calls) == {"fwd", "dx", "wgrad"}
    for op, (mine, lib) in calls.items():
        want = lib()
        want = want if op == "fwd" else want[0 if op == "dx" else 1]
        torch.testing.assert_close(mine().double(), want, rtol=1e-5, atol=1e-5)
