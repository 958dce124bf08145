"""The host side of the fused bottleneck's wgmma kernels (B6/B7,
simt_tpu_torch/ops/kernels/bottleneck.py), pure Python, no card:

  - ``schedule``: each GEMM's tile (``fwd_tiles``) covers every output element and its
    K loop every (tap, k) exactly once; each weight gradient's tiles and splits
    (``wgrad_tiles`` with taps 1 or 9, C != O) cover every (tap, c, o, pixel) exactly
    once; both fill whole waves of 132 SMs at the four trunk geometries;
  - the variant routing: every trunk geometry to the wgmma kernels, channel counts off
    the 8-element vector width and unaligned tensors to the first port's;
  - the wrappers count their calls by variant;
  - the C interface's schedule arguments, in the order ``csrc/bottleneck.cu`` reads;
  - the kernel build is named by the sources and the headers they include, so an
    edited ``csrc/*.cuh`` rebuilds.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from simt_tpu_torch.ops.kernels import _build
from simt_tpu_torch.ops.kernels import bottleneck as k
from simt_tpu_torch.ops.kernels import conv3x3

# (H, W, Ct, P) of the trunk's identity blocks at a 512x1024 crop, and the edge cases
# of chip_smoke.py (BNECK, BNECK_EDGE).
TRUNK = ((129, 257, 256, 64), (65, 129, 512, 128), (65, 129, 1024, 256),
         (65, 129, 2048, 512))
EDGE = ((9, 13, 64, 16), (3, 5, 32, 8), (9, 11, 36, 9))
SMS = 132


def _gemm_cover(pixels, taps, kk, n, t):
    """How often each output element (pixel, channel) falls in a tile of the grid, and
    each (tap, k) in a K-loop stage of the kernel's producer."""
    out = np.zeros((pixels, n), np.int32)
    for mt in range(t.m_tiles):
        for nt in range(t.n_tiles):
            out[mt * conv3x3.FWD_BM:(mt + 1) * conv3x3.FWD_BM, nt * t.bn:(nt + 1) * t.bn] += 1
    kchunks = -(-kk // 64)
    red = np.zeros((taps, kk), np.int32)
    for it in range(taps * kchunks):
        tap, c0 = it // kchunks, (it % kchunks) * 64
        red[tap, c0:c0 + 64] += 1
    return out, red


@pytest.mark.parametrize("h,w,ct,p", TRUNK + EDGE)
def test_gemm_tiles_cover_every_output_and_reduction_once(h, w, ct, p):
    sched = k.schedule(h * w, ct, p)
    for name, (taps, kk, n) in k.gemm_shapes(ct, p).items():
        t = sched.gemms[name]
        out, red = _gemm_cover(h * w, taps, kk, n, t)
        assert (out == 1).all() and (red == 1).all(), name
        assert t.bn in conv3x3.FWD_BN


def _wgrad_items(pixels, taps, c, o, t):
    """The weight-gradient kernel's grid in launch order: (tap, c range, o range, pixel
    range) of each (split, tile, tap) work item."""
    for tap in range(taps):
        for tile in range(t.c_tiles * t.o_tiles):
            ct, ot = tile % t.c_tiles, tile // t.c_tiles
            for s in range(t.splits):
                yield (tap, (ct * t.bc, min(c, (ct + 1) * t.bc)),
                       (ot * t.bo, min(o, (ot + 1) * t.bo)),
                       (s * t.per_split, min(pixels, (s + 1) * t.per_split)))


@pytest.mark.parametrize("h,w,ct,p", TRUNK[:3] + EDGE[:2] + ((11, 23, 1024, 256),))
def test_wgrad_tiles_cover_every_tap_channel_pair_and_pixel_once(h, w, ct, p):
    pixels = h * w
    sched = k.schedule(pixels, ct, p)
    for name, (taps, c, o) in k.wgrad_shapes(ct, p).items():
        t = sched.wgrads[name]
        assert t.taps == taps and t.per_split % conv3x3.WGRAD_PIX == 0
        cover = np.zeros((taps, c, o), np.int64)
        pix = {}
        for tap, (c0, c1), (o0, o1), (p0, p1) in _wgrad_items(pixels, taps, c, o, t):
            assert p0 < p1  # no empty split
            cover[tap, c0:c1, o0:o1] += p1 - p0
            pix.setdefault((tap, c0, o0), np.zeros(pixels, np.int32))[p0:p1] += 1
        assert (cover == pixels).all(), name
        assert all((v == 1).all() for v in pix.values()), name
        assert t.items == len(list(_wgrad_items(pixels, taps, c, o, t)))


@pytest.mark.parametrize("h,w,ct,p", TRUNK)
def test_schedules_fill_whole_waves_at_the_trunk(h, w, ct, p):
    sched = k.schedule(h * w, ct, p)
    for name, t in sched.gemms.items():
        if h * w <= 66 * conv3x3.FWD_BM:  # layers 2-4: 66 pixel tiles, whole waves
            assert t.tiles % SMS == 0, (name, t)
        else:  # layer1: 260 pixel tiles, two waves less four blocks
            assert t.tiles / (t.waves * SMS) >= 0.98, (name, t)
    for name, t in sched.wgrads.items():
        want = 2 if (name == "dw2" and p == 512) else 1  # layer4's 3x3, as B5 there
        assert t.waves == want, (name, t)


def test_layer3_schedule():
    # 65x129, Ct 1024, P 256: conv1 and conv2 128x128 tiles, 132 blocks; conv3 128x256,
    # 264 blocks in two waves.
    sched = k.schedule(65 * 129, 1024, 256)
    assert [sched.gemms[g].bn for g in ("conv1", "conv2", "conv3")] == [128, 128, 256]
    assert [sched.gemms[g].tiles for g in ("conv1", "conv2", "conv3")] == [132, 132, 264]
    assert sched.gemms["outraw"] == sched.gemms["conv3"] == sched.gemms["dx"]
    assert sched.gemms["dh2"] == sched.gemms["dh1"] == sched.gemms["conv1"]


def test_schedule_fixed_by_the_shapes():
    a = k.schedule(65 * 129, 1024, 256)
    assert a == k.schedule(65 * 129, 1024, 256)
    assert a.wgrads["dw2"] == conv3x3.wgrad_tiles(65 * 129, 256, 256)  # B5's at layer3
    assert k.schedule(130 * 129, 512, 128) == k.schedule(65 * 258, 512, 128)


def test_schedule_args_in_the_c_order():
    sched = k.schedule(65 * 129, 1024, 256)
    assert sched.fwd_args() == [sched.gemms[g].bn for g in ("conv1", "conv2", "conv3")]
    args = sched.bwd_args()
    assert args[:4] == [sched.gemms[g].bn for g in ("outraw", "dh2", "dh1", "dx")]
    for i, name in enumerate(("dw1", "dw2", "dw3")):
        t = sched.wgrads[name]
        assert args[4 + 4 * i:8 + 4 * i] == [t.bc, t.bo, t.splits, t.per_split]
    assert sched.tickets() == max([t.n_tiles for t in sched.gemms.values()]
                                  + [t.tiles for t in sched.wgrads.values()])
    assert sched.tickets() <= 4096  # conv3x3._tickets' smallest buffer


def _cl(c, h=5, w=7):
    return torch.zeros((1, c, h, w), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("h,w,ct,p", TRUNK)
def test_variant_sends_every_trunk_geometry_to_wgmma(h, w, ct, p):
    assert k.variant(ct, p, (_cl(ct), _cl(p), _cl(p))) == "wgmma"


@pytest.mark.parametrize("h,w,ct,p", EDGE)
def test_variant_of_the_edge_cases(h, w, ct, p):
    want = "wgmma" if ct % 8 == 0 and p % 8 == 0 else "wmma"
    assert k.variant(ct, p, (_cl(ct, h, w), _cl(p, h, w))) == want


def test_variant_unaligned_takes_the_first_port():
    base = torch.zeros(1 + 5 * 7 * 64, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 5, 7, 64).permute(0, 3, 1, 2)  # one element off 16 bytes
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert k.variant(64, 16, (shifted, _cl(16))) == "wmma"
    assert k.variant(64, 16, (_cl(64), _cl(16))) == "wgmma"


def test_wrappers_count_calls_by_variant():
    for fn in (k.bottleneck_fwd, k.bottleneck_bwd):
        assert set(fn.variants) == {"wgmma", "wmma"}
    gen = torch.Generator().manual_seed(0)
    ct, p = 16, 4
    x = torch.randn(1, ct, 5, 6, generator=gen).to(torch.bfloat16)
    ws = [torch.randn(s, generator=gen) * 0.1
          for s in ((p, ct, 1, 1), (p, p, 3, 3), (ct, p, 1, 1))]
    vecs = [torch.ones(n) for n in (p, p, p, p, ct, ct)]
    before = [(dict(fn.variants), fn.launches) for fn in (k.bottleneck_fwd, k.bottleneck_bwd)]
    out, h1, h2, sp, st = k.bottleneck_fwd(x, *ws, *vecs, 1)  # the CPU: plain versions
    k.bottleneck_bwd(out, x, *ws, *vecs, h1, h2, sp, st, 1)
    after = [(dict(fn.variants), fn.launches) for fn in (k.bottleneck_fwd, k.bottleneck_bwd)]
    assert after == before


def test_build_path_follows_the_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert "hopper.cuh" in headers
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}  # stable
    with open(csrc / "hopper.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    with open(csrc / "bottleneck.cu", "ab") as f:
        f.write(b"\n")
    again = {n: _build.library_path(n) for n in _build.SOURCES}
    assert again["bottleneck"] != after["bottleneck"]
    assert all(again[n] == after[n] for n in _build.SOURCES if n != "bottleneck")


SHARED = ("mbar_wait", "tma_load_2d", "gmma_desc", "wgmma_n256", "finish_split_tile",
          "wgrad_wgmma", "make_map", "pixel_map")


def _defined(text):
    """Names of SHARED that a definition line in ``text`` introduces."""
    return {n for line in text.splitlines() for n in SHARED
            if line.startswith(("__device__", "int ", "void ")) and f" {n}(" in line}


@pytest.mark.parametrize("source", ["conv3x3.cu", "bottleneck.cu"])
def test_both_wgmma_sources_include_the_shared_header(source):
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        text = f.read()
    assert '#include "hopper.cuh"' in text
    assert not _defined(text)  # moved, not copied
    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f:
        assert _defined(f.read()) == set(SHARED)


def test_work_is_unchanged_by_the_schedule():
    # The bound counts the function's work, whatever the tiles.
    nbytes, ops = k.work(65, 129, 1024, 256, "fwd")
    assert ops == 2 * 65 * 129 * (2 * 1024 * 256 + 9 * 256 * 256)
    assert math.isclose(k.work(65, 129, 1024, 256, "bwd")[1] / 1e9, 41.8, abs_tol=0.05)
