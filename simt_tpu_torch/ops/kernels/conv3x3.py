"""Stride-1 SAME dilated 3x3 convolution: CUDA kernel wrappers (B4, B5) and their plain
PyTorch versions.

Counterpart of ``experiments/pallas_alternates/conv3x3.py`` (the Pallas form of
``simt_tpu/ops/conv.py::dilated_conv3x3_taps``, the conv2 of every bottleneck):

  - ``conv3x3_fwd(x, w, d)`` (B4): y = conv(x, w), padding ``d``, dilation ``d``, no
    bias. With ``flip=True`` it computes the input gradient instead: the same conv of
    the cotangent with the spatially flipped, io-transposed kernel (stride-1 SAME
    dilated conv is its own transpose up to that flip);
  - ``conv3x3_wgrad(x, g, d)`` (B5): the weight gradient
    ``dw[o, c, kh, kw] = sum_pix x_shift(kh, kw)[c] * g[o]``, float32.

Tensors are NCHW (``x`` (B, Ck, H, W), ``w`` the OIHW parameter (O, C, 3, 3)); the
kernels read them as NHWC, so on a CUDA device they must be ``channels_last``. The
operands share one dtype (bfloat16 or float32), accumulation is float32 and ``y`` is
rounded once to the operands' dtype, as ``dot_general(preferred_element_type=f32)``
followed by ``astype`` in the JAX package.

Both wrappers dispatch on the tensors' device: on the CPU they run ``conv3x3_taps`` /
``wgrad_taps`` (nine shifted-slice matmuls in float32, the JAX package's
``_conv_taps`` / ``_wgrad_taps``); on a CUDA device they launch a kernel of
``csrc/conv3x3.cu`` or raise. They never fall back. Which kernel, ``variant``:

  - ``"wgmma"``: bf16 with channel counts that are multiples of 8 and 16-byte-aligned
    tensors, every trunk geometry. B4 tiles its output by ``fwd_tiles``, B5 its work by
    ``wgrad_tiles`` (both pure functions of the shapes, so the sum order is fixed);
  - ``"fma"``: float32 (IEEE FMAs, no TF32); ``"wmma"``: bf16 off the vector width.

Each wrapper adds one to ``launches`` and to ``variants[variant]`` per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build

# SMs of an H100 SXM, and its dense bf16 tensor-core and memory rates (NVIDIA's data
# sheet): the schedules below size work to whole waves of SMs.
_NUM_SMS = 132
_PEAK_BF16_FLOP_S = 989e12
_PEAK_BYTES_S = 3.35e12
# The first port's B5 (float32, bf16 off the vector width): the grid holds about
# _WGRAD_BLOCKS_PER_SM blocks for each SM.
_WGRAD_BLOCKS_PER_SM = 4
_WGRAD_TILE = 64  # its C and O tile
_WGRAD_MIN_PIXELS = 256  # fewest pixels one of its splits sums
# The wgmma kernels: B4's pixel tile and tile widths, B5's pixel stage and tiles.
FWD_BM = 128
FWD_BN = (64, 128, 256)
# B4's stage time at tile width BN goes as _FWD_STAGE_FIXED + BN (fitted to the tile
# sweep of tools/bench_conv3x3.py --sweep at layer4 of a 512x1024 crop).
_FWD_STAGE_FIXED = 256
WGRAD_PIX = 64
WGRAD_TILES = ((64, 64), (128, 128), (128, 256))  # (C tile, O tile)
_WGRAD_MAX_SPLITS = 64


def tap_weights(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The nine tap matrices (3, 3, Ck, N) of the OIHW weight ``w`` (O, C, 3, 3):
    ``w[:, :, kh, kw].T`` for the forward (Ck = C, N = O); for ``flip`` the flipped,
    io-transposed kernel of the input gradient, ``w[:, :, 2-kh, 2-kw]`` (Ck = O,
    N = C). The first port's kernels read this layout."""
    if flip:
        return w.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    return w.permute(2, 3, 1, 0).contiguous()


def gemm_weights(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The wgmma kernel's B operand, (N, 3, 3, Ck): each output channel's nine taps in
    one K-major row, ``w[o, :, kh, kw]``; for ``flip`` the io-transposed
    ``w[:, c, kh, kw]``, not flipped: the flipped kernel's tap (kh, kw) is its
    (2 - kh, 2 - kw), which the kernel reads. One permute copy."""
    if flip:
        return w.permute(1, 2, 3, 0).contiguous()
    return w.permute(0, 2, 3, 1).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv3x3_taps(x: torch.Tensor, w: torch.Tensor, d: int, *,
                 flip: bool = False) -> torch.Tensor:
    """Plain version of B4: nine shifted-slice matmuls (``_conv_taps``,
    simt_tpu/ops/conv.py:64-80), float32 products and sums in tap order, the result
    rounded once to ``x``'s dtype. Returns NCHW (channels_last memory)."""
    b, _, h, ww = x.shape
    wk = tap_weights(w, flip).float()
    xp = F.pad(_nhwc(x), (0, 0, d, d, d, d))
    acc = None
    for kh in range(3):
        for kw in range(3):
            xs = xp[:, kh * d:kh * d + h, kw * d:kw * d + ww, :].float()
            y = torch.matmul(xs, wk[kh, kw])
            acc = y if acc is None else acc + y
    return acc.to(x.dtype).permute(0, 3, 1, 2)


def wgrad_taps(x: torch.Tensor, g: torch.Tensor, d: int) -> torch.Tensor:
    """Plain version of B5: ``dw[kh, kw] = x_shift^T @ g`` over all pixels
    (``_wgrad_taps``, simt_tpu/ops/conv.py:83-101), float32. ``x`` (B, C, H, W) and
    ``g`` (B, O, H, W) -> OIHW (O, C, 3, 3) float32."""
    _, c, h, ww = x.shape
    o = g.shape[1]
    xp = F.pad(_nhwc(x), (0, 0, d, d, d, d))
    g2 = _nhwc(g).reshape(-1, o).float()
    taps = []
    for kh in range(3):
        for kw in range(3):
            xs = xp[:, kh * d:kh * d + h, kw * d:kw * d + ww, :].reshape(-1, c).float()
            taps.append(xs.T @ g2)  # (C, O)
    return torch.stack(taps).reshape(3, 3, c, o).permute(3, 2, 0, 1).contiguous()


@dataclasses.dataclass(frozen=True)
class FwdTiles:
    """B4's output tiling on the wgmma kernel: FWD_BM pixels x ``bn`` channels."""
    bn: int
    m_tiles: int
    n_tiles: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def waves(self) -> int:
        return math.ceil(self.tiles / _NUM_SMS)


@functools.lru_cache(maxsize=None)
def fwd_tiles(pixels: int, n: int) -> FwdTiles:
    """The tile width of B4 on ``pixels`` output pixels and ``n`` channels: of 64, 128
    and 256 (no wider than ``n`` rounded up to 64), the one with the least modelled
    time, its waves of 132 SMs (one block each) times a pipeline stage's time, which
    grows as _FWD_STAGE_FIXED + BN (a stage's fixed cost, the waits and the 128-row
    activation tile, is about that of _FWD_STAGE_FIXED more output columns); the wider
    on a tie. At 512x1024, layers 2-4 (66 pixel tiles) get N/2, 132 tiles: one wave."""
    m_tiles = max(1, math.ceil(pixels / FWD_BM))
    best = None
    for bn in FWD_BN:
        if bn > max(64, math.ceil(n / 64) * 64):
            continue
        t = FwdTiles(bn, m_tiles, math.ceil(n / bn))
        key = (t.waves * (_FWD_STAGE_FIXED + bn), -bn)
        if best is None or key < best[0]:
            best = (key, t)
    return best[1]


@dataclasses.dataclass(frozen=True)
class WgradTiles:
    """B5's work on the wgmma kernel: per tap, ``bc`` x ``bo`` tiles of (C, O), the
    pixel sum cut into ``splits`` ranges of ``per_split`` pixels (a multiple of
    WGRAD_PIX; the last range fewer); one block per (split, tile, tap). ``taps`` is 9
    for the 3x3 conv, 1 for the fused bottleneck's 1x1 weight gradients."""
    bc: int
    bo: int
    splits: int
    per_split: int
    c_tiles: int
    o_tiles: int
    taps: int = 9

    @property
    def tiles(self) -> int:
        return self.taps * self.c_tiles * self.o_tiles

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    @property
    def waves(self) -> int:
        return math.ceil(self.items / _NUM_SMS)


@functools.lru_cache(maxsize=None)
def wgrad_tiles(pixels: int, c: int, o: int, taps: int = 9) -> WgradTiles:
    """B5's tile and split from the shapes alone (so the order of every sum is fixed):
    the C tile is 64 for ``c`` <= 64, else 128; of the O tiles and split counts, the one
    with the least modelled time, whole waves of products at the bf16 peak (each item's
    pixel stages x its tile) plus, with more than one split, the float32 partials
    written and read once at the memory rate. Fewer splits, then the wider tile, on a
    tie. ``taps`` 1 schedules a 1x1 conv's weight gradient (the fused bottleneck's dw1
    and dw3) on the same kernel design."""
    chunks = max(1, math.ceil(pixels / WGRAD_PIX))
    bc = 64 if c <= 64 else 128
    best = None
    for tc, bo in WGRAD_TILES:
        if tc != bc:
            continue
        c_tiles, o_tiles = math.ceil(c / bc), math.ceil(o / bo)
        for want in range(1, min(chunks, _WGRAD_MAX_SPLITS) + 1):
            per = math.ceil(chunks / want)
            t = WgradTiles(bc, bo, math.ceil(chunks / per), per * WGRAD_PIX, c_tiles,
                           o_tiles, taps)
            mma_s = t.waves * per * 2 * WGRAD_PIX * bc * bo / (_PEAK_BF16_FLOP_S / _NUM_SMS)
            sum_s = 0.0 if t.splits == 1 else 2 * t.splits * taps * c * o * 4 / _PEAK_BYTES_S
            key = (mma_s + sum_s, t.splits, -bo)
            if best is None or key < best[0]:
                best = (key, t)
    return best[1]


def variant(dtype: torch.dtype, channels, tensors) -> str:
    """The kernel that takes a call on a card: ``"wgmma"`` for bf16 whose channel
    counts are multiples of 8 and whose tensors are 16-byte aligned (``_vec``), else
    ``"wmma"`` (bf16) or ``"fma"`` (float32)."""
    if dtype == torch.bfloat16:
        return "wgmma" if _vec(dtype, channels, tensors) else "wmma"
    return "fma"


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, d: int, *,
                flip: bool = False) -> torch.Tensor:
    """B4: (B, Ck, H, W) ``x`` and (O, C, 3, 3) ``w`` -> (B, N, H, W) in ``x``'s dtype,
    with (Ck, N) = (C, O), or (O, C) for ``flip`` (the input gradient). On a card one
    weight permute (``gemm_weights``, or ``tap_weights`` off the wgmma kernel) and one
    kernel launch; dx reads the io-transposed weight's taps in reverse."""
    _check(x, w, d, w.shape[0] if flip else w.shape[1])
    if x.device.type == "cpu":
        return conv3x3_taps(x, w, d, flip=flip)
    b, ck, h, ww = x.shape
    n = w.shape[1] if flip else w.shape[0]
    y = torch.empty((b, n, h, ww), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    kind = variant(x.dtype, (ck, n), (x, y))
    if kind == "wgmma":  # the freshly packed weight is aligned by the allocator
        wk, path, bn = gemm_weights(w, flip), 2, fwd_tiles(b * h * ww, n).bn
    else:
        wk, bn = tap_weights(w, flip), 0
        path = _vec(x.dtype, (ck, n), (x, wk, y)) if kind == "fma" else 0
    err = _lib().simt_conv3x3_fwd(x.data_ptr(), wk.data_ptr(), y.data_ptr(), b, h, ww,
                                  ck, n, d, _DTYPE[x.dtype], path, bn, int(flip),
                                  _stream(x))
    _raise_if(err, "conv3x3_fwd")
    conv3x3_fwd.launches += 1
    conv3x3_fwd.variants[kind] += 1
    return y


conv3x3_fwd.launches = 0
conv3x3_fwd.variants = {"wgmma": 0, "wmma": 0, "fma": 0}


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, d: int) -> torch.Tensor:
    """B5: (B, C, H, W) ``x`` and (B, O, H, W) ``g`` of one dtype -> dw (O, C, 3, 3)
    float32. On a card one launch, whatever the split count."""
    if (g.dim() != 4 or x.dim() != 4 or g.shape[0] != x.shape[0]
            or g.shape[2:] != x.shape[2:]):
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         "(B, C, H, W) and (B, O, H, W)")
    _check_tensor(x, d, "x")
    _check_tensor(g, d, "g")
    if g.dtype != x.dtype or g.device != x.device:
        raise TypeError(f"x and g differ in dtype or device: {x.dtype}/{g.dtype}, "
                        f"{x.device}/{g.device}")
    if x.device.type == "cpu":
        return wgrad_taps(x, g, d)
    b, c, h, ww = x.shape
    o = g.shape[1]
    kind = variant(x.dtype, (c, o), (x, g))
    if kind == "wgmma":
        t = wgrad_tiles(b * h * ww, c, o)
        splits, per_split, bc, bo, path = t.splits, t.per_split, t.bc, t.bo, 2
        tiles = t.tiles
    else:
        splits, per_split = wgrad_splits(b * h * ww, c, o)
        bc = bo = _WGRAD_TILE
        path = _vec(x.dtype, (c, o), (x, g)) if kind == "fma" else 0
        tiles = 9 * math.ceil(c / bc) * math.ceil(o / bo)
    f32 = dict(dtype=torch.float32, device=x.device)
    # The wgmma kernel writes dw directly at one split; the others always stage.
    part = torch.empty((splits, 9, c, o) if splits > 1 or path != 2 else (1,), **f32)
    dw = torch.empty((o, c, 3, 3), **f32)
    stream = _stream(x)
    err = _lib().simt_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                    _tickets(x.device, stream, tiles).data_ptr(),
                                    dw.data_ptr(), b, h, ww, c, o, d, splits, per_split,
                                    _DTYPE[x.dtype], path, bc, bo, stream)
    _raise_if(err, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    conv3x3_wgrad.variants[kind] += 1
    return dw


conv3x3_wgrad.launches = 0
conv3x3_wgrad.variants = {"wgmma": 0, "wmma": 0, "fma": 0}

# One zeroed int32 ticket per B5 tile, for each (device, raw stream): the last split of
# a tile resets its own, so the buffer is zero again after every launch. Launches on
# one stream run in order and never share their tickets; two streams get two buffers.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:  # zeroed on the current stream, which is ``stream``
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def wgrad_splits(pixels: int, c: int, o: int, taps: int = 9) -> Tuple[int, int]:
    """(splits, pixels per split) of the first port's split-K weight gradients (B5 off
    the wgmma kernel, B7's dw1-3): enough blocks to fill the card (the grid is splits x
    C-tiles x O-tiles x taps), at least _WGRAD_MIN_PIXELS pixels a split. A function
    of the shapes only, so the sum order is fixed."""
    pixels = max(pixels, 1)
    tiles = taps * math.ceil(c / _WGRAD_TILE) * math.ceil(o / _WGRAD_TILE)
    want = math.ceil(_WGRAD_BLOCKS_PER_SM * _NUM_SMS / tiles)
    splits = max(1, min(want, math.ceil(pixels / _WGRAD_MIN_PIXELS)))
    per_split = math.ceil(pixels / splits)
    return math.ceil(pixels / per_split), per_split


def work(batch: int, h: int, w: int, c: int, o: int, dtype: torch.dtype,
         op: str) -> Tuple[int, int]:
    """(bytes, operations) one call needs, each input read once and each output written
    once: ``op`` "fwd" reads x (B, H, W, C) and the weight, writes y (B, H, W, O);
    "dx" reads g (B, H, W, O) and the weight, writes dx; "wgrad" reads x and g, writes
    dw (9, C, O) float32. Operations: 2 * pixels * 9 * C * O multiply-adds' worth.
    The weight permute the wrappers make is not counted (it is the implementation's,
    not the function's); it is in the wrapper's measured time."""
    es = dtype.itemsize
    pixels = batch * h * w
    ops = 2 * pixels * 9 * c * o
    if op in ("fwd", "dx"):
        nbytes = pixels * (c + o) * es + 9 * c * o * es
    elif op == "wgrad":
        nbytes = pixels * (c + o) * es + 9 * c * o * 4
    else:
        raise ValueError(f"unknown op {op!r} (fwd, dx or wgrad)")
    return nbytes, ops


_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _check_tensor(x: torch.Tensor, d: int, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, C, H, W), got {tuple(x.shape)}")
    if int(d) != d or d < 1:
        raise ValueError(f"dilation must be a positive integer, got {d}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device} (expected cpu or cuda)")
    if x.dtype not in _DTYPE:
        raise TypeError(f"CUDA kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"CUDA kernel takes channels_last {name}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name} has 2**31 or more elements")


def _check(x: torch.Tensor, w: torch.Tensor, d: int, ck: int) -> None:
    _check_tensor(x, d, "x")
    if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"w must be OIHW (O, C, 3, 3), got {tuple(w.shape)}")
    if x.shape[1] != ck:
        raise ValueError(f"x has {x.shape[1]} channels, the weight {tuple(w.shape)} "
                         f"takes {ck}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"x and w differ in dtype or device: {x.dtype}/{w.dtype}, "
                        f"{x.device}/{w.device}")


def _vec(dtype: torch.dtype, channels, tensors) -> int:
    """1 when every channel count is a whole number of 16-byte units and every pointer
    is 16-byte aligned (the kernels' vector loads, TMA's strides), else 0."""
    ev = 16 // dtype.itemsize
    return int(all(ch % ev == 0 for ch in channels)
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on ``x``'s device (without building a
    Stream object: this is on every launch's host path)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise_if(err: int, name: str, lib=None) -> None:
    """Raises if a C entry point returned a CUDA error; ``lib`` is the library that
    returned it (this module's by default)."""
    if err != 0:
        msg = (lib or _lib()).simt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.simt_conv3x3_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.simt_conv3x3_fwd.restype = i
    lib.simt_conv3x3_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                                       p]
    lib.simt_conv3x3_wgrad.restype = i
    lib.simt_cuda_error_string.argtypes = [i]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib
