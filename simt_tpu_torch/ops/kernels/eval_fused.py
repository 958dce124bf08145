"""Fused multi-scale eval head: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``simt_tpu/ops/pallas/eval_fused.py``. The reference eval protocol
(evaluate_cityscapes.py:127-148) upsamples head-2 logits from both input scales to
1024x2048 with align-corners bilinear, sums them, takes the per-pixel argmax and adds a
19x19 confusion histogram against the remapped ground truth. The kernel
(``csrc/eval_fused.cu``) does all of it in one pass; only the histogram is written.

``multiscale_argmax_hist`` dispatches on the tensors' device: on the CPU it runs
``multiscale_argmax_hist_reference``; on a CUDA device it launches the kernel (and adds
one to ``multiscale_argmax_hist.launches``) or raises. It never falls back. With
``out=`` it adds into the caller's running histogram, and the kernel is then the call's
only device operation. ``row_range=(row0, rows)`` takes only those output rows, as the
JAX package's ``_rowblock_hist`` does; ``multiscale_argmax_hist_spatial`` runs one such
block a rank and sums the blocks with ``torch.distributed.all_reduce``.

The kernel walks the block table of ``schedule``: bands of output rows by segments of
output columns, a pure function of the shapes that the CPU tests hold to covering every
output pixel of the row range once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..interp import interp_taps, upsample_bilinear_align_corners
from ..metrics import fast_hist
from . import _build

NUM_SMS = 132  # H100 SXM
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
THREADS = 512  # most threads a block, one output column each (csrc kMaxThreads)
MAX_BAND = 8  # most output rows a block
MAX_SOURCE_ROWS = 3  # most source rows of a scale a band reads (the kernel holds 3)
SMEM_LIMIT = 232448  # shared memory a block can take on sm_90
# A block-table row: output rows [r0, r1), columns [c0, c1); the source rows and columns
# of scale a it reads, [ia0, ia1] and [ja0, ja1], then those of scale b.
BLOCK_FIELDS = ("r0", "r1", "c0", "c1", "ia0", "ia1", "ja0", "ja1",
                "ib0", "ib1", "jb0", "jb1")
MAX_CLASSES = 32


@dataclasses.dataclass(frozen=True)
class Schedule:
    blocks: np.ndarray  # (n, len(BLOCK_FIELDS)) int32, the kernel's block table
    band: int  # most output rows of a block
    xca: int  # most source columns of scale a a block reads
    xcb: int  # the same, scale b
    threads: int  # threads a block: the widest segment, rounded up to whole warps
    cp: int  # classes padded to whole float4s (20 for 19 classes, else 32)
    smem: int  # shared memory a block (csrc layout())


def _edges(n: int, parts: int) -> np.ndarray:
    return (np.arange(parts + 1) * n) // parts


def schedule(ha: int, wa: int, hb: int, wb: int, out_hw: Tuple[int, int],
             num_classes: int, batch: int = 1,
             row_range: Optional[Tuple[int, int]] = None) -> Schedule:
    """The kernel's blocks over output rows ``row_range`` (row0, rows; all rows by
    default) of an ``out_hw`` image: segments of THREADS columns (the last shorter) by
    bands of at most MAX_BAND rows, split as evenly as rows allow.
    The band count is the least that makes the block count over the batch a whole
    number of waves of BLOCKS_PER_SM blocks an SM (528 blocks at 1024x2048: 132 bands of
    7-8 rows by 4 segments) and keeps every band's source rows of each scale at most
    MAX_SOURCE_ROWS, or one band a row where the rows are too few. Each block's source
    rows and columns are the taps its pixels read."""
    hh, ww = out_hw
    row0, rows = (0, hh) if row_range is None else (int(row_range[0]), int(row_range[1]))
    if rows < 1 or row0 < 0 or row0 + rows > hh:
        raise ValueError(f"row range ({row0}, {rows}) is not inside {hh} output rows")
    if num_classes > MAX_CLASSES:
        raise ValueError(f"the CUDA kernel takes at most {MAX_CLASSES} classes, "
                         f"got {num_classes}")
    lo_ha, hi_ha, _, _ = interp_taps(ha, hh)
    lo_wa, hi_wa, _, _ = interp_taps(wa, ww)
    lo_hb, hi_hb, _, _ = interp_taps(hb, hh)
    lo_wb, hi_wb, _, _ = interp_taps(wb, ww)
    segs = -(-ww // THREADS)
    c_edges = np.minimum(np.arange(segs + 1) * THREADS, ww)
    slots = NUM_SMS * BLOCKS_PER_SM
    per_wave = slots // np.gcd(slots, segs * batch)  # bands that fill whole waves
    bands = -(-(-(-rows // MAX_BAND)) // per_wave) * per_wave
    while True:
        bands = min(rows, bands)
        r_edges = row0 + _edges(rows, bands)
        first, last = r_edges[:-1], r_edges[1:] - 1
        span = max((hi_ha[last] - lo_ha[first]).max(), (hi_hb[last] - lo_hb[first]).max()) + 1
        if span <= MAX_SOURCE_ROWS or bands == rows:
            break
        bands += per_wave
    rows_ = []
    for r0, r1 in zip(r_edges[:-1], r_edges[1:]):
        for c0, c1 in zip(c_edges[:-1], c_edges[1:]):
            rows_.append((r0, r1, c0, c1, lo_ha[r0], hi_ha[r1 - 1], lo_wa[c0], hi_wa[c1 - 1],
                          lo_hb[r0], hi_hb[r1 - 1], lo_wb[c0], hi_wb[c1 - 1]))
    blocks = np.asarray(rows_, np.int32).reshape(-1, len(BLOCK_FIELDS))
    xca = int((blocks[:, 7] - blocks[:, 6]).max()) + 1
    xcb = int((blocks[:, 11] - blocks[:, 10]).max()) + 1
    threads = -(-int((blocks[:, 3] - blocks[:, 2]).max()) // 32) * 32
    band = int((blocks[:, 1] - blocks[:, 0]).max())
    cp = 20 if num_classes == 19 else MAX_CLASSES
    smem = smem_bytes(band, xca, xcb, threads, num_classes, cp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a block of the eval head needs {smem} bytes of shared memory "
                         f"(at most {SMEM_LIMIT}) at these shapes")
    return Schedule(blocks, band, xca, xcb, threads, cp, smem)


def smem_bytes(band: int, xca: int, xcb: int, threads: int, num_classes: int,
               cp: int) -> int:
    """Shared memory of one block (the kernel's ``layout()``): z of both scales for the
    band's rows and the block's source columns (cp floats a column), one (C, C)
    histogram a warp, each row's H taps of both scales (16 bytes each) and the gt tile
    as bytes; each part rounded up to 16 bytes."""
    r16 = lambda v: -(-v // 16) * 16  # noqa: E731
    c = num_classes
    return (r16(band * xca * cp * 4) + r16(band * xcb * cp * 4)
            + r16(threads // 32 * c * c * 4) + 2 * band * 16 + r16(band * threads))


def multiscale_argmax_hist_reference(
    logits_a: torch.Tensor,
    logits_b: torch.Tensor,
    gt: torch.Tensor,
    *,
    out_hw: Tuple[int, int] = (1024, 2048),
    num_classes: int = 19,
    row_range: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain version: upsample both scales (two matmuls each), sum, argmax, fast_hist.

    ``logits_*``: (B, h8, w8, C) float32 NHWC; ``gt``: (B, H, W) integer. Returns the
    (C, C) int32 histogram summed over the batch, of output rows ``row_range`` (row0,
    rows) only if it is given.
    """
    la, lb, gt = _as_batch(logits_a, logits_b, gt)
    pred = upsample_bilinear_align_corners(la.float(), out_hw)
    pred = pred + upsample_bilinear_align_corners(lb.float(), out_hw)
    pred = torch.argmax(pred, dim=-1)
    if row_range is not None:
        row0, rows = row_range
        pred, gt = pred[:, row0:row0 + rows], gt[:, row0:row0 + rows]
    return fast_hist(gt, pred, num_classes)


def multiscale_argmax_hist(
    logits_a: torch.Tensor,
    logits_b: torch.Tensor,
    gt: torch.Tensor,
    *,
    out_hw: Tuple[int, int] = (1024, 2048),
    num_classes: int = 19,
    out: Optional[torch.Tensor] = None,
    row_range: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Fused eval head: (B, h8a, w8a, C) + (B, h8b, w8b, C) float32 logits and (B, H, W)
    ground truth -> (C, C) int32 confusion histogram summed over the batch. A single
    image may be passed without the batch dimension, as in the JAX package.

    ``out``: a (C, C) int32 histogram on the logits' device to add into (returned);
    without it a fresh histogram is returned. ``row_range``: (row0, rows), the output
    rows to count (``gt`` stays the whole map); all rows by default.

    On CUDA tensors all three must be contiguous, the logits float32 and ``gt`` uint8
    or int32, and ``num_classes`` at most 32.
    """
    la, lb, gt = _as_batch(logits_a, logits_b, gt)
    _check(la, lb, gt, out_hw, num_classes, out)
    dev = la.device
    if dev.type == "cpu":
        hist = multiscale_argmax_hist_reference(la, lb, gt, out_hw=out_hw,
                                                num_classes=num_classes,
                                                row_range=row_range)
        return hist if out is None else out.add_(hist)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    if out is None:
        out = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=dev)
    launch(la, lb, gt, out, tuple(out_hw), row_range)
    return out


multiscale_argmax_hist.launches = 0


def multiscale_argmax_hist_spatial(
    logits_a: torch.Tensor,
    logits_b: torch.Tensor,
    gt: torch.Tensor,
    *,
    group=None,
    out_hw: Tuple[int, int] = (1024, 2048),
    num_classes: int = 19,
) -> torch.Tensor:
    """Row-sharded fused eval head (counterpart of the JAX package's
    ``multiscale_argmax_hist_spatial``): every rank of ``group`` holds the whole logits
    and ``gt``; rank ``r`` of ``n`` counts output rows [r*H/n, (r+1)*H/n) with one
    ``multiscale_argmax_hist`` call, and the (C, C) histograms are summed with
    ``all_reduce``. The histogram is a sum over pixels, so this equals the unsharded
    histogram exactly. Returns it on every rank."""
    import torch.distributed as dist

    hh, _ = out_hw
    n = dist.get_world_size(group)
    if hh % n:
        raise ValueError(f"out height {hh} not divisible by spatial={n}")
    blk = hh // n
    hist = multiscale_argmax_hist(logits_a, logits_b, gt, out_hw=out_hw,
                                  num_classes=num_classes,
                                  row_range=(dist.get_rank(group) * blk, blk))
    dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
    return hist


def launch(la: torch.Tensor, lb: torch.Tensor, gt: torch.Tensor, hist: torch.Tensor,
           out_hw: Tuple[int, int], row_range: Optional[Tuple[int, int]] = None) -> None:
    """Add the histogram of the batch's ``row_range`` into ``hist`` with one kernel
    launch on the current stream. Arguments as checked by ``multiscale_argmax_hist``."""
    lib = _lib()
    b, ha, wa, c = la.shape
    _, hb, wb, _ = lb.shape
    hh, ww = out_hw
    s, blocks = device_schedule(ha, wa, hb, wb, out_hw, c, b,
                                None if row_range is None else tuple(row_range), la.device)
    taps_i, taps_f = device_taps(ha, wa, hb, wb, out_hw, la.device)
    gt_bytes = gt.element_size()
    # 16-byte copies of gt rows: every row and segment start (a multiple of THREADS)
    # then lies on 16 bytes.
    gt_vec = int(gt.data_ptr() % 16 == 0 and ww % (16 // gt_bytes) == 0)
    stream = torch.cuda.current_stream(la.device).cuda_stream
    err = lib.simt_eval_fused_hist(
        la.data_ptr(), lb.data_ptr(), gt.data_ptr(), gt_bytes, taps_i.data_ptr(),
        taps_f.data_ptr(), blocks.data_ptr(), len(s.blocks), hist.data_ptr(), b, ha, wa,
        hb, wb, hh, ww, c, s.cp, s.band, s.xca, s.xcb, gt_vec, s.threads, s.smem, stream,
    )
    if err != 0:
        msg = lib.simt_cuda_error_string(err).decode()
        raise RuntimeError(f"eval_fused kernel launch failed: {msg} ({err})")
    multiscale_argmax_hist.launches += 1


@functools.lru_cache(maxsize=64)
def device_schedule(ha: int, wa: int, hb: int, wb: int, out_hw: Tuple[int, int],
                    num_classes: int, batch: int, row_range: Optional[Tuple[int, int]],
                    device: torch.device) -> Tuple[Schedule, torch.Tensor]:
    """``schedule`` and its block table on ``device`` (int32)."""
    s = schedule(ha, wa, hb, wb, out_hw, num_classes, batch, row_range)
    return s, torch.from_numpy(s.blocks.ravel().copy()).to(device)


@functools.lru_cache(maxsize=16)
def device_taps(ha: int, wa: int, hb: int, wb: int, out_hw: Tuple[int, int],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's tap tables on ``device``: int32 (4, H+W) [lo_a, hi_a, lo_b, hi_b]
    and float32 (4, H+W) [w0_a, w1_a, w0_b, w1_b], rows first then columns."""
    hh, ww = out_hw
    ints, floats = [], []
    for h_in, w_in in ((ha, wa), (hb, wb)):
        lo_h, hi_h, w0_h, w1_h = interp_taps(h_in, hh)
        lo_w, hi_w, w0_w, w1_w = interp_taps(w_in, ww)
        ints += [np.concatenate([lo_h, lo_w]), np.concatenate([hi_h, hi_w])]
        floats += [np.concatenate([w0_h, w0_w]), np.concatenate([w1_h, w1_w])]
    return (torch.from_numpy(np.stack(ints)).to(device),
            torch.from_numpy(np.stack(floats)).to(device))


def work(ha: int, wa: int, hb: int, wb: int, out_hw: Tuple[int, int], num_classes: int,
         batch: int, n_counted: int, gt_bytes: int = 4) -> Tuple[int, int]:
    """(bytes, float32 operations) the fused head needs for one call: each input read
    once (gt at ``gt_bytes`` a pixel, logits, tap tables), the histogram written once;
    the H step for every output row and, for the ``n_counted`` pixels whose gt is in
    [0, C), the two W steps, the scale sum and the argmax compares (the kernel's own
    cost model, ``csrc/eval_fused.cu``)."""
    hh, ww = out_hw
    c = num_classes
    nbytes = (batch * (hh * ww * gt_bytes + (ha * wa + hb * wb) * c * 4)
              + 2 * 4 * 4 * (hh + ww) + c * c * 4)
    ops = batch * hh * (wa + wb) * c * 3 + n_counted * 8 * c
    return nbytes, ops


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("eval_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.simt_eval_fused_hist.argtypes = [p, p, p, i, p, p, p, i, p, *[i] * 15, p]
    lib.simt_eval_fused_hist.restype = i
    lib.simt_cuda_error_string.argtypes = [i]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _as_batch(la, lb, gt):
    if la.dim() == 3 and lb.dim() == 3 and gt.dim() == 2:
        return la[None], lb[None], gt[None]
    return la, lb, gt


def _check(la, lb, gt, out_hw, num_classes, out=None) -> None:
    if la.dim() != 4 or lb.dim() != 4 or gt.dim() != 3:
        raise ValueError(
            f"expected (B,h,w,C) logits and (B,H,W) gt, got {tuple(la.shape)}, "
            f"{tuple(lb.shape)}, {tuple(gt.shape)}")
    if la.shape[-1] != num_classes or lb.shape[-1] != num_classes:
        raise ValueError(f"logits must have {num_classes} channels (last dim)")
    if not (la.shape[0] == lb.shape[0] == gt.shape[0]):
        raise ValueError("logits and gt batch sizes differ")
    if tuple(gt.shape[1:]) != tuple(out_hw):
        raise ValueError(f"gt {tuple(gt.shape[1:])} does not match out_hw {tuple(out_hw)}")
    if not (la.device == lb.device == gt.device):
        raise ValueError("logits and gt must be on one device")
    if out is not None and (out.shape != (num_classes, num_classes)
                            or out.dtype != torch.int32 or out.device != la.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({num_classes}, {num_classes}) int32 "
                         f"tensor on {la.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    if la.device.type != "cuda":
        return
    if la.dtype != torch.float32 or lb.dtype != torch.float32:
        raise TypeError(f"CUDA kernel takes float32 logits, got {la.dtype}/{lb.dtype}")
    if gt.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"CUDA kernel takes uint8 or int32 gt, got {gt.dtype}")
    if not (la.is_contiguous() and lb.is_contiguous() and gt.is_contiguous()):
        raise ValueError("CUDA kernel takes contiguous logits and gt")
    if la.shape[0] > 65535:
        raise ValueError("batch larger than the grid's y limit (65535)")
    if num_classes > MAX_CLASSES:
        raise ValueError(f"the CUDA kernel takes at most {MAX_CLASSES} classes, "
                         f"got {num_classes}")
