"""The SimT streamed loss core, forward and backward: CUDA kernel wrappers, their plain
PyTorch versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``experiments/pallas_alternates/loss_fused.py`` (the VMEM-resident twin
of the ``lax.scan`` core of ``simt_tpu/ops/fused_losses.py::simt_loss_block``). Per
output pixel of the full-resolution (B, H, W) label map the core

  - upsamples the concatenated stride-8 logits ``xcat`` (B, h8, w8, 2*(C+O)) of both
    heads (align-corners bilinear, H then W, two taps each);
  - refines the teacher label ``conf`` with **head 2's** argmax (unknown pixels, class
    C, take head 2's open-set argmax, else ignore; trainV2_simt.py:387-393);
  - per head: CE against the refined label; the placeholder's known CE (argmax label
    where it is a known class and the softmax max 1/den exceeds ``threshold_high``) and
    unknown CE (argmax channel set to 0, label the argmax over the open channels with
    the known channels at 0); the noisy posterior -log((T^T softmax)[label]);
  - per head: the running per-channel maximum of the logits with the first (global,
    batch-major flat) index holding it, and the presence of each channel as an argmax.

Outputs: ``sums`` (2, 8) float32, per head (ce_s, ce_n, known_s, known_n, unk_s,
unk_n, y_s, y_n); anchor maxima (2, C+O) float32, anchor indices (2, C+O) int32 and
presence (2, C+O) float32, which take no gradient. The backward takes the cotangents
of ``sums`` and returns ``dxcat``, ``dT1``, ``dT2``.

A band: ``band=(r0, H)`` computes all of this over the output rows ``[r0, r0 + rows)``
of an image of H rows, ``label`` and ``conf`` holding just those rows (one rank's share
on the spatial axis; the anchor indices stay the whole image's). ``None`` is the whole
image, ``(0, rows)``; the two bands' sums add up to it, and their counts, anchors and
presence combine into its.

``loss_core_fwd`` / ``loss_core_bwd`` dispatch on the tensors' device: on the CPU they
run ``loss_core_fwd_reference`` / ``loss_core_bwd_reference``; on a CUDA device they
launch the kernel of ``csrc/loss_fused.cu`` once (and add one to their ``launches``) or
raise. They never fall back. Both kernels walk the blocks of ``schedule``, a pure
function of the shapes, and finish inside their one launch: the block that draws the
last integer ticket sums the others' partials in a fixed order, so reruns are bitwise
equal. Their tickets, anchor keys and presence words live in a buffer per (device,
stream) that each launch leaves zero.

The plain forward computes each upsampled logit, softmax denominator, reciprocal and
picked posterior with the kernel's own operations in the kernel's order (the two taps
as a rounded product sum, channel sums in ascending order, ``sm = e * (1 / den)``), so
on the card the two agree exactly in every count, argmax, anchor maximum and anchor
index, and up to summation order in the sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...device import PEAK_BYTES_S, PEAK_F32_FLOP_S
from ...utils.spans import span
from ..interp import interp_taps
from . import _build

# C+O values the kernel is compiled for (its per-pixel logits live in registers).
SUPPORTED_TOTALS = (6, 8, 34)


# --------------------------------------------------------------------------------------
# Tap tables shared by the plain versions and the kernels
# --------------------------------------------------------------------------------------


def _taps(h8: int, w8: int, hh: int, ww: int, device) -> dict:
    """The two taps of every output row and column as tensors on ``device``."""
    lo_h, hi_h, w0_h, w1_h = interp_taps(h8, hh)
    lo_w, hi_w, w0_w, w1_w = interp_taps(w8, ww)
    as_t = functools.partial(torch.tensor, device=device)  # a copy: the taps are read-only
    return {"lo_h": as_t(lo_h).long(), "hi_h": as_t(hi_h).long(), "w0_h": as_t(w0_h),
            "w1_h": as_t(w1_h), "lo_w": as_t(lo_w).long(), "hi_w": as_t(hi_w).long(),
            "w0_w": as_t(w0_w), "w1_w": as_t(w1_w)}


def _source_ranges(tap: np.ndarray, n_src: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each source index j, the half-open range of output indices whose ``tap`` is
    j (contiguous: the taps are non-decreasing). Empty ranges are (0, 0)."""
    begin = np.zeros(n_src, np.int64)
    end = np.zeros(n_src, np.int64)
    for j in range(n_src):
        hit = np.nonzero(tap == j)[0]
        if hit.size:
            begin[j], end[j] = hit[0], hit[-1] + 1
    return begin, end


@functools.lru_cache(maxsize=16)
def device_tables(h8: int, w8: int, hh: int, ww: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' tap tables on ``device``: int32 [lo_h(H), hi_h(H), lo_w(W), hi_w(W),
    lo_begin(w8), lo_end(w8), hi_begin(w8), hi_end(w8)] (the output columns whose lo or
    hi tap is each source column) and float32 [w0_h(H), w1_h(H), w0_w(W), w1_w(W)]."""
    lo_h, hi_h, w0_h, w1_h = interp_taps(h8, hh)
    lo_w, hi_w, w0_w, w1_w = interp_taps(w8, ww)
    ints = np.concatenate([lo_h, hi_h, lo_w, hi_w, *_source_ranges(lo_w, w8),
                           *_source_ranges(hi_w, w8)]).astype(np.int32)
    floats = np.concatenate([w0_h, w1_h, w0_w, w1_w]).astype(np.float32)
    return torch.from_numpy(ints).to(device), torch.from_numpy(floats).to(device)


# The kernels' grid (csrc/loss_fused.cu): blocks of 256 threads, a lane pair a pixel, so
# one pass covers PASS_PIXELS output columns; two blocks an SM on the card's 132 SMs.
BLOCK_THREADS = 256
PASS_PIXELS = BLOCK_THREADS // 2
NUM_SMS = 132
BLOCKS_PER_SM = 2
BLOCK_FIELDS = 10  # b, r0, r1, c0, c1, jlo, jhi, i0, i1, part
DT_GROUP = 16  # blocks whose dT partials the last of them sums (csrc kDtGroup)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The blocks of both kernels: ``blocks`` (n, BLOCK_FIELDS) int32, each block's
    image b, output rows [r0, r1), output columns [c0, c1), the source columns [jlo,
    jhi] and source rows [i0, i1] they read, and the offset of its dxcat partial
    ((i1 - i0 + 1) x (jhi - jlo + 1) x cat floats) in B3's scratch; ``row_off`` /
    ``row_blk``, for each source row (b, i) in batch-major order, the blocks whose rows
    read it, in ascending order. ``jmax`` / ``kmax`` are the most source columns / rows
    a block reads, ``maxc`` the most blocks a source row has, ``part_floats`` the
    partials' total."""
    blocks: np.ndarray
    row_off: np.ndarray
    row_blk: np.ndarray
    jmax: int
    kmax: int
    maxc: int
    part_floats: int

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_groups(self) -> int:
        return -(-self.n_blocks // DT_GROUP)


def _edges(n: int, parts: int) -> np.ndarray:
    return np.asarray([k * n // parts for k in range(parts + 1)])


def _bands(batch: int, h8: int, w8: int, r_lo: int, r_hi: int, splits: int, jmax: int,
           cat: int, num_classes: int, lo_h: np.ndarray, hi_h: np.ndarray) -> int:
    """Bands of the output rows [r_lo, r_hi) of an image: at least as many as make
    NUM_SMS * BLOCKS_PER_SM blocks over the batch, and then the fewest whose B3 block
    fits BLOCKS_PER_SM to an SM, else one to an SM (a larger batch runs more waves of
    shorter bands; the target when none fits)."""
    hh = r_hi - r_lo
    target = max(1, min(hh, round(NUM_SMS * BLOCKS_PER_SM / (batch * splits))))

    def smem(bands: int) -> int:
        r = r_lo + _edges(hh, bands)
        i0, i1 = lo_h[r[:-1]], hi_h[r[1:] - 1]
        cover = np.zeros(h8 + 1, np.int64)  # bands reading each source row
        np.add.at(cover, i0, 1)
        np.add.at(cover, i1 + 1, -1)
        return _bwd_smem(int((i1 - i0).max()) + 1, jmax, int(cover.cumsum().max()) * splits,
                         w8, cat, num_classes)

    for limit in (_SM_SMEM // BLOCKS_PER_SM - _BLOCK_RESERVED, _MAX_SMEM):
        for bands in range(target, hh + 1):
            if smem(bands) <= limit:
                return bands
    return target


@functools.lru_cache(maxsize=16)
def schedule(batch: int, h8: int, w8: int, hh: int, ww: int, cat: int,
             num_classes: int, r_lo: int = 0, r_hi: int | None = None) -> Schedule:
    """Bands of contiguous output rows of one image, each split across the width into
    segments of at most PASS_PIXELS columns (one pass a row): ceil(W / 128) segments and
    as many bands as ``_bands`` gives (one wave of NUM_SMS * BLOCKS_PER_SM blocks at the
    main path's shapes; every band at least one row). Blocks in batch, band, segment
    order. A pure function of the shapes: the order in which partials are summed is
    fixed by it. ``[r_lo, r_hi)`` (the whole image by default) are the output rows the
    blocks cover; ``r_hi > r_lo``."""
    r_hi = hh if r_hi is None else r_hi
    lo_h, hi_h, _, _ = interp_taps(h8, hh)
    lo_w, hi_w, _, _ = interp_taps(w8, ww)
    splits = -(-ww // PASS_PIXELS)
    c_edges = _edges(ww, splits)
    jmax = int((hi_w[c_edges[1:] - 1] - lo_w[c_edges[:-1]]).max()) + 1
    r_edges = r_lo + _edges(r_hi - r_lo, _bands(batch, h8, w8, r_lo, r_hi, splits, jmax,
                                                cat, num_classes, lo_h, hi_h))
    rows, part = [], 0
    contrib = [[] for _ in range(batch * h8)]
    for b in range(batch):
        for r0, r1 in zip(r_edges[:-1], r_edges[1:]):
            i0, i1 = int(lo_h[r0]), int(hi_h[r1 - 1])
            for c0, c1 in zip(c_edges[:-1], c_edges[1:]):
                jlo, jhi = int(lo_w[c0]), int(hi_w[c1 - 1])
                for i in range(i0, i1 + 1):
                    contrib[b * h8 + i].append(len(rows))
                rows.append((b, r0, r1, c0, c1, jlo, jhi, i0, i1, part))
                part += (i1 - i0 + 1) * (jhi - jlo + 1) * cat
    blocks = np.asarray(rows, np.int32).reshape(-1, BLOCK_FIELDS)
    row_off = np.cumsum([0] + [len(c) for c in contrib]).astype(np.int32)
    row_blk = np.asarray([n for c in contrib for n in c], np.int32)
    return Schedule(blocks, row_off, row_blk,
                    int((blocks[:, 6] - blocks[:, 5]).max()) + 1,
                    int((blocks[:, 8] - blocks[:, 7]).max()) + 1,
                    int(np.diff(row_off).max()), part)


@functools.lru_cache(maxsize=16)
def device_schedule(batch: int, h8: int, w8: int, hh: int, ww: int, cat: int,
                    num_classes: int, r_lo: int, r_hi: int,
                    device: torch.device) -> Tuple[Schedule, torch.Tensor, int, int]:
    """``schedule`` and its tables on ``device`` as one int32 tensor [blocks, row_off,
    row_blk], with the element offsets of row_off and row_blk."""
    s = schedule(batch, h8, w8, hh, ww, cat, num_classes, r_lo, r_hi)
    flat = np.concatenate([s.blocks.ravel(), s.row_off, s.row_blk]).astype(np.int32)
    off = s.blocks.size
    return s, torch.from_numpy(flat).to(device), off, off + s.row_off.size


# The per-(device, stream) words both kernels leave zero: B2's anchor keys (uint64, up
# to 2 x 34), presence (int32) and ticket, then B3's tickets.
_KEY_WORDS = 4 * 34
_PRES_WORD, _FWD_TICKET, _BWD_TICKETS = _KEY_WORDS, _KEY_WORDS + 68, _KEY_WORDS + 72
_WORDS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _words(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 words for ``stream``, zero whenever no launch on it runs."""
    t = _WORDS.get((device, stream))
    if t is None or t.numel() < n:  # zeroed on the current stream, which is ``stream``
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _WORDS[(device, stream)] = t
    return t


def _upsample_rows(xcat: torch.Tensor, taps: dict, r0: int, r1: int) -> torch.Tensor:
    """Output rows [r0, r1) of the upsampled ``xcat``: (B, rows, W, cat), each value
    w0*x0 + w1*x1 along H, then along W, as the kernel computes it."""
    rows = slice(r0, r1)
    z = (taps["w0_h"][rows, None, None] * xcat[:, taps["lo_h"][rows]]
         + taps["w1_h"][rows, None, None] * xcat[:, taps["hi_h"][rows]])
    return (taps["w0_w"][:, None] * z[:, :, taps["lo_w"]]
            + taps["w1_w"][:, None] * z[:, :, taps["hi_w"]])


def _row_chunks(hh: int, chunk_rows: int, start: int = 0):
    """(r0, r1) of consecutive chunks of ``chunk_rows`` output rows of [start, hh); the
    last may be shorter."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    return [(r0, min(r0 + chunk_rows, hh)) for r0 in range(start, hh, chunk_rows)]


def band_rows(label: torch.Tensor, band) -> Tuple[int, int, int]:
    """(r0, r1, H): the output rows [r0, r1) that ``label`` holds of an image of H rows
    (``band=(r0, H)``; None: the whole image)."""
    rows = label.shape[1]
    r0, hh = (0, rows) if band is None else (int(band[0]), int(band[1]))
    if not 0 <= r0 <= r0 + rows <= hh:
        raise ValueError(f"a band of {rows} rows from row {r0} does not fit {hh} rows")
    return r0, r0 + rows, hh


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in ascending order, one rounded add at a time (the
    kernel's order)."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] where 0 <= idx < x.shape[-1], else 0 (a one-hot gather)."""
    inside = (idx >= 0) & (idx < x.shape[-1])
    safe = torch.where(inside, idx, torch.zeros_like(idx))
    got = torch.gather(x, -1, safe[..., None])[..., 0]
    return torch.where(inside, got, torch.zeros_like(got))


def _head(p: torch.Tensor, pseudo: torch.Tensor, refined: torch.Tensor,
          label: torch.Tensor, t: torch.Tensor, c: int, threshold_high: float,
          ignore: int) -> dict:
    """Per-pixel quantities of one head on (B, rows, W, C+O) logits ``p``."""
    total = p.shape[-1]
    ch = torch.arange(total, device=p.device)
    mx = p.amax(dim=-1)
    e = torch.exp(p - mx[..., None])
    den = _seq_sum(e)
    lz = mx + torch.log(den)
    rcp = 1.0 / den  # the kernel's one correctly rounded reciprocal
    sm = e * rcp[..., None]
    ignore_t = torch.full_like(pseudo, ignore)

    known = torch.where((pseudo < c) & (rcp > threshold_high), pseudo, ignore_t)
    onehot_arg = ch == pseudo[..., None]
    predict = torch.where(onehot_arg, torch.zeros_like(p), p)
    predict_open = torch.where(ch >= c, predict, torch.zeros_like(p))
    place_y = torch.argmax(predict_open, dim=-1)
    place_y = torch.where(known == ignore, ignore_t, place_y)
    mxu = predict.amax(dim=-1)
    eu = torch.exp(predict - mxu[..., None])
    denu = _seq_sum(eu)
    lzu = mxu + torch.log(denu)

    valid_y = _valid(label, ignore)
    has_y = valid_y & (label < c)
    ysafe = torch.where(has_y, label, torch.zeros_like(label)).long()
    tcol = t.T[ysafe]  # (B, rows, W, C+O): T[k, y] per pixel
    picked = _seq_sum(tcol * sm)
    picked = torch.where(has_y, picked, torch.zeros_like(picked))
    return {"p": p, "lz": lz, "sm": sm, "refined": refined, "known": known,
            "onehot_arg": onehot_arg, "predict": predict, "place_y": place_y,
            "lzu": lzu, "eu": eu, "denu": denu, "valid_y": valid_y, "has_y": has_y,
            "ysafe": ysafe, "tcol": tcol, "picked": picked}


def _valid(lbl: torch.Tensor, ignore: int) -> torch.Tensor:
    return (lbl >= 0) & (lbl != ignore)


def _head_sums(h: dict, ignore: int) -> torch.Tensor:
    """The eight (sum, count) accumulators of one head over its pixels."""
    out = []
    for lbl, logits, lz in ((h["refined"], h["p"], h["lz"]),
                            (h["known"], h["p"], h["lz"]),
                            (h["place_y"], h["predict"], h["lzu"])):
        v = _valid(lbl, ignore)
        nll = lz - _pick(logits, lbl.long())
        out += [torch.where(v, nll, torch.zeros_like(nll)).sum(), v.float().sum()]
    y = torch.where(h["valid_y"], -torch.log(h["picked"]), torch.zeros_like(h["picked"]))
    out += [y.sum(), h["valid_y"].float().sum()]
    return torch.stack(out)


def _refine(conf: torch.Tensor, pseudo2: torch.Tensor, c: int, ignore: int):
    """Class-posterior refinement (trainV2_simt.py:387-393), with head 2's argmax."""
    conf = conf.long()
    unk = conf == c
    p1_ = torch.where(unk, pseudo2, torch.zeros_like(pseudo2))
    p1_ = torch.where(p1_ >= c, p1_, torch.full_like(p1_, ignore))
    return torch.where(unk, p1_, conf)


def _chunk_forward(xcat, t1, t2, label_c, conf_c, taps, r0, r1, c, threshold_high,
                   ignore):
    """Sums (2, 8) and per-image anchor candidates of output rows [r0, r1)."""
    total = t1.shape[0]
    z = _upsample_rows(xcat, taps, r0, r1)
    p1, p2 = z[..., :total], z[..., total:]
    pseudo1 = torch.argmax(p1, dim=-1)
    pseudo2 = torch.argmax(p2, dim=-1)
    refined = _refine(conf_c, pseudo2, c, ignore)
    sums, cand = [], []
    for p, pseudo, t in ((p1, pseudo1, t1), (p2, pseudo2, t2)):
        h = _head(p, pseudo, refined, label_c, t, c, threshold_high, ignore)
        sums.append(_head_sums(h, ignore))
        flat = p.detach().reshape(p.shape[0], -1, total)  # (B, rows*W, C+O)
        present = torch.zeros(total, device=p.device)
        present[pseudo.reshape(-1)] = 1.0
        cand.append((flat.amax(dim=1), torch.argmax(flat, dim=1), present))
    return torch.stack(sums), cand


def loss_core_fwd_reference(xcat: torch.Tensor, label: torch.Tensor, conf: torch.Tensor,
                            t1: torch.Tensor, t2: torch.Tensor, *, num_classes: int,
                            threshold_high: float, ignore_label: int = 255,
                            chunk_rows: int = 64, band=None):
    """Plain version of the forward kernel, differentiable in ``xcat``, ``t1``, ``t2``.

    Streams over chunks of ``chunk_rows`` output rows (any positive value; the last
    chunk may be shorter), each under ``torch.utils.checkpoint`` so that autograd keeps
    no full-resolution intermediate, like the JAX package's checkpointed ``lax.scan``.
    The anchor carry keeps, per image, the strict-'>' running maximum over chunks in
    row order, then combines the images in batch order: the first occurrence in
    global batch-major flat order. ``band``: the module docstring. Returns (sums, amax,
    aidx, presence).
    """
    b, h8, w8, _ = xcat.shape
    r_lo, r_hi, hh = band_rows(label, band)
    ww = label.shape[2]
    total = t1.shape[0]
    taps = _taps(h8, w8, hh, ww, xcat.device)
    xcat = xcat.float()
    sums = torch.zeros((2, 8), dtype=torch.float32, device=xcat.device)
    amax = torch.full((2, b, total), -float("inf"), device=xcat.device)
    aidx = torch.zeros((2, b, total), dtype=torch.long, device=xcat.device)
    presence = torch.zeros((2, total), device=xcat.device)
    for r0, r1 in _row_chunks(r_hi, chunk_rows, r_lo):
        s, cand = checkpoint(
            _chunk_forward, xcat, t1, t2, label[:, r0 - r_lo:r1 - r_lo],
            conf[:, r0 - r_lo:r1 - r_lo], taps, r0, r1, num_classes, threshold_high,
            ignore_label, use_reentrant=False)
        sums = sums + s
        for hd, (m, i, ex) in enumerate(cand):
            better = m > amax[hd]
            amax[hd] = torch.where(better, m, amax[hd])
            aidx[hd] = torch.where(better, i + r0 * ww, aidx[hd])
            presence[hd] = torch.maximum(presence[hd], ex)
    out_max = torch.full((2, total), -float("inf"), device=xcat.device)
    out_idx = torch.zeros((2, total), dtype=torch.long, device=xcat.device)
    for bi in range(b):  # batch-major: an earlier image keeps a tie
        better = amax[:, bi] > out_max
        out_max = torch.where(better, amax[:, bi], out_max)
        out_idx = torch.where(better, aidx[:, bi] + bi * hh * ww, out_idx)
    return sums, out_max, out_idx.to(torch.int32), presence


def _head_grad(h: dict, g: torch.Tensor, ignore: int):
    """d(sum . g)/dp (B, rows, W, C+O) and the per-pixel noisy-posterior factor
    ``sm * dq`` for dT, for one head: the formulas of ``_bwd_kernel`` (loss_fused.py
    :383-471) as tensor code."""
    p, sm = h["p"], h["sm"]
    ch = torch.arange(p.shape[-1], device=p.device)

    def ce_grad(soft, lbl):
        oh = (ch == lbl[..., None]).float()
        return (soft - oh) * _valid(lbl, ignore)[..., None].float()

    d = g[0] * ce_grad(sm, h["refined"]) + g[2] * ce_grad(sm, h["known"])
    smu = h["eu"] * (1.0 / h["denu"])[..., None]
    d_unk = g[4] * ce_grad(smu, h["place_y"])
    d = d + torch.where(h["onehot_arg"], torch.zeros_like(d_unk), d_unk)
    # A valid label >= C picks no column of q: it adds inf to the loss and nothing here.
    inv = torch.where(h["has_y"], 1.0 / h["picked"], torch.zeros_like(h["picked"]))
    dq = -g[6] * inv
    dsm = h["tcol"] * dq[..., None]
    d = d + sm * (dsm - (dsm * sm).sum(dim=-1, keepdim=True))
    return d, sm * dq[..., None]


def _chunk_cotangents(g_sums, xcat, label_c, conf_c, t1, t2, taps, r0, r1, c,
                      threshold_high, ignore):
    """Output rows [r0, r1) (``label_c``, ``conf_c`` their rows): the per-pixel
    cotangents (B, rows, W, cat) of both heads' upsampled logits, and per head (sm * dq
    (B, rows, W, C+O), label column (B, rows, W), has_y (B, rows, W)), the terms whose
    sum over the pixels of each label is dT."""
    total = t1.shape[0]
    z = _upsample_rows(xcat, taps, r0, r1)
    p1, p2 = z[..., :total], z[..., total:]
    pseudo2 = torch.argmax(p2, dim=-1)
    refined = _refine(conf_c, pseudo2, c, ignore)
    dps, dts = [], []
    for hd, (p, t) in enumerate(((p1, t1), (p2, t2))):
        h = _head(p, torch.argmax(p, dim=-1), refined, label_c, t.float(), c,
                  threshold_high, ignore)
        d, smdq = _head_grad(h, g_sums[hd], ignore)
        dps.append(d)
        dts.append((smdq, h["ysafe"], h["has_y"]))
    return torch.cat(dps, dim=-1), dts


def loss_core_bwd_reference(g_sums: torch.Tensor, xcat: torch.Tensor,
                            label: torch.Tensor, conf: torch.Tensor, t1: torch.Tensor,
                            t2: torch.Tensor, *, num_classes: int, threshold_high: float,
                            ignore_label: int = 255, chunk_rows: int = 64, band=None):
    """Plain version of the backward kernel: (dxcat, dT1, dT2) for the cotangent
    ``g_sums`` (2, 8) of the sums (the counts' entries are ignored: counts are
    piecewise constant). Recomputes each chunk's forward, forms the per-pixel
    cotangents by hand and applies the transposed upsample. ``band`` as the forward's."""
    b, h8, w8, cat = xcat.shape
    r_lo, r_hi, hh = band_rows(label, band)
    ww = label.shape[2]
    total = t1.shape[0]
    taps = _taps(h8, w8, hh, ww, xcat.device)
    xcat = xcat.float()
    g_sums = g_sums.float()
    dx = torch.zeros_like(xcat)
    dts = [torch.zeros((total, num_classes), dtype=torch.float32, device=xcat.device)
           for _ in range(2)]
    with torch.no_grad():
        for r0, r1 in _row_chunks(r_hi, chunk_rows, r_lo):
            dz_out, terms = _chunk_cotangents(
                g_sums, xcat, label[:, r0 - r_lo:r1 - r_lo], conf[:, r0 - r_lo:r1 - r_lo],
                t1, t2, taps, r0, r1, num_classes, threshold_high, ignore_label)
            for hd, (smdq, ysafe, has_y) in enumerate(terms):
                # dT[k, y] += sm[k] * dq at each valid pixel's label column y < C.
                keep = has_y.reshape(-1)
                dts[hd].T.index_add_(0, ysafe.reshape(-1)[keep],
                                     smdq.reshape(-1, total)[keep])
            dz = torch.zeros((b, r1 - r0, w8, cat), dtype=torch.float32,
                             device=xcat.device)
            dz.index_add_(2, taps["lo_w"], taps["w0_w"][:, None] * dz_out)
            dz.index_add_(2, taps["hi_w"], taps["w1_w"][:, None] * dz_out)
            rows = slice(r0, r1)
            dx.index_add_(1, taps["lo_h"][rows], taps["w0_h"][rows, None, None] * dz)
            dx.index_add_(1, taps["hi_h"][rows], taps["w1_h"][rows, None, None] * dz)
    return dx, dts[0], dts[1]


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------


def loss_core_fwd(xcat: torch.Tensor, label: torch.Tensor, conf: torch.Tensor,
                  t1: torch.Tensor, t2: torch.Tensor, *, num_classes: int,
                  threshold_high: float, ignore_label: int = 255, chunk_rows: int = 64,
                  band=None):
    """Forward of the core: (sums (2, 8), amax (2, C+O), aidx (2, C+O) int32,
    presence (2, C+O)). ``xcat`` (B, h8, w8, 2*(C+O)) float32, ``label`` (B, H, W),
    ``conf`` (B, H, W) uint8 teacher labels, ``t1``/``t2`` (C+O, C) float32; with
    ``band=(r0, H)``, ``label`` and ``conf`` hold the output rows [r0, r0 + rows).

    CPU tensors: the plain version (``chunk_rows`` is its streaming chunk). CUDA
    tensors: one launch of kernel B2 (``csrc/loss_fused.cu``), or an exception;
    no fill or copy launches around it. An empty band launches nothing and returns
    what covers no pixel (zero sums, anchor maxima -inf at index 0, no presence).
    """
    _check(xcat, label, conf, t1, t2, num_classes, band)
    if xcat.device.type == "cpu":
        return loss_core_fwd_reference(
            xcat, label, conf, t1, t2, num_classes=num_classes,
            threshold_high=threshold_high, ignore_label=ignore_label,
            chunk_rows=chunk_rows, band=band)
    b, h8, w8, cat = xcat.shape
    r_lo, r_hi, hh = band_rows(label, band)
    ww = label.shape[2]
    total = cat // 2
    dev = xcat.device
    if r_hi == r_lo:
        return (torch.zeros((2, 8), device=dev),
                torch.full((2, total), -float("inf"), device=dev),
                torch.zeros((2, total), dtype=torch.int32, device=dev),
                torch.zeros((2, total), device=dev))
    taps_i, taps_f = device_tables(h8, w8, hh, ww, dev)
    sched, tabs, _, _ = device_schedule(b, h8, w8, hh, ww, cat, num_classes, r_lo, r_hi,
                                        dev)
    stream = _stream(dev)
    words = _words(dev, stream, _BWD_TICKETS)
    partials = torch.empty((sched.n_blocks, 16), dtype=torch.float32, device=dev)
    sums = torch.empty((2, 8), dtype=torch.float32, device=dev)
    amax = torch.empty((2, total), dtype=torch.float32, device=dev)
    aidx = torch.empty((2, total), dtype=torch.int32, device=dev)
    presence = torch.empty((2, total), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.simt_loss_core_fwd(
        xcat.data_ptr(), label.data_ptr(), conf.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        taps_i.data_ptr(), taps_f.data_ptr(), tabs.data_ptr(), sched.n_blocks,
        sched.jmax, partials.data_ptr(), words.data_ptr(), _word(words, _PRES_WORD),
        _word(words, _FWD_TICKET), sums.data_ptr(), amax.data_ptr(), aidx.data_ptr(),
        presence.data_ptr(), h8, w8, hh, ww, r_lo, r_hi - r_lo, num_classes, total,
        float(threshold_high), int(ignore_label), stream)
    _raise_on(lib, err, "loss_core_fwd")
    loss_core_fwd.launches += 1
    return sums, amax, aidx, presence


loss_core_fwd.launches = 0


def loss_core_bwd(g_sums: torch.Tensor, xcat: torch.Tensor, label: torch.Tensor,
                  conf: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, *,
                  num_classes: int, threshold_high: float, ignore_label: int = 255,
                  chunk_rows: int = 64, band=None):
    """Backward of the core: (dxcat, dT1, dT2) for the cotangent ``g_sums`` (2, 8) of
    the sums. Arguments as ``loss_core_fwd``. CPU tensors: the plain version; CUDA
    tensors: one launch of kernel B3, or an exception (an empty band: zeros, no
    launch)."""
    _check(xcat, label, conf, t1, t2, num_classes, band)
    if g_sums.shape != (2, 8):
        raise ValueError(f"g_sums must be (2, 8), got {tuple(g_sums.shape)}")
    if xcat.device.type == "cpu":
        return loss_core_bwd_reference(
            g_sums, xcat, label, conf, t1, t2, num_classes=num_classes,
            threshold_high=threshold_high, ignore_label=ignore_label,
            chunk_rows=chunk_rows, band=band)
    b, h8, w8, cat = xcat.shape
    r_lo, r_hi, hh = band_rows(label, band)
    ww = label.shape[2]
    total = cat // 2
    dev = xcat.device
    if r_hi == r_lo:
        zero_t = torch.zeros_like(t1)
        return torch.zeros_like(xcat), zero_t, zero_t.clone()
    taps_i, taps_f = device_tables(h8, w8, hh, ww, dev)
    sched, tabs, off_row, off_blk = device_schedule(b, h8, w8, hh, ww, cat, num_classes,
                                                    r_lo, r_hi, dev)
    stream = _stream(dev)
    words = _words(dev, stream, _BWD_TICKETS + b * h8 + sched.n_groups + 1)
    g = g_sums.detach().to(device=dev, dtype=torch.float32).contiguous()
    tc = cat * num_classes
    part = torch.empty((sched.part_floats,), dtype=torch.float32, device=dev)
    dt_part = torch.empty((sched.n_blocks, tc), dtype=torch.float32, device=dev)
    dt_grp = torch.empty((sched.n_groups, tc), dtype=torch.float32, device=dev)
    dx = torch.empty_like(xcat)
    dt = torch.empty((2, total, num_classes), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.simt_loss_core_bwd(
        g.data_ptr(), xcat.data_ptr(), label.data_ptr(), conf.data_ptr(), t1.data_ptr(),
        t2.data_ptr(), taps_i.data_ptr(), taps_f.data_ptr(), tabs.data_ptr(),
        sched.n_blocks, _word(tabs, off_row), _word(tabs, off_blk), sched.jmax,
        sched.kmax, sched.maxc, part.data_ptr(), dt_part.data_ptr(), dt_grp.data_ptr(),
        _word(words, _BWD_TICKETS), dx.data_ptr(), dt.data_ptr(), b, h8, w8, hh, ww, r_lo,
        r_hi - r_lo, num_classes, total, float(threshold_high), int(ignore_label), stream)
    _raise_on(lib, err, "loss_core_bwd")
    loss_core_bwd.launches += 1
    return dx, dt[0], dt[1]


loss_core_bwd.launches = 0


class SimTLossCore(torch.autograd.Function):
    """The streamed core behind one autograd node: forward ``loss_core_fwd``,
    backward ``loss_core_bwd`` (each the kernel on CUDA tensors, the plain version on
    CPU tensors). Differentiable in ``xcat``, ``t1``, ``t2``; the anchor carries take no
    gradient. ``band`` as ``loss_core_fwd``'s. Under a profiler each call is a range
    ``simt_tpu_torch.loss_core`` (``utils/spans.py``)."""

    @staticmethod
    def forward(ctx, xcat, t1, t2, label, conf, num_classes, threshold_high,
                ignore_label, band=None):
        with span("loss_core"):
            out = loss_core_fwd(xcat, label, conf, t1, t2, num_classes=num_classes,
                                threshold_high=threshold_high, ignore_label=ignore_label,
                                band=band)
        ctx.save_for_backward(xcat, t1, t2, label, conf)
        ctx.args = (num_classes, threshold_high, ignore_label, band)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_sums, *_):
        xcat, t1, t2, label, conf = ctx.saved_tensors
        num_classes, threshold_high, ignore_label, band = ctx.args
        with span("loss_core"):
            dx, dt1, dt2 = loss_core_bwd(g_sums, xcat, label, conf, t1, t2,
                                         num_classes=num_classes,
                                         threshold_high=threshold_high,
                                         ignore_label=ignore_label, band=band)
        return dx, dt1, dt2, None, None, None, None, None, None


# Per-pixel operation counts of the kernels' cost model (csrc/loss_fused.cu): the
# W taps of both heads (3 per channel); per head in the forward max, subtract, exp,
# add and multiply for the softmax (5), the same four for the placeholder's suppressed
# logits (4), two for the picked posterior and three argmax compares (14 per channel);
# in the backward the forward's 9 plus the suppressed softmax again (3), the four
# cotangent terms (12), the posterior and dT products (5): 29 per channel; the
# transposed W taps (2 per channel per tap) and the H taps and their transpose per
# source column (3 and 4 per channel per output row).
_FWD_PER_PIXEL_CH = 3 * 2 + 14 * 2  # per head channel, both heads
_BWD_PER_PIXEL_CH = 3 * 2 + 29 * 2 + 4 * 2

# The special-function units' results/s of an H100 SXM (16 a clock on each of 132 SMs at
# the 1.98 GHz boost clock: expf, logf and reciprocals); its other peaks are
# ``device.py``'s.
PEAK_SFU_S = 16 * 132 * 1.98e9


def work(batch: int, h8: int, w8: int, hh: int, ww: int, num_classes: int,
         open_classes: int, place: int | None = None,
         labelled: int | None = None) -> dict:
    """Bytes, float32 operations and special-function operations each kernel needs for
    one call at these shapes: each input read once and each output written once (xcat
    f32, label int32, conf uint8, both T; the forward's 64 output floats, the backward's
    dxcat and dT), the operations of the kernels' cost model above, and per head and
    pixel the softmax's C+O expf and one reciprocal, with the forward's logf of the
    denominator; where the placeholder's label is valid (``place`` head-pixels) the
    suppressed softmax's C+O expf and a logf (forward) or a reciprocal (backward); where
    the label is valid (``labelled`` head-pixels) the posterior's logf (forward) or
    reciprocal (backward). ``place`` and ``labelled`` are what the data needs (the
    forward's counts sums[:, 5] and sums[:, 7] give them); None counts every head-pixel.
    Returns {"fwd": (bytes, ops, sfu), "bwd": (bytes, ops, sfu)}."""
    total = num_classes + open_classes
    cat = 2 * total
    pixels = batch * hh * ww
    head_pixels = 2 * pixels
    place = head_pixels if place is None else int(place)
    labelled = head_pixels if labelled is None else int(labelled)
    x_bytes = batch * h8 * w8 * cat * 4
    t_bytes = 2 * total * num_classes * 4
    in_bytes = x_bytes + pixels * (4 + 1) + t_bytes
    fwd_bytes = in_bytes + (16 + 3 * 2 * total) * 4
    bwd_bytes = in_bytes + 16 * 4 + x_bytes + t_bytes
    h_step = batch * hh * w8 * cat * 3
    fwd_ops = pixels * total * _FWD_PER_PIXEL_CH + h_step
    bwd_ops = pixels * total * _BWD_PER_PIXEL_CH + h_step + batch * hh * w8 * cat * 4
    sfu = head_pixels * (total + 1) + place * (total + 1) + labelled
    return {"fwd": (fwd_bytes, fwd_ops, sfu + head_pixels),
            "bwd": (bwd_bytes, bwd_ops, sfu)}


def bound(nbytes: float, ops: float, sfu: float) -> Tuple[float, str, str]:
    """(ms, bound_by, term): the least time the card could take for ``work``'s counts,
    the largest of the bytes at PEAK_BYTES_S, the float32 operations at PEAK_F32_FLOP_S
    and the special-function operations at PEAK_SFU_S; ``bound_by`` is "bytes" or
    "operations", ``term`` names the binding one ("bytes", "float32" or "sfu")."""
    terms = {"bytes": nbytes / PEAK_BYTES_S, "float32": ops / PEAK_F32_FLOP_S,
             "sfu": sfu / PEAK_SFU_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


# Shared memory of an SM on sm_90 (233,472 bytes), the most one block can take
# (232,448) and what the runtime reserves for each block (1 KB).
_SM_SMEM, _MAX_SMEM, _BLOCK_RESERVED = 233472, 232448, 1024


def _bwd_smem(kmax: int, jmax: int, maxc: int, w8: int, cat: int, num_classes: int) -> int:
    """Bytes of shared memory of B3's block (csrc/loss_fused.cu::bwd_smem; B2's is
    smaller): the finish's block lists and the segment's tap ranges, the W weights, both
    heads' T and the warps' dT, then the H step, the cotangent tile and the band's
    accumulator of kmax source rows (or, in the finish, one source row)."""
    ints = 4 + ((kmax + 3) & ~3) + 3 * ((maxc + 3) & ~3) + 4 * jmax
    loop = jmax * cat + PASS_PIXELS * (cat + 1) + kmax * jmax * cat
    floats = (2 * PASS_PIXELS + (1 + BLOCK_THREADS // 32) * cat * num_classes
              + max(loop, w8 * cat))
    return 4 * (ints + floats)


def bwd_smem_bytes(sched: Schedule, w8: int, total: int, num_classes: int) -> int:
    return _bwd_smem(sched.kmax, sched.jmax, sched.maxc, w8, 2 * total, num_classes)


def _check(xcat, label, conf, t1, t2, num_classes, band=None) -> None:
    if xcat.dim() != 4 or label.dim() != 3 or conf.shape != label.shape:
        raise ValueError(
            f"expected (B,h8,w8,2*(C+O)) xcat, (B,H,W) label and conf, got "
            f"{tuple(xcat.shape)}, {tuple(label.shape)}, {tuple(conf.shape)}")
    total = t1.shape[0]
    if (xcat.shape[-1] != 2 * total or t1.shape != (total, num_classes)
            or t2.shape != t1.shape):
        raise ValueError(f"xcat channels {xcat.shape[-1]} and T shapes "
                         f"{tuple(t1.shape)}/{tuple(t2.shape)} do not match "
                         f"C={num_classes}")
    if xcat.shape[0] != label.shape[0]:
        raise ValueError("xcat and label batch sizes differ")
    devices = {xcat.device, label.device, conf.device, t1.device, t2.device}
    if len(devices) != 1:
        raise ValueError(f"inputs must be on one device, got {devices}")
    if xcat.device.type == "cpu":
        return
    if xcat.device.type != "cuda":
        raise ValueError(f"unsupported device {xcat.device} (expected cpu or cuda)")
    if total not in SUPPORTED_TOTALS:
        raise ValueError(f"C+O={total} is not compiled into the kernel "
                         f"(supported: {SUPPORTED_TOTALS})")
    if not (xcat.dtype == t1.dtype == t2.dtype == torch.float32):
        raise TypeError("CUDA kernel takes float32 xcat and T")
    if label.dtype != torch.int32 or conf.dtype != torch.uint8:
        raise TypeError(f"CUDA kernel takes int32 label and uint8 conf, got "
                        f"{label.dtype}/{conf.dtype}")
    if not all(t.is_contiguous() for t in (xcat, label, conf, t1, t2)):
        raise ValueError("CUDA kernel takes contiguous tensors")
    b, _, ww = label.shape
    r_lo, r_hi, hh = band_rows(label, band)
    if b * hh * ww >= 2**31:
        raise ValueError("batch x H x W must stay below 2**31 (int32 anchor indices)")
    if r_hi == r_lo:
        return
    sched = schedule(b, xcat.shape[1], xcat.shape[2], hh, ww, 2 * total, num_classes,
                     r_lo, r_hi)
    if bwd_smem_bytes(sched, xcat.shape[2], total, num_classes) > _MAX_SMEM:
        raise ValueError(f"a block of {sched.jmax} source columns x {sched.kmax} rows "
                         f"needs more than {_MAX_SMEM} bytes of shared memory")


def _word(t: torch.Tensor, i: int) -> int:
    """The address of element ``i`` of the int32 tensor ``t``."""
    return t.data_ptr() + 4 * i


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.simt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("loss_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.simt_loss_core_fwd.argtypes = [p] * 8 + [i] * 2 + [p] * 8 + [i] * 8 + [f, i, p]
    lib.simt_loss_core_fwd.restype = i
    lib.simt_loss_core_bwd.argtypes = ([p] * 9 + [i] + [p] * 2 + [i] * 3 + [p] * 6
                                       + [i] * 9 + [f, i, p])
    lib.simt_loss_core_bwd.restype = i
    lib.simt_cuda_error_string.argtypes = [i]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib
