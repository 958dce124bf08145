"""The streamed full-resolution losses (counterpart of ``simt_tpu/ops/fused_losses.py``):
the SimT loss block and the warmup stage's ``upsample_ce``.

The reference evaluates its losses on logits upsampled to the 512x1024 crop
(tools/trainV2_simt.py:370-409); done naively that keeps dozens of (B, 512, 1024, 34)
float32 tensors and their gradients in device memory. ``simt_loss_block`` has three
parts, as in the JAX package:

  1. pass 1, no gradient: the teacher posterior upsampled (``ops/interp.py``, two
     matmuls) and thresholded into a uint8 label map ``conf`` (argmax where the max
     probability exceeds ``threshold_high``, class C where it is below
     ``threshold_low``, else ignore; :354-362);
  2. the streamed core on the concatenated logits of both heads: on a CUDA device the
     ``SimTLossCore`` autograd node (kernels B2/B3, ``ops/kernels/loss_fused.py``); on
     the CPU its plain version, streamed over output-row chunks each under
     ``torch.utils.checkpoint``, differentiated by autograd;
  3. ``_finish_losses``: masked means from the 16 (sum, count) accumulators, the
     teacher posterior rows at the winning anchor pixels, and the anchor and
     placeholder compositions (:374-384, :398-399).

With a ``group`` (``parallel/mesh.py``) of more than one rank, each rank holds a block
of the global batch and ``_global_finish`` makes the finish the global batch's, as the
JAX program's: every mean is the rank's local sum over the count summed across the
ranks (the ranks' losses sum to the global mean; B3's cotangent is 1 / the global
count), and the anchor is the global first-occurrence winner, its teacher rows sent
from one rank that holds the pixel's image. On the spatial axis a rank holds a band of
each image's output rows, ``band=(r0, H)``: its label rows, the whole stride-8 logits
and teacher posterior (gathered), and the kernels walk only the band's rows.

``upsample_ce`` is the warmup loss (trainV1_warmup.py:219-224): align-corners upsample
of one head's stride-8 logits and the masked CE mean, streamed over output-row chunks
each under ``torch.utils.checkpoint``. The JAX package computes it in XLA (a
checkpointed ``lax.scan``), so it is plain PyTorch on both devices here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed import ProcessGroup
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_
from .interp import _interp_matrix, upsample_bilinear_align_corners
from .kernels.loss_fused import (SimTLossCore, _row_chunks, band_rows,
                                 loss_core_fwd_reference)
from .losses import _valid_and_safe


def _finish_mean(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.zeros_like(s))


def teacher_conf(teacher_prob8: torch.Tensor, out_hw, *, num_classes: int,
                 threshold_high: float, threshold_low: float,
                 ignore_label: int = 255, rows: Optional[Tuple[int, int]] = None
                 ) -> torch.Tensor:
    """Pass 1: the two-threshold teacher labels (B, H, W) uint8 (trainV2_simt.py:
    354-362) from the stride-8 teacher posterior (B, h8, w8, C); ``rows=(r0, r1)``
    gives only the output rows [r0, r1) (the rows ``a_h[r0:r1]`` of the upsample)."""
    with torch.no_grad():
        tch = upsample_bilinear_align_corners(teacher_prob8.float(), tuple(out_hw), rows)
        tmax, targ = tch.max(dim=-1)
        conf = torch.where(tmax > threshold_high, targ, torch.full_like(targ, ignore_label))
        conf = torch.where(tmax < threshold_low, torch.full_like(targ, num_classes), conf)
        return conf.to(torch.uint8)


def simt_loss_block(
    x1: torch.Tensor,
    x2: torch.Tensor,
    teacher_prob8: torch.Tensor,
    label: torch.Tensor,
    t1m: torch.Tensor,
    t2m: torch.Tensor,
    *,
    num_classes: int,
    open_classes: int,
    threshold_high: float,
    threshold_low: float,
    lambda_place: float,
    lambda_seg: float,
    ignore_label: int = 255,
    chunk_rows: int = 64,
    group: Optional[ProcessGroup] = None,
    band: Optional[Tuple[int, int]] = None,
    first_image: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """All full-resolution SimT losses (trainV2_simt.py:351-409) in one streamed pass.

    Stride-8 NHWC inputs: ``x1``/``x2`` student logits (B, h8, w8, C+O),
    ``teacher_prob8`` teacher softmax (B, h8, w8, C); ``label`` the full-resolution
    pseudo label (B, H, W). Returns the scalar losses {loss_p1, loss_p2, loss_y1,
    loss_y2, place, anchor}, differentiable in x1, x2, t1m, t2m. ``chunk_rows`` is the
    CPU core's streaming chunk (any positive value; the math does not depend on it).

    ``group``: the ranks over which the global batch is spread (None for one process).
    The four CE means and ``place`` are then this rank's shares (they sum over the
    ranks to the global batch's values) and ``anchor`` is the global batch's, the same
    on every rank. This rank's images are the global batch's ``[first_image,
    first_image + B)`` (default: the group rank times B, a data group of equal blocks).
    ``band=(r0, H)``: ``label`` holds the output rows [r0, r0 + rows) of images of H
    rows and the losses cover those rows (None: the whole image); the rank whose band
    starts at row 0 answers for its images' anchor rows.
    """
    r0, r1, hh = band_rows(label, band)
    ww = label.shape[2]
    xcat = torch.cat([x1.float(), x2.float()], dim=-1)
    conf = teacher_conf(teacher_prob8, (hh, ww), num_classes=num_classes,
                        threshold_high=threshold_high, threshold_low=threshold_low,
                        ignore_label=ignore_label,
                        rows=None if band is None else (r0, r1))
    if xcat.device.type == "cuda":
        sums, amax, aidx, presence = SimTLossCore.apply(
            xcat.contiguous(), t1m.float().contiguous(), t2m.float().contiguous(),
            label.to(torch.int32).contiguous(), conf, num_classes,
            float(threshold_high), int(ignore_label), band)
    else:
        sums, amax, aidx, presence = loss_core_fwd_reference(
            xcat, label, conf, t1m.float(), t2m.float(), num_classes=num_classes,
            threshold_high=threshold_high, ignore_label=ignore_label,
            chunk_rows=chunk_rows, band=band)
        if r1 == r0:
            # No row: still a node of xcat (its gather's backward is a collective) and
            # of T (every rank's gradients are summed, so every rank has one).
            sums = sums + 0.0 * (xcat.sum() + t1m.float().sum() + t2m.float().sum())
    return _finish_losses(sums, amax, aidx, presence, teacher_prob8.float(), t1m.float(),
                          t2m.float(), hh=hh, ww=ww, lambda_place=lambda_place,
                          lambda_seg=lambda_seg, group=group, first_image=first_image,
                          answers=r0 == 0)


def _finish_losses(sums, amax, aidx, presence, teacher_prob8, t1m, t2m, *, hh, ww,
                   lambda_place, lambda_seg, group=None, first_image=None,
                   answers=True) -> Dict[str, torch.Tensor]:
    """Masked means of the (2, 8) accumulators, anchor teacher rows at the winning
    pixels, and the anchor/place compositions (trainV2_simt.py:374-384, :398-399);
    over the ``group``'s global batch when one is given (``_global_finish``)."""
    b, h8, w8, _ = teacher_prob8.shape
    dev = teacher_prob8.device
    a_h = torch.from_numpy(_interp_matrix(h8, hh)).to(dev)
    a_w = torch.from_numpy(_interp_matrix(w8, ww)).to(dev)

    def teacher_rows_at(glob_idx):
        """Upsampled teacher posterior (C+O, C) at the anchor pixels: the same
        H-then-W contraction as pass 1, evaluated only at those pixels."""
        glob_idx = glob_idx.long()
        bi = glob_idx // (hh * ww)
        rem = glob_idx % (hh * ww)
        z = torch.einsum("th,thwc->twc", a_h[rem // ww], teacher_prob8[bi])
        return torch.einsum("tw,twc->tc", a_w[rem % ww], z)

    counts = sums[:, 1::2]
    if group is None:
        rows = (teacher_rows_at(aidx[0]), teacher_rows_at(aidx[1]))
    else:
        import torch.distributed as dist

        first = dist.get_rank(group) * b if first_image is None else first_image
        counts, rows, presence = _global_finish(counts, amax, aidx, presence,
                                                teacher_rows_at, b * hh * ww,
                                                first * hh * ww, answers, group)
    m = [_finish_mean(sums[h, 2 * k], counts[h, k]) for h in range(2) for k in range(4)]
    (loss_p1, known1, unk1, loss_y1, loss_p2, known2, unk2, loss_y2) = m
    place = (lambda_seg * (known1 + lambda_place * unk1)
             + known2 + lambda_place * unk2)
    anchor = ((presence[0, :, None] * (t1m - rows[0]) ** 2).sum()
              + (presence[1, :, None] * (t2m - rows[1]) ** 2).sum())
    return {"loss_p1": loss_p1, "loss_p2": loss_p2, "loss_y1": loss_y1,
            "loss_y2": loss_y2, "place": place, "anchor": anchor}


def _global_finish(counts, amax, aidx, presence, teacher_rows_at, pixels: int,
                   first: int, answers: bool, group: ProcessGroup):
    """The finish's data over the group's global batch, this rank's images being the
    ``pixels`` pixels ``[first, first + pixels)`` of the batch-major flat order (``aidx``
    indexes them), in three all-reduces: MAX of the anchor maxima and the presence; MIN
    of each rank's candidate global index (its winner where it holds the global
    maximum): the first occurrence wins a tie, as the JAX package's argmax does; SUM of
    the counts and of the teacher rows at the winners, each row from the one rank that
    holds its image and ``answers`` for it (of the ranks sharing an image's rows, the
    one whose band starts at row 0) and zeros elsewhere. Returns (global counts (2, 4),
    rows (2, C+O, C), presence (2, C+O))."""
    total = amax.shape[1]
    both = all_reduce_(torch.cat([amax.reshape(-1), presence.reshape(-1)]), group, "max")
    gmax, presence = both[:2 * total].view(2, total), both[2 * total:].view(2, total)
    lowest = torch.full_like(aidx, torch.iinfo(torch.int64).max, dtype=torch.int64)
    cand = all_reduce_(torch.where(amax == gmax, aidx.long() + first, lowest), group, "min")
    own = (cand >= first) & (cand < first + pixels) & answers
    local = torch.where(own, cand - first, torch.zeros_like(cand))
    rows = torch.stack([torch.where(own[h, :, None], teacher_rows_at(local[h]), 0.0)
                        for h in range(2)])
    flat = all_reduce_(torch.cat([counts.detach().reshape(-1), rows.reshape(-1)]), group)
    return flat[:counts.numel()].view(counts.shape), flat[counts.numel():].view(
        rows.shape), presence


def _ce_chunk_sums(logits: torch.Tensor, a_h_c: torch.Tensor, a_w: torch.Tensor,
                   label_c: torch.Tensor, ignore_label: int) -> Tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """(sum of the CE over the valid pixels, their count) of one chunk of output rows:
    the H step then the W step of the upsample (two matmuls), then the masked CE."""
    z = torch.einsum("rh,bhwc->brwc", a_h_c, logits)
    pred = torch.einsum("Ww,brwc->brWc", a_w, z)
    valid, safe = _valid_and_safe(label_c, ignore_label)
    lz = torch.logsumexp(pred, dim=-1)
    picked = torch.gather(pred, -1, safe[..., None])[..., 0]
    vf = valid.to(pred.dtype)
    return ((lz - picked) * vf).sum(), vf.sum()


def upsample_ce(logits: torch.Tensor, label: torch.Tensor, *, ignore_label: int = 255,
                chunk_rows: int = 64, group: Optional[ProcessGroup] = None,
                band: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Align-corners upsample of (B, h8, w8, C) logits to the (B, H, W) label's size and
    the masked CE mean over the valid pixels (0 when none is valid), in float32
    (simt_tpu/ops/fused_losses.py:324-354). Streamed over chunks of ``chunk_rows``
    output rows (any positive value; the last chunk may be shorter), each recomputed in
    the backward, so no (B, H, W, C) tensor is ever held. With a ``group``, this
    rank's sum over the count summed across its ranks. ``band=(r0, H)``: ``label``
    holds the output rows [r0, r0 + rows) of images of H rows (``simt_loss_block``)."""
    _, h8, w8, _ = logits.shape
    r_lo, r_hi, hh = band_rows(label, band)
    ww = label.shape[2]
    dev = logits.device
    a_h = torch.from_numpy(_interp_matrix(h8, hh)).to(dev)
    a_w = torch.from_numpy(_interp_matrix(w8, ww)).to(dev)
    x = logits.float()
    s = n = None
    for r0, r1 in _row_chunks(r_hi, chunk_rows, r_lo):
        s_c, n_c = checkpoint(_ce_chunk_sums, x, a_h[r0:r1], a_w,
                              label[:, r0 - r_lo:r1 - r_lo], ignore_label,
                              use_reentrant=False)
        s, n = (s_c, n_c) if s is None else (s + s_c, n + n_c)
    if s is None:  # no row: a node of the logits still (their gather's backward)
        s, n = 0.0 * x.sum(), x.new_zeros(())
    if group is not None:
        n = all_reduce_(n.detach().clone(), group)
    return _finish_mean(s, n)
