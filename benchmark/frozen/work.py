"""The bytes and operations one kernel call needs, counted the same whatever
implements it, and the least time they bound.

Copied at commit 57e0c1f20d09ebc147d8826943b2979c8e4667bf from:

- ``simt_tpu_torch/ops/kernels/conv3x3.py::work`` (B4, B5) -> ``conv3x3_work``;
- ``simt_tpu_torch/ops/kernels/loss_fused.py::work`` and ``bound`` with their cost
  constants ``_FWD_PER_PIXEL_CH`` / ``_BWD_PER_PIXEL_CH`` (B2, B3) -> ``loss_core_work``,
  ``bound``;
- ``simt_tpu_torch/ops/kernels/eval_fused.py::work`` (B1) -> ``eval_head_work``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .peaks import PEAK_BF16_FLOP_S, PEAK_BYTES_S, PEAK_F32_FLOP_S, PEAK_SFU_S

# Per-pixel operation counts of the loss kernels' cost model (csrc/loss_fused.cu): the
# W taps of both heads (3 per channel); per head in the forward 14 per channel; in the
# backward 29, the transposed W taps (2 per channel per tap) and the H taps and their
# transpose per source column (3 and 4 per channel per output row).
_FWD_PER_PIXEL_CH = 3 * 2 + 14 * 2
_BWD_PER_PIXEL_CH = 3 * 2 + 29 * 2 + 4 * 2


def conv3x3_work(batch: int, h: int, w: int, c: int, o: int, itemsize: int,
                 op: str) -> Tuple[int, int]:
    """(bytes, operations) one B4 / B5 call needs, each input read once and each output
    written once: "fwd" reads x (B, H, W, C) and the weight, writes y (B, H, W, O); "dx"
    reads g (B, H, W, O) and the weight, writes dx; "wgrad" reads x and g, writes dw
    (9, C, O) float32. Operations: 2 * pixels * 9 * C * O."""
    pixels = batch * h * w
    ops = 2 * pixels * 9 * c * o
    if op in ("fwd", "dx"):
        nbytes = pixels * (c + o) * itemsize + 9 * c * o * itemsize
    elif op == "wgrad":
        nbytes = pixels * (c + o) * itemsize + 9 * c * o * 4
    else:
        raise ValueError(f"unknown op {op!r} (fwd, dx or wgrad)")
    return nbytes, ops


def conv3x3_bound_s(nbytes: float, ops: float) -> float:
    """Seconds a bf16 conv3x3 call takes at least: bytes at the HBM rate or operations
    at the bf16 tensor-core peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOP_S)


def loss_core_work(batch: int, h8: int, w8: int, hh: int, ww: int, num_classes: int,
                   open_classes: int, place: Optional[int] = None,
                   labelled: Optional[int] = None) -> Dict[str, Tuple[int, int, int]]:
    """Bytes, float32 operations and special-function operations B2 ("fwd") and B3
    ("bwd") need for one call: each input read once and each output written once, the
    kernels' cost model, and per head and pixel the softmax's C+O expf and a reciprocal
    (the forward's logf too); ``place`` head-pixels whose placeholder label is valid
    (the suppressed softmax again), ``labelled`` head-pixels whose label is valid (the
    posterior's logf or reciprocal). None counts every head-pixel."""
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


def bound(nbytes: float, ops: float, sfu: float) -> Tuple[float, str]:
    """(seconds, term): the least time of a float32 kernel, the largest of the bytes at
    PEAK_BYTES_S, the float32 operations at PEAK_F32_FLOP_S and the special-function
    operations at PEAK_SFU_S, and which term binds."""
    terms = {"bytes": nbytes / PEAK_BYTES_S, "float32": ops / PEAK_F32_FLOP_S,
             "sfu": sfu / PEAK_SFU_S}
    term = max(terms, key=terms.get)
    return terms[term], term


def eval_head_work(ha: int, wa: int, hb: int, wb: int, out_hw: Tuple[int, int],
                   num_classes: int, batch: int, n_counted: int,
                   gt_bytes: int = 4) -> Tuple[int, int]:
    """(bytes, float32 operations) B1 needs for one call: each input read once (gt at
    ``gt_bytes`` a pixel, both scales' logits, tap tables), the histogram written once;
    the H step for every output row and, for the ``n_counted`` pixels whose gt is in
    [0, C), the two W steps, the scale sum and the argmax compares."""
    hh, ww = out_hw
    c = num_classes
    nbytes = (batch * (hh * ww * gt_bytes + (ha * wa + hb * wb) * c * 4)
              + 2 * 4 * 4 * (hh + ww) + c * c * 4)
    ops = batch * hh * (wa + wb) * c * 3 + n_counted * 8 * c
    return nbytes, ops
