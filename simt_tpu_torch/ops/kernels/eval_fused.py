"""Fused multi-scale eval head: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``simt_tpu/ops/pallas/eval_fused.py``. The reference eval protocol
(evaluate_cityscapes.py:127-148) upsamples head-2 logits from both input scales to
1024x2048 with align-corners bilinear, sums them, takes the per-pixel argmax and adds a
19x19 confusion histogram against the remapped ground truth. The kernel
(``csrc/eval_fused.cu``) does all of it in one pass; only the histogram is written.

``multiscale_argmax_hist`` dispatches on the tensors' device: on the CPU it runs
``multiscale_argmax_hist_reference``; on a CUDA device it launches the kernel (and adds
one to ``multiscale_argmax_hist.launches``) or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..interp import interp_taps, upsample_bilinear_align_corners
from ..metrics import fast_hist
from . import _build


def multiscale_argmax_hist_reference(
    logits_a: torch.Tensor,
    logits_b: torch.Tensor,
    gt: torch.Tensor,
    *,
    out_hw: Tuple[int, int] = (1024, 2048),
    num_classes: int = 19,
) -> torch.Tensor:
    """Plain version: upsample both scales (two matmuls each), sum, argmax, fast_hist.

    ``logits_*``: (B, h8, w8, C) float32 NHWC; ``gt``: (B, H, W) integer. Returns the
    (C, C) int32 histogram summed over the batch.
    """
    la, lb, gt = _as_batch(logits_a, logits_b, gt)
    pred = upsample_bilinear_align_corners(la.float(), out_hw)
    pred = pred + upsample_bilinear_align_corners(lb.float(), out_hw)
    return fast_hist(gt, torch.argmax(pred, dim=-1), num_classes)


def multiscale_argmax_hist(
    logits_a: torch.Tensor,
    logits_b: torch.Tensor,
    gt: torch.Tensor,
    *,
    out_hw: Tuple[int, int] = (1024, 2048),
    num_classes: int = 19,
) -> torch.Tensor:
    """Fused eval head: (B, h8a, w8a, C) + (B, h8b, w8b, C) float32 logits and (B, H, W)
    ground truth -> (C, C) int32 confusion histogram summed over the batch. A single
    image may be passed without the batch dimension, as in the JAX package.

    On CUDA tensors all three must be contiguous, the logits float32 and ``gt`` int32.
    """
    la, lb, gt = _as_batch(logits_a, logits_b, gt)
    _check(la, lb, gt, out_hw, num_classes)
    dev = la.device
    if dev.type == "cpu":
        return multiscale_argmax_hist_reference(la, lb, gt, out_hw=out_hw,
                                                num_classes=num_classes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    taps_i, taps_f = device_taps(la.shape[1], la.shape[2], lb.shape[1], lb.shape[2],
                                 tuple(out_hw), dev)
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=dev)
    launch(la, lb, gt, taps_i, taps_f, hist)
    return hist


multiscale_argmax_hist.launches = 0


def launch(la: torch.Tensor, lb: torch.Tensor, gt: torch.Tensor, taps_i: torch.Tensor,
           taps_f: torch.Tensor, hist: torch.Tensor) -> None:
    """Add the histogram of the batch into ``hist`` with one kernel launch on the
    current stream. Arguments as checked by ``multiscale_argmax_hist``."""
    lib = _lib()
    b, ha, wa, c = la.shape
    _, hb, wb, _ = lb.shape
    _, hh, ww = gt.shape
    stream = torch.cuda.current_stream(la.device).cuda_stream
    err = lib.simt_eval_fused_hist(
        la.data_ptr(), lb.data_ptr(), gt.data_ptr(), taps_i.data_ptr(),
        taps_f.data_ptr(), hist.data_ptr(), b, ha, wa, hb, wb, hh, ww, c, stream,
    )
    if err != 0:
        msg = lib.simt_cuda_error_string(err).decode()
        raise RuntimeError(f"eval_fused kernel launch failed: {msg} ({err})")
    multiscale_argmax_hist.launches += 1


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
         batch: int, n_counted: int) -> Tuple[int, int]:
    """(bytes, float32 operations) the fused head needs for one call: each input read
    once (gt as int32, logits, tap tables), the histogram written once; the H step for
    every output row and, for the ``n_counted`` pixels whose gt is in [0, C), the two
    W steps, the scale sum and the argmax compares (the kernel's own cost model,
    ``csrc/eval_fused.cu``)."""
    hh, ww = out_hw
    c = num_classes
    nbytes = (batch * (hh * ww * 4 + (ha * wa + hb * wb) * c * 4)
              + 2 * 4 * 4 * (hh + ww) + c * c * 4)
    ops = batch * hh * (wa + wb) * c * 3 + n_counted * 8 * c
    return nbytes, ops


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("eval_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.simt_eval_fused_hist.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.simt_eval_fused_hist.restype = i
    lib.simt_cuda_error_string.argtypes = [i]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _as_batch(la, lb, gt):
    if la.dim() == 3 and lb.dim() == 3 and gt.dim() == 2:
        return la[None], lb[None], gt[None]
    return la, lb, gt


def _check(la, lb, gt, out_hw, num_classes) -> None:
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
    if la.device.type != "cuda":
        return
    if la.dtype != torch.float32 or lb.dtype != torch.float32:
        raise TypeError(f"CUDA kernel takes float32 logits, got {la.dtype}/{lb.dtype}")
    if gt.dtype != torch.int32:
        raise TypeError(f"CUDA kernel takes int32 gt, got {gt.dtype}")
    if not (la.is_contiguous() and lb.is_contiguous() and gt.is_contiguous()):
        raise ValueError("CUDA kernel takes contiguous logits and gt")
    if la.shape[0] > 65535:
        raise ValueError("batch larger than the grid's y limit (65535)")
