"""Cityscapes validation protocol (counterpart of ``simt_tpu/eval/evaluate.py``).

``evaluate_simt`` / ``evaluate_warmup`` of the reference (evaluate_cityscapes.py:96-225):

  - two input scales, 1024x512 and 1280x640 (:103-106);
  - head-2 logits, known-class slice ``[:19]``, upsampled to 1024x2048 with
    align-corners bilinear (:108) and summed across scales in simt mode; warmup mode
    uses the 1024x512 scale only (:196-197);
  - argmax and the 19x19 confusion histogram on the device, in the fused CUDA kernel
    (``ops/kernels/eval_fused.py``), which adds each batch into the running histogram
    (one device operation); the gt crosses to the card as uint8; only the histogram
    leaves the card;
  - batched inference (the reference is locked to batch 1).

Ground-truth ``*_gtFine_labelIds.png`` files are read on the host and remapped through
``info.json['label2train']`` (:140-144).

Not in this slice: the JAX package's ``shard=`` (images across processes) and
``mesh=`` (spatially sharded eval) wait for the parallel slice; ``evaluate`` does not
take them. The row-sharded head that ``mesh=`` runs is ported
(``ops/kernels/eval_fused.py::multiscale_argmax_hist_spatial``).
"""

from __future__ import annotations

import collections
import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..config import EVAL_OUT_HW, EVAL_SCALES, IMG_MEAN_BGR
from ..data.lists import load_info
from ..data.pipeline import Loader, SegDataset, normalize_image
from ..device import resolve_device
from ..ops.interp import upsample_bilinear_align_corners
from ..ops.kernels.eval_fused import multiscale_argmax_hist
from ..ops.metrics import fast_hist, label_mapping, mean_iou, per_class_iu


def make_eval_fn(model: torch.nn.Module, num_classes: int = 19, mode: str = "simt",
                 out_hw: Tuple[int, int] = EVAL_OUT_HW):
    """Eval functions over a model already placed on its device, in eval mode.

    ``predict(image, image_640)`` -> (B, *out_hw) int64 prediction map, through the plain
    upsample + argmax (used when prediction PNGs are saved).
    ``predict_hist(image, image_640, gt, out=None)`` -> (C, C) int32 histogram through
    the fused kernel (on CUDA tensors; its plain version on CPU tensors), added into
    ``out`` when it is given.
    ``hist_update(hist, pred, gt)`` -> running histogram.
    Images are (B, H, W, 3) uint8 BGR (or float32 mean-subtracted) on the model's device.
    """
    if mode not in ("simt", "warmup"):
        raise ValueError(f"mode must be 'simt' or 'warmup', got {mode!r}")
    out_hw = tuple(out_hw)

    @torch.inference_mode()
    def fwd(image: torch.Tensor) -> torch.Tensor:
        """Head-2 logits, known classes, float32 NHWC (evaluate_cityscapes.py:127-133)."""
        x = normalize_image(image, IMG_MEAN_BGR).permute(0, 3, 1, 2)
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        out = model(x)
        out = out[1] if isinstance(out, tuple) else out
        return out[:, :num_classes].float().permute(0, 2, 3, 1).contiguous()

    def scales(image, image_640):
        a = fwd(image)
        if mode == "simt":
            b = fwd(image_640)
        else:
            # Warmup eval is single-scale (evaluate_cityscapes.py:196-197); a constant-0
            # second operand leaves the argmax unchanged.
            b = torch.zeros((a.shape[0], 1, 1, num_classes), dtype=torch.float32,
                            device=a.device)
        return a, b

    @torch.inference_mode()
    def predict(image, image_640):
        a, b = scales(image, image_640)
        logits = upsample_bilinear_align_corners(a, out_hw)
        if mode == "simt":
            logits = logits + upsample_bilinear_align_corners(b, out_hw)
        return torch.argmax(logits, dim=-1)

    @torch.inference_mode()
    def predict_hist(image, image_640, gt, out=None):
        a, b = scales(image, image_640)
        return multiscale_argmax_hist(a, b, gt, out_hw=out_hw, num_classes=num_classes,
                                      out=out)

    def hist_update(hist, pred, gt):
        return hist + fast_hist(gt, pred, num_classes)

    return predict, predict_hist, hist_update


def evaluate(
    model: torch.nn.Module,
    *,
    data_root: str,
    val_list: str,
    gt_dir: str,
    mode: str = "simt",
    batch_size: int = 1,
    info: Optional[dict] = None,
    print_fn: Callable[[str], None] = print,
    save_dir: Optional[str] = None,
    scales: Tuple[Tuple[int, int], ...] = EVAL_SCALES,
    out_hw: Tuple[int, int] = EVAL_OUT_HW,
    return_hist: bool = False,
    process_workers: bool = False,
    device: Union[str, torch.device] = "cuda",
):
    """Run the full protocol; returns mIoU (percent, 2dp) like evaluate_cityscapes.py:162,
    or ``(miou, hist)`` with ``return_hist=True`` (hist: (C, C) float64 numpy).

    ``model`` is moved to ``device`` and put in eval mode. ``device`` defaults to
    ``"cuda"`` and raises without a card; the CPU runs only when asked for, and there
    the fused kernel's plain version computes the histogram. ``process_workers``
    decodes in spawned processes (``DataConfig.process_workers``): the PNG decode of
    2048x1024 val images holds the interpreter lock under thread workers, as in
    training.
    """
    dev = resolve_device(device)
    info = info or load_info()
    num_classes = int(info["classes"])
    names = info["label"]
    mapping = np.asarray(info["label2train"], np.int64)
    out_hw = tuple(out_hw)

    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    loaders = [
        Loader(SegDataset.cityscapes_eval(data_root, val_list, crop_wh=crop_wh,
                                          mean_bgr=IMG_MEAN_BGR, split="val"),
               batch_size, shuffle=False, num_workers=4, drop_last=False, loop=False,
               process_workers=process_workers)
        for crop_wh in scales
    ]
    predict, predict_hist, hist_update = make_eval_fn(model, num_classes, mode, out_hw)
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=dev)

    def load_gt(name: str) -> np.ndarray:
        from PIL import Image

        # Keep the full relative name (val lists carry 'frankfurt/...' city subdirs,
        # which the reference preserves, evaluate_cityscapes.py:141).
        gt_name = name.split("leftImg8bit")[0] + "gtFine_labelIds.png"
        gt = label_mapping(np.asarray(Image.open(os.path.join(gt_dir, gt_name))), mapping)
        if gt.size and (gt.min() < 0 or gt.max() > 255):
            raise ValueError(f"{gt_name}: remapped labels outside [0, 255] "
                             f"({gt.min()}..{gt.max()}) do not fit the uint8 gt")
        return gt.astype(np.uint8)  # a quarter of int32's bytes to the card

    # Host gt decode overlaps the device work: one batch of decodes stays in flight.
    streams = [iter(loader) for loader in loaders]
    with ThreadPoolExecutor(max_workers=4) as pool, contextlib.ExitStack() as stack:
        for it in streams:  # a loader's iterator stops its workers when closed
            stack.callback(it.close)
        batches = ((batch, batch_640, [pool.submit(load_gt, n) for n in batch["name"]])
                   for batch, batch_640 in zip(*streams))
        pending = collections.deque()
        pending.extend(_take(batches, 1))
        while pending:
            pending.extend(_take(batches, 1))
            batch, batch_640, futures = pending.popleft()
            gt_np = np.stack([f.result() for f in futures])
            if gt_np.shape[1:] != out_hw:
                print_fn(f"Skipping: gt {gt_np.shape} vs pred {out_hw} for {batch['name']}")
                continue
            image = torch.from_numpy(batch["image"]).to(dev, non_blocking=True)
            image_640 = torch.from_numpy(batch_640["image"]).to(dev, non_blocking=True)
            gt = torch.from_numpy(gt_np).to(dev, non_blocking=True)
            if save_dir is None:
                predict_hist(image, image_640, gt, out=hist)  # the kernel adds in place
            else:
                pred = predict(image, image_640)
                hist = hist_update(hist, pred, gt)
                os.makedirs(save_dir, exist_ok=True)
                pred_np = pred.cpu().numpy()
                for i, name in enumerate(batch["name"]):
                    save_pred_png(pred_np[i], os.path.join(save_dir, os.path.basename(name)))

    hist_np = hist.cpu().numpy().astype(np.float64)
    ious = per_class_iu(hist_np)
    for i in range(num_classes):
        print_fn("===>" + names[i] + ":\t" + str(round(ious[i] * 100, 2)))
    miou = mean_iou(hist_np)
    print_fn("===> mIoU: " + str(miou))
    if return_hist:
        return miou, hist_np
    return miou


def _take(iterator, n: int):
    return [item for _, item in zip(range(n), iterator)]


# Cityscapes palette (evaluate_cityscapes.py:40-45).
PALETTE = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153, 153, 153, 153,
    250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152, 70, 130, 180, 220, 20, 60,
    255, 0, 0, 0, 0, 142, 0, 0, 70, 0, 60, 100, 0, 80, 100, 0, 0, 230, 119, 11, 32,
    255, 255, 255,
]


def colorize_mask(mask: np.ndarray):
    """Train-id map as a palette PIL image (evaluate_cityscapes.py:48-53)."""
    from PIL import Image

    img = Image.fromarray(mask.astype(np.uint8)).convert("P")
    img.putpalette(PALETTE + [0] * (768 - len(PALETTE)))
    return img


def save_pred_png(pred: np.ndarray, path: str, color: bool = False) -> None:
    """Prediction map as an 8-bit train-id PNG (evaluate_cityscapes.py:150-155), or
    with ``color`` as the palette image of ``colorize_mask``."""
    from PIL import Image

    if color:
        colorize_mask(pred).save(path)
    else:
        Image.fromarray(pred.astype(np.uint8)).save(path)
