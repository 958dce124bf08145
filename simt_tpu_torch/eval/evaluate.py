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

Across ranks (``parallel/mesh.py``): ``shard=(index, count)`` evaluates every
count-th image and sums the histograms over the ranks before the mIoU, so every rank
reads the same mIoU; ``mesh=`` with a spatial axis above 1 splits each image's eval
head by output rows over the spatial group
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
import torch.distributed as dist

from ..config import EVAL_OUT_HW, EVAL_SCALES, IMG_MEAN_BGR
from ..data.lists import load_info
from ..data.pipeline import Loader, SegDataset, normalize_image
from ..device import resolve_device
from ..ops.interp import upsample_bilinear_align_corners
from ..ops.kernels.eval_fused import multiscale_argmax_hist, multiscale_argmax_hist_spatial
from ..ops.metrics import fast_hist, label_mapping, mean_iou, per_class_iu
from ..parallel.mesh import Mesh, all_reduce_, world_size
from ..utils.spans import span


def make_eval_fn(model: torch.nn.Module, num_classes: int = 19, mode: str = "simt",
                 out_hw: Tuple[int, int] = EVAL_OUT_HW, mesh: Optional[Mesh] = None):
    """Eval functions over a model already placed on its device, in eval mode.

    ``predict(image, image_640)`` -> (B, *out_hw) int64 prediction map, through the plain
    upsample + argmax (used when prediction PNGs are saved).
    ``predict_hist(image, image_640, gt, out=None)`` -> (C, C) int32 histogram through
    the fused kernel (on CUDA tensors; its plain version on CPU tensors), added into
    ``out`` when it is given. With a ``mesh`` whose spatial axis is above 1, every rank
    of the spatial group counts its block of output rows and the group sums the
    histograms (``multiscale_argmax_hist_spatial``): the whole batch's histogram on
    each of them.
    ``hist_update(hist, pred, gt)`` -> running histogram.
    Under a profiler each scale's forward is a range ``simt_tpu_torch.eval_forward``
    and the head's call ``simt_tpu_torch.eval_head`` (``utils/spans.py``).
    Images are (B, H, W, 3) uint8 BGR (or float32 mean-subtracted) on the model's device.
    """
    if mode not in ("simt", "warmup"):
        raise ValueError(f"mode must be 'simt' or 'warmup', got {mode!r}")
    out_hw = tuple(out_hw)

    @torch.inference_mode()
    def fwd(image: torch.Tensor) -> torch.Tensor:
        """Head-2 logits, known classes, float32 NHWC (evaluate_cityscapes.py:127-133)."""
        with span("eval_forward"):
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
        with span("eval_head"):
            if mesh is None or mesh.spatial_group is None:
                return multiscale_argmax_hist(a, b, gt, out_hw=out_hw,
                                              num_classes=num_classes, out=out)
            hist = multiscale_argmax_hist_spatial(a, b, gt, group=mesh.spatial_group,
                                                  out_hw=out_hw, num_classes=num_classes)
        return hist if out is None else out.add_(hist)

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
    shard: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
):
    """Run the full protocol; returns mIoU (percent, 2dp) like evaluate_cityscapes.py:162,
    or ``(miou, hist)`` with ``return_hist=True`` (hist: (C, C) float64 numpy).

    ``shard=(index, count)`` evaluates every count-th image from ``index``; under an
    initialised process group the histograms are summed over its ranks before the mIoU
    (``mesh``'s data group), so every rank returns the global result. It defaults to
    ``(rank, world)`` in a process group and, with a ``mesh``, to ``(data index,
    data)``: the data axis splits the images, and the ranks of a spatial group evaluate
    the same ones, each running the whole two-scale forward of every image and counting
    its block of output rows (``make_eval_fn``). The JAX package H-shards that forward
    over the spatial devices; the histogram is the same either way. With ``mesh``, the
    prediction PNGs are written by the spatial group's first rank.

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
    if shard is None and mesh is not None:
        shard = (mesh.data_index, mesh.data)
    elif shard is None and world_size() > 1:
        shard = (dist.get_rank(), dist.get_world_size())
    loaders = []
    for crop_wh in scales:
        ds = SegDataset.cityscapes_eval(data_root, val_list, crop_wh=crop_wh,
                                        mean_bgr=IMG_MEAN_BGR, split="val")
        if shard is not None:
            ds.samples = ds.samples[shard[0]::shard[1]]
        loaders.append(Loader(ds, batch_size, shuffle=False, num_workers=4,
                              drop_last=False, loop=False,
                              process_workers=process_workers))
    predict, predict_hist, hist_update = make_eval_fn(model, num_classes, mode, out_hw,
                                                      mesh)
    writes_png = mesh is None or mesh.spatial_index == 0
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
                if writes_png:
                    os.makedirs(save_dir, exist_ok=True)
                    pred_np = pred.cpu().numpy()
                    for i, name in enumerate(batch["name"]):
                        save_pred_png(pred_np[i],
                                      os.path.join(save_dir, os.path.basename(name)))

    if shard is not None and world_size() > 1:
        # The data shards' histograms (the spatial group's ranks hold the same one).
        all_reduce_(hist, mesh.data_group if mesh is not None else dist.group.WORLD)
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
