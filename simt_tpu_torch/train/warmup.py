"""Warmup-stage trainer, stage 1 (counterpart of ``simt_tpu/train/warmup.py``).

One call of the step does what the reference does per iteration
(tools/trainV1_warmup.py:204-232):

  - the forward of both heads in train mode (BatchNorm updates its running statistics
    from the batch, as flax's ``mutable=["batch_stats"]``); a single-output model
    (DeepLabv3) counts as both heads, the ``(x, x)`` convention of Res_Deeplab;
  - per head the align-corners upsample to the crop and the masked CE mean, streamed
    (``ops/fused_losses.py::upsample_ce``; logits already at the label's size take the
    plain ``cross_entropy_2d``, :75-81 of the JAX step);
  - ``loss = l2 + lambda_seg * l1`` (:222-224), divided by ``iter_size`` per sub-batch,
    the sub-batches on a leading axis (:212, :226-232), with the JAX step's metric
    conventions;
  - one SGD step at the poly rate of the host-side step count over the arch's warmup
    groups (``param_label(warmup=True, arch=...)``): for DeepLabv2, 1x for the trunk
    (stem and layers 1-2 included) and 10x for the heads.

Over a mesh of several ranks (``parallel/mesh.py``) the step is the global batch's:
BatchNorm takes global batch statistics, each CE mean is this rank's sum over the
global count, the gradients are summed over every rank of the mesh in one
``all_reduce`` (``grad_sync``) after the last sub-batch, and the metrics are the
global values. On the spatial axis every model runs on the rank's rows inside
``spatial_rows`` and each CE covers the rank's band of label rows (``simt.py``):
gathered stride-8 logits through ``upsample_ce(band=)``, DeepLabv3's own band of
input-size logits through the plain masked CE.

The step never waits for the card: the metrics come back as 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..data.pipeline import normalize_image, normalize_label
from ..ops.fused_losses import upsample_ce
from ..ops.losses import cross_entropy_2d
from ..ops.schedules import poly_lr
from ..parallel.mesh import Mesh, all_reduce_, global_batch_stats, spatial_rows, sync_grads
from ..utils.spans import Events, span
from .simt import image_rows
from .state import WarmupState, make_model_optimizer


def create_warmup_state(model: nn.Module, cfg,
                        device: torch.device = torch.device("cuda")) -> WarmupState:
    """The warmup train state: ``model`` on ``device`` (in ``channels_last`` on a card)
    in train mode, and SGD over its warmup groups (``param_label(warmup=True)`` of
    ``cfg.model.arch`` and ``aspp_effective_branches``)."""
    device = torch.device(device)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model.to(device=device, memory_format=fmt).train()
    opt = make_model_optimizer(model, cfg.optim.momentum, cfg.optim.weight_decay,
                               warmup=True, arch=cfg.model.arch,
                               aspp_effective_branches=cfg.model.aspp_effective_branches)
    return WarmupState(model=model, model_opt=opt)


class WarmupStep:
    """The warmup train step: ``step(state, batch) -> metrics`` {loss_seg1, loss_seg2,
    lr}, updating ``state`` in place. ``batch``: ``image`` (B, H, W, 3) mean-subtracted
    BGR float32 (or uint8) and ``label`` (B, H, W) integer, with a leading
    ``iter_size`` axis when ``iter_size > 1``; numpy arrays or tensors.

    ``mesh``: the ranks' mesh when this rank holds a block of the global batch (None:
    one process). The metrics are the global batch's on every rank.

    ``spans``: None (default) or a list to which each call appends ``(name, start,
    end)`` CUDA events around its parts (forward, backward, grad_sync over several
    ranks, optimizer); read them after a synchronize. Under a profiler each part is
    also a range ``simt_tpu_torch.forward``, ... (``utils/spans.py``).
    """

    def __init__(self, cfg, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.group = mesh.group if mesh is not None else None
        self.spans: Optional[Events] = None

    def _losses(self, model: nn.Module, image: torch.Tensor,
                label: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        ignore, group = cfg.ignore_label, self.group
        height, band = image_rows(cfg, self.mesh, image)
        with global_batch_stats(group), spatial_rows(self.mesh, height):
            ys = model(image.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        # A single-output model (DeepLabv3) is both heads (JAX warmup.py:75-78).
        x1, x2 = ys if isinstance(ys, tuple) else (ys, ys)
        x1, x2 = x1.permute(0, 2, 3, 1), x2.permute(0, 2, 3, 1)
        if x1.shape[1:3] == label.shape[1:]:
            # Logits already at the input's size (DeepLabv3; on the spatial axis its
            # rows forward gives this rank's band of them, exactly its label rows):
            # plain masked CE, this rank's sum over the global count.
            return (cross_entropy_2d(x1, label, ignore_label=ignore, group=group),
                    cross_entropy_2d(x2, label, ignore_label=ignore, group=group))
        chunk = cfg.simt.loss_chunk_rows
        return tuple(upsample_ce(x, label, ignore_label=ignore, chunk_rows=chunk,
                                 group=group, band=band) for x in (x1, x2))

    def __call__(self, st: WarmupState, batch: Dict) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dev = next(st.model.parameters()).device
        lr = poly_lr(cfg.optim.learning_rate, st.step, cfg.optim.num_steps, cfg.optim.power)
        for group in st.model_opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        st.model_opt.zero_grad(set_to_none=True)
        iter_size = cfg.optim.iter_size
        l1_sum = l2_sum = None
        for i in range(iter_size):
            sub = batch if iter_size == 1 else {k: v[i] for k, v in batch.items()}
            image = normalize_image(torch.as_tensor(sub["image"], device=dev),
                                    cfg.data.mean_bgr)
            label = normalize_label(torch.as_tensor(sub["label"], device=dev))
            with span("forward", self.spans):
                l1, l2 = self._losses(st.model, image, label)
                loss = (l2 + cfg.simt.lambda_seg * l1) / iter_size
            with span("backward", self.spans):
                loss.backward()
            l1, l2 = l1.detach(), l2.detach()
            if self.group is not None:  # the global batch's values
                l1, l2 = all_reduce_(torch.stack([l1, l2]), self.group)
            if iter_size == 1:
                l1_sum, l2_sum = l1, l2
            else:  # the metric accumulation scale of trainV1_warmup.py:229-230
                l1_sum = l1 / iter_size if l1_sum is None else l1_sum + l1 / iter_size
                l2_sum = l2 / iter_size if l2_sum is None else l2_sum + l2 / iter_size
        if self.group is not None:
            with span("grad_sync", self.spans):
                sync_grads(list(st.model.parameters()), self.group)
        with span("optimizer", self.spans):
            st.model_opt.step()
        st.step += 1
        return {"loss_seg1": l1_sum, "loss_seg2": l2_sum, "lr": torch.tensor(lr)}


def make_warmup_step(cfg, mesh: Optional[Mesh] = None) -> WarmupStep:
    """The warmup train step for ``cfg`` (a ``TrainConfig``) on this rank of ``mesh``."""
    return WarmupStep(cfg, mesh)
