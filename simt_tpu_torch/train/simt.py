"""SimT-stage trainer, stage 2 (counterpart of ``simt_tpu/train/simt.py``).

One call of the step does what the reference does per iteration
(tools/trainV2_simt.py:307-436):

  - the inner loop of ``inner_w_steps`` Adam steps on W1/W2 against
    MSE(W @ T, 0) (:327-339). T's ``.grad`` is cleared once per *outer* iteration
    (:317) and never inside the loop, so the inner T-gradients accumulate and join the
    main loss's in the T update (:435), as in the reference and the JAX package;
    ``clear_inner_t_grads`` discards them;
  - the frozen teacher (eval mode, ``no_grad``) and its stride-8 softmax of head 2, or
    the batch's ``teacher_prob8`` when it carries one (``train/teacher_cache.py``), in
    which case the teacher does not run;
  - the student forward in train mode and ``simt_loss_block`` (anchor, class-posterior
    CE, placeholder, noisy posterior; :370-409), the convex loss (:412-415), the
    guarded volume loss (:417-421) and the composite (:423-424);
  - ``iter_size`` sub-batches, each loss scaled by 1/iter_size (:345, :426-436), with
    the reference's metric conventions;
  - one SGD step for the model and one Adam step each for T1 and T2.

Over a mesh of several ranks (``parallel/mesh.py``; each rank a block of the global
batch, and on the spatial axis a block of its rows) the step is the global batch's, as
the JAX package's one program is: BatchNorm takes global batch statistics, the loss
block global counts and the global anchor, and one rule reduces the gradients over
every rank of the mesh (decision C-d7): what depends on the data is summed, what is
replicated is not. The data losses' gradients (the student's and their part of
T1/T2's) are summed in one ``all_reduce`` (``grad_sync``) after the last sub-batch; the
convex, volume and anchor terms and the inner W loop's T-gradients are the same on
every rank and are added after it, once; the W updates see no data. On the spatial axis
the teacher and the student run on the rank's rows of the images (of the crop's
height, ``cfg.data.crop_size``) inside ``spatial_rows`` and return their stride-8
outputs gathered; the loss block takes the rank's band of label rows.

The step never waits for the card: no ``.item()``, no branch on a tensor; the learning
rate comes from the host-side step count and the metrics come back as 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..data.pipeline import normalize_image, normalize_label
from ..models import ntm as ntm_lib
from ..ops.fused_losses import simt_loss_block
from ..ops.losses import mse_sum, volume_loss
from ..ops.schedules import poly_lr
from ..parallel.mesh import (Mesh, all_reduce_, gather_rows, global_batch_stats,
                             row_block, spatial_rows, sync_grads)
from ..utils.spans import Events, span
from .state import NTMState, SimTState, make_adam, make_model_optimizer


def create_simt_state(model: nn.Module, teacher: nn.Module, cfg,
                      generator: torch.Generator,
                      device: torch.device = torch.device("cuda")) -> SimTState:
    """The SimT train state (trainV2_simt.py:250-280): the models on ``device`` (in
    ``channels_last`` on a card), the teacher frozen in eval mode, T1/T2 drawn from
    ``generator`` on the CPU, W1/W2 at their constant init, fresh optimizers."""
    device = torch.device(device)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model.to(device=device, memory_format=fmt).train()
    teacher.to(device=device, memory_format=fmt).eval()
    for p in teacher.parameters():
        p.requires_grad_(False)
    c, o = cfg.model.num_classes, cfg.model.open_classes

    def ntm_state(init: torch.Tensor) -> NTMState:
        param = nn.Parameter(init.to(device))
        return NTMState(param, make_adam(param))

    t1 = ntm_state(ntm_lib.ntm_init(generator, c, o))
    t2 = ntm_state(ntm_lib.ntm_init(generator, c, o))
    return SimTState(
        model=model,
        model_opt=make_model_optimizer(
            model, cfg.optim.momentum, cfg.optim.weight_decay,
            aspp_effective_branches=cfg.model.aspp_effective_branches),
        teacher=teacher,
        t1=t1, t2=t2,
        w1=ntm_state(ntm_lib.w_init(c, o)), w2=ntm_state(ntm_lib.w_init(c, o)),
        class_dist=torch.from_numpy(ntm_lib.load_class_dist(cfg.simt.class_dist)).to(device),
    )


def _sq(a: torch.Tensor) -> torch.Tensor:
    """``MSELoss(reduction='sum')(a, 0)`` (trainV2_simt.py:305, :337, :412-415)."""
    return mse_sum(a, torch.zeros_like(a))


def _guarded_volume(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Volume loss with the reference's non-finite -> 0 guard on the SUM of both heads
    (trainV2_simt.py:417-421: one non-finite head zeroes both), in the double-where
    form so that a singular Gram matrix cannot put NaN into the gradients."""
    raw = volume_loss(t1.detach()) + volume_loss(t2.detach())
    ok = torch.isfinite(raw)
    safe = torch.zeros_like(t1)
    safe[: t1.shape[1]] = torch.eye(t1.shape[1], dtype=t1.dtype, device=t1.device)
    vol = volume_loss(torch.where(ok, t1, safe)) + volume_loss(torch.where(ok, t2, safe))
    return torch.where(ok, vol, torch.zeros_like(vol))


def inner_w_steps(st: SimTState, c: int, o: int, steps: int) -> None:
    """``steps`` Adam steps of W1/W2 against MSE(W @ T, 0) (trainV2_simt.py:327-339);
    T's gradients accumulate in its ``.grad`` (:337)."""
    for _ in range(steps):
        st.w1.param.grad = None
        st.w2.param.grad = None
        w_obj = (_sq(ntm_lib.w_forward(st.w1.param)
                     @ ntm_lib.ntm_forward(st.t1.param, st.class_dist, c, o))
                 + _sq(ntm_lib.w_forward(st.w2.param)
                       @ ntm_lib.ntm_forward(st.t2.param, st.class_dist, c, o)))
        w_obj.backward()
        st.w1.opt.step()
        st.w2.opt.step()


# Metrics that accumulate at 1/iter_size (trainV2_simt.py:429-432); the others are the
# last sub-batch's unscaled values (:438-441 reads the loop variables).
_ACCUM = ("loss", "loss_seg_p", "loss_seg_y")


class SimTStep:
    """The SimT train step: ``step(state, batch) -> metrics``, updating ``state`` in
    place. ``batch``: ``image`` (B, H, W, 3) mean-subtracted BGR float32 (or uint8) and
    ``label`` (B, H, W) integer, optionally ``teacher_prob8`` (B, h8, w8, C) float32,
    the cached teacher posterior, with a leading ``iter_size`` axis when
    ``iter_size > 1``; numpy arrays or tensors.

    ``mesh``: the ranks' mesh when this rank holds a block of the global batch (None:
    one process; ``shard_batch`` gives a rank its block). The metrics are the global
    batch's on every rank.

    ``spans``: None (default) or a list to which each call appends ``(name, start,
    end)`` CUDA events around its parts (inner_w, teacher, student_forward, backward,
    grad_sync over several ranks, optimizer); read them after a synchronize. Under a
    profiler each part is also a range ``simt_tpu_torch.inner_w``, ...
    (``utils/spans.py``).
    """

    def __init__(self, cfg, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.group = mesh.group if mesh is not None else None
        self.spans: Optional[Events] = None

    def __call__(self, st: SimTState, batch: Dict) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        s = cfg.simt
        c, o = cfg.model.num_classes, cfg.model.open_classes
        dev = st.t1.param.device
        lr = poly_lr(cfg.optim.learning_rate, st.step, cfg.optim.num_steps, cfg.optim.power)
        lr_t = poly_lr(cfg.optim.learning_rate_t, st.step, cfg.optim.num_steps,
                       cfg.optim.power)
        for group in st.model_opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        for n in (st.t1, st.t2, st.w1, st.w2):
            n.opt.param_groups[0]["lr"] = lr_t

        def ntm(p):
            return ntm_lib.ntm_forward(p, st.class_dist, c, o)

        # ------- inner loop: W1/W2 against the current T1/T2 (:327-339) -------
        with span("inner_w", self.spans):
            st.t1.param.grad = None  # optimizer_t.zero_grad(), once per iteration (:317)
            st.t2.param.grad = None
            inner_w_steps(st, c, o, s.inner_w_steps)
            if s.clear_inner_t_grads:
                st.t1.param.grad = None
                st.t2.param.grad = None
            if self.group is not None:
                # Replicated: kept out of the data gradients' sum, added back after it.
                inner = (st.t1.param.grad, st.t2.param.grad)
                rep = [torch.zeros_like(st.t1.param), torch.zeros_like(st.t2.param)]
                st.t1.param.grad = st.t2.param.grad = None
            with torch.no_grad():
                w1_mat = ntm_lib.w_forward(st.w1.param)
                w2_mat = ntm_lib.w_forward(st.w2.param)

        st.model_opt.zero_grad(set_to_none=True)
        iter_size = cfg.optim.iter_size
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(iter_size):
            sub = batch if iter_size == 1 else {k: v[i] for k, v in batch.items()}
            image = normalize_image(torch.as_tensor(sub["image"], device=dev),
                                    cfg.data.mean_bgr)
            label = normalize_label(torch.as_tensor(sub["label"], device=dev))
            x = image.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
            height, band = image_rows(cfg, self.mesh, image)

            # ------- teacher posterior (:351-354) -------
            with span("teacher", self.spans), torch.no_grad():
                if "teacher_prob8" in sub:
                    # Cached (train/teacher_cache.py): the frozen teacher is a pure
                    # function of (image, mirror), so it need not run every step.
                    teacher_prob8 = torch.as_tensor(sub["teacher_prob8"],
                                                    device=dev).float()
                else:
                    with spatial_rows(self.mesh, height):
                        _, teach2 = st.teacher(x)
                    teacher_prob8 = torch.softmax(teach2.float(), dim=1).permute(0, 2, 3, 1)

            # ------- student forward + composite loss (:370-424) -------
            with span("student_forward", self.spans):
                t1m, t2m = ntm(st.t1.param), ntm(st.t2.param)
                with global_batch_stats(self.group), spatial_rows(self.mesh, height):
                    x1, x2 = st.model(x)
                if band is not None and "teacher_prob8" in sub:
                    # The cached posterior's rows, sharded as the batch is (shard_rows).
                    teacher_prob8 = gather_rows(teacher_prob8.permute(0, 3, 1, 2),
                                                self.mesh.rows(height), x1.shape[2]
                                                ).permute(0, 2, 3, 1)
                losses = simt_loss_block(
                    x1.permute(0, 2, 3, 1), x2.permute(0, 2, 3, 1), teacher_prob8, label,
                    t1m, t2m, num_classes=c, open_classes=o,
                    threshold_high=s.threshold_high, threshold_low=s.threshold_low,
                    lambda_place=s.lambda_place, lambda_seg=s.lambda_seg,
                    ignore_label=cfg.ignore_label, chunk_rows=s.loss_chunk_rows,
                    group=self.group, band=band,
                    first_image=None if band is None else self.mesh.data_index * len(label))
                convex = -(_sq(w1_mat @ t1m) + _sq(w2_mat @ t2m))
                volume = _guarded_volume(t1m, t2m)
                loss_target = (losses["loss_p2"] + losses["loss_y2"]
                               + s.lambda_seg * losses["loss_p1"]
                               + s.lambda_seg * losses["loss_y1"])
                data = losses["place"] + loss_target  # this rank's share
                loss = (data + s.lambda_convex * convex + s.lambda_volume * volume
                        + s.lambda_anchor * losses["anchor"])
            with span("backward", self.spans):
                if self.group is None:
                    (loss / iter_size).backward()
                else:
                    replicated = (s.lambda_convex * convex + s.lambda_volume * volume
                                  + s.lambda_anchor * losses["anchor"])
                    for r, g in zip(rep, torch.autograd.grad(
                            replicated / iter_size, (st.t1.param, st.t2.param),
                            retain_graph=True)):
                        r.add_(g)
                    (data / iter_size).backward()

            m = {"loss": loss, "loss_seg_p": losses["loss_p1"] + losses["loss_p2"],
                 "loss_seg_y": losses["loss_y1"] + losses["loss_y2"], "convex": convex,
                 "volume": volume, "anchor": losses["anchor"], "place": losses["place"]}
            if self.group is not None:
                # The global batch's values: the data terms summed over the ranks.
                keys = ("loss_seg_p", "loss_seg_y", "place")
                g = all_reduce_(torch.stack([data.detach()] + [m[k].detach()
                                                                for k in keys]), self.group)
                m.update(zip(keys, g[1:]))
                m["loss"] = (g[0] + s.lambda_convex * convex + s.lambda_volume * volume
                             + s.lambda_anchor * losses["anchor"])
            for k, v in m.items():
                v = v.detach()
                if iter_size == 1:
                    metrics[k] = v
                elif k in _ACCUM:
                    metrics[k] = metrics.get(k, 0.0) + v / iter_size
                else:
                    metrics[k] = v

        if self.group is not None:
            with span("grad_sync", self.spans):
                sync_grads([*st.model.parameters(), st.t1.param, st.t2.param], self.group)
                for ntm_state, r, g0 in zip((st.t1, st.t2), rep, inner):
                    ntm_state.param.grad.add_(r if g0 is None else r + g0)
        with span("optimizer", self.spans):
            st.model_opt.step()
            st.t1.opt.step()
            st.t2.opt.step()
        st.step += 1
        metrics["lr"] = torch.tensor(lr)
        return metrics


def image_rows(cfg, mesh: Optional[Mesh],
               image: torch.Tensor) -> Tuple[int, Optional[Tuple[int, int]]]:
    """(the global height of a sub-batch's images, the loss band ``(r0, height)`` of its
    label rows, or None without a spatial axis). On the spatial axis the images are the
    crop's height (``cfg.data.crop_size``) and ``image`` (B, rows, W, 3) must hold this
    rank's ``row_block`` of it."""
    if mesh is None or mesh.spatial == 1:
        return image.shape[1], None
    height = cfg.data.crop_size[1]
    lo, hi = row_block(height, mesh.spatial_index, mesh.spatial)
    if image.shape[1] != hi - lo:
        raise ValueError(f"spatial rank {mesh.spatial_index} of {mesh.spatial} holds "
                         f"{image.shape[1]} image rows; its block of the crop's "
                         f"{height} rows is [{lo}, {hi}) (shard_rows)")
    return height, (lo, height)


def make_simt_step(cfg, mesh: Optional[Mesh] = None) -> SimTStep:
    """The SimT train step for ``cfg`` (a ``TrainConfig``) on this rank of ``mesh``."""
    return SimTStep(cfg, mesh)
