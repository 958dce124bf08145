"""Plain reference of the SimT stage (``tools/trainV2_simt.py:307-436``) and of its
two-scale evaluation (``evaluate_cityscapes.py:96-162``) on the DeepLabv2-ResNet-101 of
``network.py``, in float32 (TF32 off), with its own state.

A training step:

1. the inner loop: T's gradients cleared once, then ``inner_w_steps`` Adam steps of W1
   / W2 against ``MSE_sum(W @ T, 0)`` (:327-339); T's gradients of that loss stay and
   join the T update (:317, :337);
2. the frozen teacher (eval mode, no gradient): head 2's softmax at stride 8, upsampled
   to the crop; where its maximum exceeds ``threshold_high`` its argmax is the label,
   where it is below ``threshold_low`` the label is C (unknown), else ignore (:351-362);
3. the student in training mode; both heads upsampled to the crop; the class-posterior
   label (the teacher's, or head 2's argmax where it is open and the teacher said
   unknown); per head the CE against it, the placeholder loss (CE against the argmax
   where known and confident; CE of the logits with the argmax channel zeroed against
   the open argmax of those), and the noisy-posterior CE ``-log (softmax @ T)[y]`` against
   the pseudo label (:370-409); the anchor: for each class k present as an argmax, the
   squared distance of T's row k from the teacher's posterior at the pixel of the
   largest logit of k (the first in batch-major order);
4. ``loss = place + loss_p2 + loss_y2 + lambda_seg (loss_p1 + loss_y1) + lambda_convex
   convex + lambda_volume volume + lambda_anchor anchor``, with ``convex = -sum (W @ T)^2``
   of the inner loop's W and ``volume`` ``log sqrt |det T^T T|`` of both heads, 0 if not
   finite (:412-424);
5. SGD on layer3, layer4 and the heads (10x), Adam on T1 and T2.

The losses are summed image by image, each under a checkpoint.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import network, training

IGNORE = training.IGNORE


def ntm_matrix(p: torch.Tensor, class_dist: torch.Tensor, c: int) -> torch.Tensor:
    """``sig_NTM``: rows of ``sigmoid(p) * class_dist + [I; 0]`` normalised to sum 1."""
    prior = torch.zeros_like(p)
    prior[:c] = torch.eye(c, device=p.device)
    t = torch.sigmoid(p) * class_dist + prior
    return t / t.sum(1, keepdim=True)


def w_matrix(p: torch.Tensor) -> torch.Tensor:
    """``sig_W``: the row softmax of ``p`` with its diagonal at -10000, minus I."""
    eye = torch.eye(p.shape[0], dtype=torch.bool, device=p.device)
    return torch.softmax(p.masked_fill(eye, -10000.0), 1) - eye.float()


def sq(a: torch.Tensor) -> torch.Tensor:
    return (a * a).sum()


def volume(t: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.linalg.slogdet(t.T @ t)[1]


def _image(x1, x2, tprob8, label, t1, t2, c, th_hi, th_lo):
    """One image: the (2, 8) sums (per head: CE against the refined label, the
    placeholder's known and open CE, the noisy-posterior CE, each with its count) and,
    per head, each channel's largest logit, its pixel, the teacher's posterior there and
    whether the channel is some pixel's argmax."""
    hw = label.shape[1:]
    with torch.no_grad():
        tch = training.upsample(tprob8, hw)  # (1, C, H, W)
        tmax, targ = tch.max(1)
        conf = torch.where(tmax > th_hi, targ, torch.full_like(targ, IGNORE))
        conf = torch.where(tmax < th_lo, torch.full_like(targ, c), conf)
    p1, p2 = training.upsample(x1, hw), training.upsample(x2, hw)
    total = p1.shape[1]
    pseudo2 = p2.argmax(1)
    open2 = torch.where(pseudo2 >= c, pseudo2, torch.full_like(pseudo2, IGNORE))
    refined = torch.where(conf == c, open2, conf)
    sums, cands = [], []
    label = label.long()
    for p, t in ((p1, t1), (p2, t2)):
        lsm = F.log_softmax(p, 1)
        sm = lsm.exp()
        pmax, pseudo = sm.max(1)
        known = torch.where((pseudo < c) & (pmax > th_hi), pseudo,
                            torch.full_like(pseudo, IGNORE))
        arg = F.one_hot(pseudo, total).permute(0, 3, 1, 2).bool()
        predict = p.masked_fill(arg, 0.0)
        predict_open = predict.clone()
        predict_open[:, :c] = 0.0
        place_y = predict_open.argmax(1)
        place_y = torch.where(known == IGNORE, torch.full_like(place_y, IGNORE), place_y)
        s = [*training.ce_sum(p, refined), *training.ce_sum(p, known),
             *training.ce_sum(predict, place_y)]
        valid = label != IGNORE
        y = torch.where(valid, label, torch.zeros_like(label))
        q = torch.einsum("bkhw,kc->bchw", sm, t)
        qy = torch.gather(q, 1, y[:, None])[:, 0]
        nll = torch.where(valid, -torch.log(qy), torch.zeros_like(qy))
        s += [nll.sum(), valid.sum().float()]
        sums.append(torch.stack(s))
        flat = p.detach().reshape(total, -1)
        amax, aidx = flat.max(1)
        rows = tch.reshape(tch.shape[1], -1)[:, aidx].T  # (C+O, C)
        present = torch.zeros(total, device=p.device)
        present[pseudo.flatten()] = 1.0
        cands.append((amax, aidx, rows, present))
    return torch.stack(sums), cands


def losses(x1, x2, tprob8, label, t1m, t2m, cfg) -> Dict[str, torch.Tensor]:
    """The loss block over the batch: {loss_p1, loss_p2, loss_y1, loss_y2, place,
    anchor}; ``x1``, ``x2`` the stride-8 logits NCHW, ``tprob8`` the teacher's
    posterior."""
    s_cfg, c = cfg["simt"], cfg["model"]["num_classes"]
    total_sums = None
    best = [None, None]  # per head: (amax, rows), the first image keeping a tie
    presence = [None, None]
    for b in range(label.shape[0]):
        sums, cands = checkpoint(_image, x1[b:b + 1], x2[b:b + 1], tprob8[b:b + 1],
                                 label[b:b + 1], t1m, t2m, c, s_cfg["threshold_high"],
                                 s_cfg["threshold_low"], use_reentrant=False)
        total_sums = sums if total_sums is None else total_sums + sums
        for h, (amax, _, rows, present) in enumerate(cands):
            if best[h] is None:
                best[h], presence[h] = (amax, rows), present
                continue
            better = amax > best[h][0]
            best[h] = (torch.where(better, amax, best[h][0]),
                       torch.where(better[:, None], rows, best[h][1]))
            presence[h] = torch.maximum(presence[h], present)
    m = [training.mean(total_sums[h, 2 * k], total_sums[h, 2 * k + 1])
         for h in range(2) for k in range(4)]
    loss_p1, known1, unk1, loss_y1, loss_p2, known2, unk2, loss_y2 = m
    lam_seg, lam_place = s_cfg["lambda_seg"], s_cfg["lambda_place"]
    place = lam_seg * (known1 + lam_place * unk1) + known2 + lam_place * unk2
    anchor = sum((presence[h][:, None] * (t - best[h][1]) ** 2).sum()
                 for h, t in enumerate((t1m, t2m)))
    return {"loss_p1": loss_p1, "loss_p2": loss_p2, "loss_y1": loss_y1,
            "loss_y2": loss_y2, "place": place, "anchor": anchor}


@torch.no_grad()
def loss_terms(cfg: dict, own: Dict[str, torch.Tensor], batch: dict,
               ntm: Dict[str, torch.Tensor], precision: str = "fp32") -> Dict[str, float]:
    """The loss block's terms of a first step computed from given stride-8 logits
    (``own``: the student's ``x1``, ``x2`` and the teacher's head-2 ``teacher``, NCHW)
    and the initial T1 / T2: the check of the loss block on the program's own logits.
    ``precision`` "bf16" rounds the upsampled logits and posteriors to bf16 (the
    control)."""
    dev = ntm["t1"].device
    c = cfg["model"]["num_classes"]
    class_dist = torch.tensor(cfg["class_dist"], dtype=torch.float32, device=dev)
    x1, x2, teach = (own[k].to(dev).float() for k in ("x1", "x2", "teacher"))
    tprob8 = torch.softmax(teach, 1)
    if precision == "bf16":
        x1, x2, tprob8 = (t.bfloat16().float() for t in (x1, x2, tprob8))
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    ls = losses(x1, x2, tprob8, batch["label"], ntm_matrix(ntm["t1"], class_dist, c),
                ntm_matrix(ntm["t2"], class_dist, c), cfg)
    return {"loss_seg_p": float(ls["loss_p1"] + ls["loss_p2"]),
            "loss_seg_y": float(ls["loss_y1"] + ls["loss_y2"]),
            "place": float(ls["place"]), "anchor": float(ls["anchor"])}


def train(cfg: dict, weights: Dict[str, torch.Tensor], ntm: Dict[str, torch.Tensor],
          batch: dict, *, precision: str = "fp32", half_batch: bool = False) -> dict:
    """The reference's first step on ``batch`` from the student's and teacher's
    ``weights`` ({"student": ..., "teacher": ...}) and ``ntm`` (T1, T2, W1, W2): its
    loss, by leaf its gradient and the change it makes (``training.readings``; W1 / W2
    take ten Adam steps inside it, so their gradient is not read), its activations
    (``network.tap``) and its stride-8 logits (``own``)."""
    model, optim, s_cfg = cfg["model"], cfg["optim"], cfg["simt"]
    c, layers = model["num_classes"], model["layers"]
    branches = model["aspp_effective_branches"]
    P, groups = training.leaves(weights["student"], "simt", branches)
    teacher = {k: v.detach() for k, v in weights["teacher"].items()}
    nt = {k: v.detach().clone().requires_grad_(True) for k, v in ntm.items()}
    dev = nt["t1"].device
    class_dist = torch.tensor(cfg["class_dist"], dtype=torch.float32, device=dev)
    opts = {k: training.adam(p, optim["learning_rate_t"]) for k, p in nt.items()}
    named = dict(groups["1x"] + groups["10x"])
    named.update(nt)
    start = {k: p.detach().clone() for k, p in named.items()}
    opt = training.sgd(groups, optim)
    batch = training.batch_slice(batch, half_batch)
    for _ in range(s_cfg["inner_w_steps"]):
        nt["w1"].grad = nt["w2"].grad = None
        obj = (sq(w_matrix(nt["w1"]) @ ntm_matrix(nt["t1"], class_dist, c))
               + sq(w_matrix(nt["w2"]) @ ntm_matrix(nt["t2"], class_dist, c)))
        obj.backward()
        opts["w1"].step()
        opts["w2"].step()
    with torch.no_grad():
        w1m, w2m = w_matrix(nt["w1"]), w_matrix(nt["w2"])
    x = training.image_nchw(batch["image"])
    taps = {}
    with torch.no_grad():
        _, teach2 = network.forward(teacher, x, layers=layers, openset=False,
                                    train=False, precision=precision, branches=branches)
        tprob8 = torch.softmax(teach2, 1)
    network.tap(taps, "teacher", teach2)
    t1m = ntm_matrix(nt["t1"], class_dist, c)
    t2m = ntm_matrix(nt["t2"], class_dist, c)
    x1, x2 = network.forward(P, x, layers=layers, openset=True, train=True,
                             precision=precision, branches=branches, taps=taps)
    network.tap(taps, "logits1", x1)
    network.tap(taps, "logits2", x2)
    own = {"x1": x1.detach().cpu(), "x2": x2.detach().cpu(),
           "teacher": teach2.detach().cpu()}
    ls = losses(x1, x2, tprob8, batch["label"], t1m, t2m, cfg)
    convex = -(sq(w1m @ t1m) + sq(w2m @ t2m))
    vol = volume(t1m) + volume(t2m)
    vol = vol if bool(torch.isfinite(vol)) else torch.zeros_like(vol)
    loss = (ls["place"] + ls["loss_p2"] + ls["loss_y2"]
            + s_cfg["lambda_seg"] * (ls["loss_p1"] + ls["loss_y1"])
            + s_cfg["lambda_convex"] * convex + s_cfg["lambda_volume"] * vol
            + s_cfg["lambda_anchor"] * ls["anchor"])
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in named.items()
             if k not in ("w1", "w2")}
    opt.step()
    opts["t1"].step()
    opts["t2"].step()
    terms = {"loss": loss, "loss_seg_p": ls["loss_p1"] + ls["loss_p2"],
             "loss_seg_y": ls["loss_y1"] + ls["loss_y2"], "convex": convex,
             "volume": vol, "anchor": ls["anchor"], "place": ls["place"]}
    parts = {k: float(v.detach()) for k, v in terms.items()}
    return {**training.readings(named, grads, start, parts), "taps": taps, "own": own}


@torch.no_grad()
def eval_logits(cfg: dict, weights: Dict[str, torch.Tensor], batch: dict, *,
                precision: str = "fp32") -> List[torch.Tensor]:
    """Head 2's known-class logits (B, C, h, w) of an eval batch at each scale, in eval
    mode, image by image."""
    model = cfg["model"]
    c = model["num_classes"]
    out = []
    for img in batch["scales"]:
        per = []
        for i in range(img.shape[0]):
            _, x2 = network.forward(weights, training.image_nchw(img[i:i + 1]),
                                    layers=model["layers"], openset=model["openset"],
                                    train=False, precision=precision,
                                    branches=model["aspp_effective_branches"])
            per.append(x2[:, :c])
        out.append(torch.cat(per))
    return out


@torch.no_grad()
def hist_from_logits(logits: List[torch.Tensor], gt: torch.Tensor, out_hw,
                     precision: str = "fp32") -> torch.Tensor:
    """The (C, C) int64 histogram [gt, prediction]: each scale's logits upsampled to
    ``out_hw`` with ``align_corners=True``, summed, the argmax; pixels whose gt is a
    class counted. ``precision`` "bf16" rounds the logits to bf16 first (the control).
    Image by image."""
    c = logits[0].shape[1]
    hist = torch.zeros(c * c, dtype=torch.int64, device=gt.device)
    for i in range(gt.shape[0]):
        total = 0.0
        for x in logits:
            x = x[i:i + 1].to(gt.device).float()
            if precision == "bf16":
                x = x.bfloat16().float()
            elif precision != "fp32":
                raise ValueError(f"unknown precision {precision!r}")
            total = total + training.upsample(x, out_hw)
        pred = total.argmax(1)[0]
        g = gt[i].long()
        keep = g < c
        hist += torch.bincount(g[keep] * c + pred[keep], minlength=c * c)
    return hist.view(c, c)

