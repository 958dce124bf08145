"""Planted-noise recovery at the reference geometry on the card (counterpart of the JAX
package's ``experiments/planted_noise_tpu/run.py``).

Clean synthetic labels are corrupted through a KNOWN (C+O)xC transition matrix T*, and
the SimT mechanism is run against it at the operating point the port was built for:
512x1024 crops, 19 known + 15 open classes, the full dilated ResNet-101, bf16 autocast,
batch 1, every batch resident on the device. One warmup on the noisy labels is shared
by four arms:

  ce        plain cross-entropy control (the warmup step, continued)
  verbatim  reference-verbatim SimT (the inner W loop's T-gradients kept,
            lambda_volume 1.0)
  paper     paper-faithful SimT (``clear_inner_t_grads=True``, lambda_volume 0.1)
  oracle    T frozen at the planted T* (both T parameters at P*, lr_t 0)

The fixture is the JAX run's, drawn by the same numpy calls in the same order, so a
seed gives the same images, clean labels, noisy labels and teacher posteriors: 9
feature-overlapping class pairs + 1 singleton + 15 open clusters; T* with the big
asymmetric leak into the road-like class 0 and per-pair leaks at their structural caps
(``models/ntm.py::ntm_invert`` plants it inside the NTM family), open rows equal to the
noisy-label marginal ``class_dist``. The teacher is the Bayes posterior of the noisy
label given the cell features, fed through the SimT step's cached-posterior path (the
batch's ``teacher_prob8``): the SimT steps run B2/B3 and B4/B5, the warmup steps B4/B5.

    python -m simt_tpu_torch.tools.planted_noise        the card, 4 arms x 1200 steps
    python -m simt_tpu_torch.tools.planted_noise --warmup-steps 3000 --train-steps 1200 \\
        --n-train 24 --n-val 4                           the JAX record's protocol
    python -m simt_tpu_torch.tools.planted_noise --smoke --device cpu
        layers (1,1,1,1), float32, 5 + 3 classes at 64x128: the plumbing

``--smoke`` chooses the geometry only; the device is ``--device`` (the card by
default). The results go to ``--out`` (default ``build/planted_noise/planted.json``, in
the JAX run's layout, ``platform`` the card's name); steps/s are the device's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, OptimConfig, SimTConfig, TrainConfig
from ..device import resolve_device
from ..models import ResNetMulti, init_weights
from ..models import ntm as ntm_lib
from ..models.from_jax import load_matching
from ..ops.interp import upsample_bilinear_align_corners as up
from ..ops.metrics import fast_hist, per_class_iu
from ..train import create_simt_state, create_warmup_state, make_simt_step, make_warmup_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "planted_noise", "planted.json")
TPU_RECORD = os.path.join(REPO, "PLANTED_TPU_r05.json")  # never written here
RESNET101 = (3, 4, 23, 3)
SMOKE_LAYERS = (1, 1, 1, 1)
FULL_KNOWN_PI = [0.15, 0.09] + [0.042, 0.028] * 8 + [0.05]
# The JAX run's smoke priors, [0.22, 0.13, 0.20, 0.12, 0.18], fail the fixture's own
# check (class_dist's max 0.3047 is not below THRESH_LOW - 0.02): 0.01 of the road
# class's prior moves to class 3, which leaves the max at 0.2938.
SMOKE_KNOWN_PI = [0.21, 0.13, 0.20, 0.13, 0.18]
PAPER_KW = dict(clear_inner_t_grads=True, lambda_volume=0.1)
SIMT_LOGGED = ("loss_seg_p", "loss_seg_y", "convex", "volume", "anchor", "place")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Fixture:
    """The planted-noise fixture at any scale (the JAX run's ``Fixture``).

    Knowns = ``pairs`` feature-overlapping pairs (2 sigma apart along ch0) + ``extra``
    well-separated singletons; ``opens`` open clusters 4+ sigma from every known. Pair
    (0, 1) is the road-like pair: dominant priors and the big asymmetric leak.
    """

    CELL = 8  # noise/feature cell = the model's stride-8 output resolution
    REGION = 2  # same-class regions of REGIONxREGION cells (contiguous objects)
    SIGMA = 1.0
    JITTER = 0.25
    THRESH_HIGH = 0.60  # boundary-unbiased
    THRESH_LOW = 0.32  # above every open row's max (~0.29), below known-core confidence

    def __init__(self, pairs: int, extra: int, opens: int, hw, known_pi):
        self.C = 2 * pairs + extra
        self.O = opens
        self.TOTAL = self.C + self.O
        self.HW = tuple(hw)
        assert self.HW[0] % (self.CELL * self.REGION) == 0
        assert self.HW[1] % (self.CELL * self.REGION) == 0
        self.G = (self.HW[0] // self.CELL, self.HW[1] // self.CELL)
        # The stride-8 output grid (H/8 + 1: 65x129 at 512x1024).
        self.G8 = (self.G[0] + 1, self.G[1] + 1)
        C, O = self.C, self.O

        # Priors: known-class weights summing to 0.85 (road pair dominant, the other
        # pairs asymmetric), opens rare at 0.15 in all. Every leak cap below is bounded
        # by cd_j, so the priors and T* are designed together.
        pi = np.zeros(self.TOTAL)
        known_pi = np.asarray(known_pi, np.float64)
        assert known_pi.shape == (C,) and abs(known_pi.sum() - 0.85) < 1e-6
        pi[:C] = known_pi
        pi[C:] = 0.15 / O
        pi /= pi.sum()
        self.PI = pi.astype(np.float32)

        # Planted T*: diagonal-dominant known rows with road and pair leaks over a small
        # uniform floor; open rows all equal to the noisy-label marginal cd (flat, max
        # below THRESH_LOW, inside every structural cap).
        floor = 0.003
        t = np.zeros((self.TOTAL, C))
        for k in range(C):
            row = np.full(C, floor)
            row[k] = 0.0
            if k == 0:
                row[1] = 0.01
            elif k == 1:
                row[0] = 0.14  # the big representable leak, into the road class
            else:
                row[0] = 0.05
                if k < 2 * pairs:
                    partner = k ^ 1
                    row[partner] = 0.035 if (k % 2) else 0.008  # asymmetric pair leak
            row[k] = 1.0 - row.sum()
            t[k] = row
        # The open-row fixed point: open rows == cd == sum_c pi_c T*[c]
        #   => cd = (pi_known @ T_known) / (1 - sum(pi_open)).
        m = self.PI[:C] @ t[:C]
        cd = m / (1.0 - self.PI[C:].sum())
        t[C:] = cd
        self.T_STAR = t.astype(np.float32)
        self.CLASS_DIST = (self.PI @ self.T_STAR).astype(np.float32)
        np.testing.assert_allclose(self.CLASS_DIST, cd.astype(np.float32), atol=1e-6)
        assert self.CLASS_DIST.max() < self.THRESH_LOW - 0.02, self.CLASS_DIST.max()

        # The verbatim dynamics' attractor: row_k -> (e_k + cd) / (1 + sum(cd)).
        attr = np.concatenate(
            [np.eye(C, dtype=np.float32), np.zeros((O, C), np.float32)], axis=0)
        self.T_ATTR = (attr + self.CLASS_DIST) / (1.0 + self.CLASS_DIST.sum())

        # Exact inversion: raises if a leak exceeds its structural cap.
        self.P_STAR = ntm_lib.ntm_invert(self.T_STAR, self.CLASS_DIST, C)
        np.testing.assert_allclose(
            ntm_lib.ntm_forward(torch.from_numpy(self.P_STAR),
                                torch.from_numpy(self.CLASS_DIST), C, O).numpy(),
            self.T_STAR, atol=1e-5)

        # Feature means (3 channels): pair centres on a radius-5 circle in (ch1, ch2),
        # members at ch0 = +/-1 (2 sigma overlap); singletons on the same circle at
        # ch0 = 0; opens on a radius-5 circle at ch0 = +5.
        n_centers = pairs + extra
        means = np.zeros((self.TOTAL, 3), np.float32)
        for p in range(pairs):
            a = 2 * np.pi * p / n_centers
            means[2 * p] = [+1.0, 5 * np.cos(a), 5 * np.sin(a)]
            means[2 * p + 1] = [-1.0, 5 * np.cos(a), 5 * np.sin(a)]
        for e in range(extra):
            a = 2 * np.pi * (pairs + e) / n_centers
            means[2 * pairs + e] = [0.0, 5 * np.cos(a), 5 * np.sin(a)]
        for o in range(O):
            a = 2 * np.pi * (o + 0.5) / O
            means[C + o] = [5.0, 5 * np.cos(a), 5 * np.sin(a)]
        self.MEANS = means

    def bayes_teacher(self, cell_feat: np.ndarray) -> np.ndarray:
        """The Bayes posterior of the noisy label given the cell features."""
        d2 = ((cell_feat[..., None, :] - self.MEANS) ** 2).sum(-1)
        logp = np.log(self.PI) - 0.5 * d2 / self.SIGMA**2
        logp -= logp.max(-1, keepdims=True)
        p = np.exp(logp)
        p /= p.sum(-1, keepdims=True)
        return (p @ self.T_STAR).astype(np.float32)

    def make_clean8(self, rng) -> np.ndarray:
        g_r = (self.G[0] // self.REGION, self.G[1] // self.REGION)
        while True:
            m = rng.choice(self.TOTAL, size=g_r, p=self.PI)
            if len(np.unique(m)) == self.TOTAL:
                return np.repeat(np.repeat(m, self.REGION, 0), self.REGION, 1)

    def make_example(self, rng):
        """(image HxWx3 float32, clean HxW int32, noisy HxW int32, teacher posterior
        G8 x C float32) from ``rng`` (a ``np.random.RandomState``)."""
        clean8 = self.make_clean8(rng)
        clean = np.repeat(np.repeat(clean8, self.CELL, 0), self.CELL, 1)
        cell_feat = (self.MEANS[clean8]
                     + self.SIGMA * rng.randn(*self.G, 3)).astype(np.float32)
        image = np.repeat(np.repeat(cell_feat, self.CELL, 0), self.CELL, 1)
        image = image + self.JITTER * rng.randn(*self.HW, 3).astype(np.float32)
        # Per-pixel noisy label ~ Categorical(T*[clean]) by the inverse CDF.
        u = rng.rand(*self.HW, 1).astype(np.float32)
        cdf = np.cumsum(self.T_STAR[clean], axis=-1)
        noisy = np.sum(u > cdf, axis=-1).astype(np.int32)
        ii = np.minimum(np.arange(self.G8[0]), self.G[0] - 1)
        jj = np.minimum(np.arange(self.G8[1]), self.G[1] - 1)
        tprob = self.bayes_teacher(cell_feat[np.ix_(ii, jj)])
        return image.astype(np.float32), clean.astype(np.int32), noisy, tprob

    def make_dataset(self, n: int, seed: int, device="cpu") -> List[Dict[str, torch.Tensor]]:
        """``n`` batches of size 1 on ``device``: ``image``, ``label`` (noisy),
        ``teacher_prob8`` and ``_clean`` (for the evaluation)."""
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            im, cl, ny, tp = self.make_example(rng)
            out.append({k: torch.from_numpy(v[None]).to(device) for k, v in
                        (("image", im), ("label", ny), ("teacher_prob8", tp),
                         ("_clean", cl))})
        return out

    def routing_diagnostics(self, batches) -> dict:
        """Fractions of stride-8 teacher nodes routed conf / unknown / ignore, and the
        conf labels' error rate against the clean class: the teacher's quality."""
        conf = unk = ign = conf_wrong = total = 0
        for b in batches:
            tp = _np(b["teacher_prob8"][0])
            mx, am = tp.max(-1), tp.argmax(-1)
            cl8 = _np(b["_clean"][0])[:: self.CELL, :: self.CELL]
            cl8 = np.pad(cl8, ((0, 1), (0, 1)), mode="edge")
            c = mx > self.THRESH_HIGH
            u = mx < self.THRESH_LOW
            conf += int(c.sum())
            unk += int(u.sum())
            ign += int((~c & ~u).sum())
            total += mx.size
            conf_wrong += int((c & (am != cl8)).sum())
        return {"conf_frac": conf / total, "unknown_frac": unk / total,
                "ignore_frac": ign / total, "conf_err": conf_wrong / max(conf, 1)}


def geometry(smoke: bool) -> Tuple[Fixture, Tuple[int, ...], str]:
    """(fixture, model layers, compute dtype name): the reference geometry, or the
    ``--smoke`` one (the JAX run's, with ``SMOKE_KNOWN_PI``)."""
    if smoke:
        return (Fixture(pairs=2, extra=1, opens=3, hw=(64, 128), known_pi=SMOKE_KNOWN_PI),
                SMOKE_LAYERS, "float32")
    return (Fixture(pairs=9, extra=1, opens=15, hw=(512, 1024), known_pi=FULL_KNOWN_PI),
            RESNET101, "bfloat16")


def make_cfg(fx: Fixture, stage: str, steps: int, lr: float, lr_t: float,
             dtype_name: str, cd_path: str, **simt_kw) -> TrainConfig:
    """The run's config: the poly schedule over ``steps``, SimT's thresholds
    0.60 / 0.32 and 10 inner W steps, the class distribution read from ``cd_path``."""
    return TrainConfig(
        stage=stage,
        model=ModelConfig(num_classes=fx.C, open_classes=fx.O, openset=stage == "simt",
                          compute_dtype=dtype_name),
        optim=OptimConfig(num_steps=steps, learning_rate=lr, learning_rate_t=lr_t),
        simt=SimTConfig(**{**dict(class_dist=cd_path, threshold_high=fx.THRESH_HIGH,
                                  threshold_low=fx.THRESH_LOW, inner_w_steps=10),
                           **simt_kw}))


def model_of(fx: Fixture, openset: bool, layers: Sequence[int],
             dtype: torch.dtype) -> ResNetMulti:
    return ResNetMulti(fx.C, fx.O if openset else 0, openset, layers=layers, dtype=dtype)


@dataclasses.dataclass
class Inits:
    """The starting weights: the warm model's and the student's ``state_dict`` (the
    student's before it takes the warm weights), and T1's and T2's parameters."""

    warm: Mapping[str, torch.Tensor]
    student: Mapping[str, torch.Tensor]
    ntm: Tuple[torch.Tensor, torch.Tensor]


def seeded_inits(fx: Fixture, layers: Sequence[int], seed: int) -> Inits:
    """The run's seeded initialisation (the JAX run's keys seed, seed + 1, seed + 3):
    the warm model from ``seed``, the student from ``seed + 1``, T1 and T2 from
    ``seed + 3``."""
    warm = init_weights(model_of(fx, False, layers, torch.float32),
                        torch.Generator().manual_seed(seed))
    student = init_weights(model_of(fx, True, layers, torch.float32),
                           torch.Generator().manual_seed(seed + 1))
    g = torch.Generator().manual_seed(seed + 3)
    t1 = ntm_lib.ntm_init(g, fx.C, fx.O)
    t2 = ntm_lib.ntm_init(g, fx.C, fx.O)
    return Inits(warm.state_dict(), student.state_dict(), (t1, t2))


def _load_whole(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    report = load_matching(model, state_dict)
    if report["missing"] or report["skipped"]:
        raise ValueError(f"starting weights do not cover the model: missing "
                         f"{report['missing'][:5]}, shape mismatch {report['skipped'][:5]}")


def eval_logits(model: torch.nn.Module, image: torch.Tensor) -> torch.Tensor:
    """Head 2's logits (B, h8, w8, K) in float32, the model in eval mode (BatchNorm on
    its running statistics); the model's mode is restored after."""
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            _, x2 = model(image.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
    finally:
        model.train(training)
    return x2.permute(0, 2, 3, 1).float()


def clean_hist(model: torch.nn.Module, batch: Dict, fx: Fixture) -> np.ndarray:
    """The confusion histogram of the clean labels against the argmax over the C known
    channels of head 2's logits, upsampled (align corners) to the crop."""
    logits = up(eval_logits(model, batch["image"]), fx.HW)
    pred = logits[..., :fx.C].argmax(-1)
    return fast_hist(batch["_clean"], pred, fx.C).cpu().numpy()


def miou(model: torch.nn.Module, batches, fx: Fixture) -> float:
    h = sum(clean_hist(model, b, fx) for b in batches).astype(np.float64)
    return float(np.nanmean(per_class_iu(h)))


def t_metrics(fx: Fixture, t1_param: torch.Tensor, t2_param: torch.Tensor) -> dict:
    """Distances of T1/T2's known rows from T* (``t_dist_known``) and from the
    attractor (``t_attr_known``), mean row L1 over both heads; T1's leak 1 -> 0."""
    cd = torch.from_numpy(fx.CLASS_DIST)

    def t_of(param):
        return ntm_lib.ntm_forward(param.detach().cpu(), cd, fx.C, fx.O).numpy()

    def d(t, target):
        return float(np.abs(t - target).sum(1)[: fx.C].mean())

    t1, t2 = t_of(t1_param), t_of(t2_param)
    return {"t_dist_known": 0.5 * (d(t1, fx.T_STAR) + d(t2, fx.T_STAR)),
            "t_attr_known": 0.5 * (d(t1, fx.T_ATTR) + d(t2, fx.T_ATTR)),
            "t1_leak_10": float(t1[1, 0])}


def anchor_diag(model: torch.nn.Module, batch: Dict,
                fx: Fixture) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The realised anchors' quality (trainV2_simt.py:374-384 takes these rows as T's
    targets): per known channel k, the teacher posterior at the student's max-logit
    pixel against T*'s row (L1), whether that pixel's CLEAN class is k, and the
    teacher row's own max there."""
    c = fx.C
    lg = up(eval_logits(model, batch["image"]), fx.HW).reshape(-1, fx.TOTAL)
    tp = up(batch["teacher_prob8"].float(), fx.HW).reshape(-1, c)
    idx = lg.argmax(0)  # (C+O,)
    rows = tp[idx[:c]]  # (C, C)
    t_star = torch.from_numpy(fx.T_STAR[:c]).to(rows.device)
    err = (rows - t_star).abs().sum(1)
    on_class = batch["_clean"].reshape(-1)[idx[:c]] == torch.arange(c, device=rows.device)
    return _np(err), _np(on_class), _np(rows.max(1).values)


def run_steps(step, state, steps: int, log_every: int, train_data: list,
              eval_cb: Callable, arm: str, print_fn: Callable) -> list:
    """``steps`` steps on ``train_data`` (cyclic), in windows of ``log_every`` each
    ended by a host read of the loss (a sync) and ``eval_cb(state, metrics)``."""
    traj = []
    for start in range(0, steps, log_every):
        n = min(log_every, steps - start)
        t0 = time.perf_counter()
        m = None
        for i in range(start, start + n):
            m = step(state, train_data[i % len(train_data)])
        loss = float(m["loss"] if "loss" in m else m["loss_seg2"])
        dt = time.perf_counter() - t0
        rec = {"step": start + n, "loss": round(loss, 4), "steps_per_sec": round(n / dt, 2)}
        rec.update(eval_cb(state, m))
        traj.append(rec)
        print_fn(f"[{arm}] {rec}")
    return traj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="planted-noise recovery (PyTorch + CUDA)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny fixture + tiny model (layers 1,1,1,1, float32): the plumbing")
    p.add_argument("--arms", default="ce,verbatim,paper,oracle")
    p.add_argument("--warmup-steps", type=int, default=2000)
    p.add_argument("--train-steps", type=int, default=1200)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--n-train", type=int, default=8, help="distinct training examples")
    p.add_argument("--n-val", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-t", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def run(args, inits: Inits, print_fn: Callable = print) -> dict:
    """The run of ``args`` from ``inits``; writes and returns the results."""
    if os.path.abspath(args.out) == TPU_RECORD:
        raise SystemExit(f"--out {args.out} is the TPU run's record; write elsewhere")
    dev = resolve_device(args.device)
    fx, layers, dtype_name = geometry(args.smoke)
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    C, O, HW = fx.C, fx.O, fx.HW
    platform = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print_fn(f"fixture: C={C} O={O} HW={HW} platform={platform}")
    print_fn(f"T* diag: {np.round(np.diag(fx.T_STAR[:C]), 3)}")
    print_fn(f"class_dist: {np.round(fx.CLASS_DIST, 3)}")

    train_data = fx.make_dataset(args.n_train, args.seed, dev)
    val_data = fx.make_dataset(args.n_val, args.seed + 10_000, dev)
    diag = fx.routing_diagnostics(train_data)
    print_fn(f"teacher routing: { {k: round(v, 4) for k, v in diag.items()} }")

    results = {"geometry": {"hw": HW, "C": C, "O": O, "layers": list(layers),
                            "dtype": dtype_name, "batch": 1,
                            "n_train": args.n_train, "n_val": args.n_val,
                            "warmup_steps": args.warmup_steps,
                            "train_steps": args.train_steps,
                            "lr": args.lr, "lr_t": args.lr_t, "seed": args.seed,
                            "threshold_high": fx.THRESH_HIGH,
                            "threshold_low": fx.THRESH_LOW},
               "teacher_routing": diag,
               "platform": platform,
               "arms": {}}
    arms = [s.strip() for s in args.arms.split(",") if s.strip()]

    with tempfile.TemporaryDirectory(prefix="simt_planted_") as tmp:
        cd_path = os.path.join(tmp, "class_dist.npy")
        np.save(cd_path, fx.CLASS_DIST)

        # ---- the shared warmup on the noisy labels; the CE arm continues it ----
        wcfg = make_cfg(fx, "warmup", args.warmup_steps + args.train_steps, args.lr,
                        args.lr_t, dtype_name, cd_path)
        wmodel = model_of(fx, False, layers, dtype)
        _load_whole(wmodel, inits.warm)
        wstate = create_warmup_state(wmodel, wcfg, dev)
        wstep = make_warmup_step(wcfg)

        def warm_eval(st, m):
            return {"train_clean_miou": round(miou(st.model, train_data, fx), 4),
                    "val_miou": round(miou(st.model, val_data, fx), 4)}

        print_fn(f"warmup: {args.warmup_steps} steps...")
        results["warmup_traj"] = run_steps(
            wstep, wstate, args.warmup_steps,
            max(args.log_every, args.warmup_steps // 4), train_data, warm_eval, "warmup",
            print_fn)
        # The SimT arms start from the warm weights as they are here, before CE.
        warm_sd = {k: v.detach().clone() for k, v in wstate.model.state_dict().items()}

        if "ce" in arms:
            ce_traj = run_steps(wstep, wstate, args.train_steps, args.log_every,
                                train_data, warm_eval, "ce", print_fn)
            results["arms"]["ce"] = {"traj": ce_traj, **ce_traj[-1]}
        del wstate, wmodel

        # ---- the SimT arms from the shared warm start ----
        def run_simt_arm(name, simt_kw=None, oracle_t=False, lr_t=None):
            scfg = make_cfg(fx, "simt", args.train_steps, args.lr,
                            args.lr_t if lr_t is None else lr_t, dtype_name, cd_path,
                            **(simt_kw or {}))
            student = model_of(fx, True, layers, dtype)
            _load_whole(student, inits.student)
            load_matching(student, warm_sd)  # the key and shape intersection
            teacher = model_of(fx, False, layers, dtype)
            teacher.load_state_dict(warm_sd)
            sstate = create_simt_state(student, teacher, scfg,
                                       torch.Generator().manual_seed(args.seed + 3), dev)
            t_init = ((torch.from_numpy(fx.P_STAR),) * 2 if oracle_t else inits.ntm)
            with torch.no_grad():
                sstate.t1.param.copy_(t_init[0])
                sstate.t2.param.copy_(t_init[1])
            sstep = make_simt_step(scfg)

            def simt_eval(st, m):
                err, _, _ = anchor_diag(st.model, train_data[0], fx)
                rec = {"train_clean_miou": round(miou(st.model, train_data, fx), 4),
                       "val_miou": round(miou(st.model, val_data, fx), 4),
                       "anchor_err_known": round(float(err.mean()), 4)}
                rec.update({k: round(v, 4) for k, v in
                            t_metrics(fx, st.t1.param, st.t2.param).items()})
                for key in SIMT_LOGGED:
                    rec[key] = round(float(m[key]), 3)
                return rec

            init_t = {k: round(v, 4) for k, v in
                      t_metrics(fx, sstate.t1.param, sstate.t2.param).items()}
            print_fn(f"[{name}] init {init_t}")
            traj = run_steps(sstep, sstate, args.train_steps, args.log_every, train_data,
                             simt_eval, name, print_fn)
            t1_final = ntm_lib.ntm_forward(sstate.t1.param.detach().cpu(),
                                           torch.from_numpy(fx.CLASS_DIST), C, O).numpy()
            # The anchor-point assumption's post-mortem over every train batch: how often
            # the student's most confident pixel of a channel is ON its clean class, and
            # how confident the teacher is there.
            errs, ons, confs = zip(*(anchor_diag(sstate.model, b, fx) for b in train_data))
            adiag = {"anchor_on_class_frac": round(float(np.mean(ons)), 4),
                     "anchor_teacher_conf_mean": round(float(np.mean(confs)), 4),
                     "anchor_err_known_mean": round(float(np.mean(errs)), 4)}
            print_fn(f"[{name}] anchor diag {adiag}")
            print_fn(f"[{name}] per-ch err (batch0): "
                     + " ".join(f"{x:.2f}" for x in errs[0]))
            return {"init": init_t, "traj": traj, **traj[-1], **adiag,
                    "t1_diag_final": [round(float(x), 4) for x in np.diag(t1_final[:C])]}

        for name in arms:
            if name == "ce":
                continue
            kw = {"verbatim": {},
                  "paper": dict(simt_kw=PAPER_KW),
                  "oracle": dict(oracle_t=True, lr_t=0.0)}[name]
            results["arms"][name] = run_simt_arm(name, **kw)

    results["summary"] = summary(results["arms"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print_fn(f"summary: {json.dumps(results['summary'])}")
    print_fn(f"wrote {args.out}")
    return results


def summary(arm_r: dict) -> dict:
    """The causal-ordering facts of the run (the JAX run's ``summary``)."""
    s = {}
    if "ce" in arm_r and "oracle" in arm_r:
        s["oracle_val_minus_ce_val"] = round(
            arm_r["oracle"]["val_miou"] - arm_r["ce"]["val_miou"], 4)
        s["ce_train_minus_oracle_train"] = round(
            arm_r["ce"]["train_clean_miou"] - arm_r["oracle"]["train_clean_miou"], 4)
    if "paper" in arm_r:
        s["paper_dTk_init_to_final"] = [arm_r["paper"]["init"]["t_dist_known"],
                                        arm_r["paper"]["t_dist_known"]]
    if "verbatim" in arm_r:
        s["verbatim_dTk_init_to_final"] = [arm_r["verbatim"]["init"]["t_dist_known"],
                                           arm_r["verbatim"]["t_dist_known"]]
        s["verbatim_dAttrK_init_to_final"] = [arm_r["verbatim"]["init"]["t_attr_known"],
                                              arm_r["verbatim"]["t_attr_known"]]
    if "paper" in arm_r and "verbatim" in arm_r:
        s["paper_val_minus_verbatim_val"] = round(
            arm_r["paper"]["val_miou"] - arm_r["verbatim"]["val_miou"], 4)
    return s


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parses ``argv`` and runs from the seeded initialisation."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before building anything
    fx, layers, _ = geometry(args.smoke)
    return run(args, seeded_inits(fx, layers, args.seed))


if __name__ == "__main__":
    main()
