"""The numbers that decide ``correct``, each against a limit of its cell
(``limits/<workload>.json``).

Training, over the first step. By leaf: the gap between the program's norm and the
reference's, not the norm of their difference, over the reference's norm of that leaf
or of the median leaf, whichever is larger (some gradients are all but zero); the worst
leaf's (``grad_gap``, ``change_gap``) and the median leaf's (``*_median``):

- ``grad_gap``: each leaf's gradient;
- ``change_gap``: each leaf's change. Leaves whose reference gradient is under
  ROUNDOFF_SHARE of the median leaf's move by round-off alone and are left out; a leaf
  the reference does not move (frozen) counts against the median of the leaves it
  moves, so moving it is caught;
- ``head_change_gap``: the worst of the heads' leaves (the 10x group), against the
  median of the heads';
- ``ntm_change_gap``: the worst of T1, T2 (one Adam step) and W1, W2 (the inner loop's
  Adam steps), each against its own norm, as the four move by different amounts;
  ``ntm_grad_gap`` likewise of T1 and T2's gradients;
- ``err_<tap>``: the relative L2 error of the step's activations: the stem's, each
  stage's (``err_layer1`` ...), both heads' logits, the SimT teacher's logits;
- ``loss_gap``: |loss - reference| / |reference|;
- ``loss_core_gap``: the program's loss terms against the reference's loss computed
  from the program's own logits (``loss_core_numbers``).

Which of them a cell compares, and at what limit, its limits file says.

Evaluation: ``hist_mismatch``, over every answer of the window, the share of its
labelled pixels whose [gt, prediction] cell differs from the reference's histogram of
the same batch (half the L1 distance of the two histograms over the pixels); for the
window's sampled call, ``err_eval_logits``, the relative L2 error of both scales'
logits, and ``hist_core_mismatch``, its answer against the reference's histogram
computed from the call's own logits.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from .reference.network import trainable

ROUNDOFF_SHARE = 1e-3
NTM = ("t1", "t2", "w1", "w2")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys) -> Tuple[float, str, float]:
    """(the worst leaf's gap, that leaf, the median gap of the leaves the reference
    moves)."""
    keys = sorted(keys)
    moved = [ref[k] for k in keys if ref.get(k, 0.0) > 0]
    med = statistics.median(moved) if moved else 0.0
    gaps = {}
    for k in keys:
        r = ref.get(k, 0.0)
        den = max(r, med)
        gaps[k] = abs(prog.get(k, 0.0) - r) / den if den > 0 else math.inf
    if not gaps:
        return math.inf, "", math.inf
    worst = max(gaps, key=lambda k: (math.isnan(gaps[k]), gaps[k]))
    moving = [g for k, g in gaps.items() if ref.get(k, 0.0) > 0] or [math.inf]
    return gaps[worst], worst, statistics.median(moving)


def _tap_errs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
    """{"err_<tap>": ||program - reference|| / ||reference||} of each activation both
    sides kept (``network.tap``), over the images both hold."""
    out = {}
    for name in sorted(set(prog) | set(ref)):
        p, r = prog.get(name), ref.get(name)
        if p is None or r is None:
            out[f"err_{name}"] = math.inf
            continue
        n = min(p.shape[0], r.shape[0])
        p, r = p[:n].double(), r[:n].double()
        out[f"err_{name}"] = float((p - r).norm() / r.norm())
    return out


def _own_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The worst over ``keys`` (leaves of ``ref``) of |program - reference| / reference;
    inf where the reference's is nought and the program's is not."""
    gaps = [abs(prog.get(k, math.inf) - ref[k]) / ref[k] if ref[k] > 0 else
            (0.0 if prog.get(k) == 0 else math.inf) for k in keys]
    return max(gaps, default=0.0, key=lambda g: (math.isnan(g), g))


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: value} of the program's readings against the reference's, with the
    leaf that sets each worst-leaf number under ``<number>_leaf`` and the loss terms'
    gaps under ``loss_terms_gap`` (reported, not compared)."""
    r = ref["loss"]
    loss_gap = abs(prog["loss"] - r) / abs(r) if r else math.inf
    grad_gap, grad_leaf, grad_med = _leaf_gaps(prog["grad"], ref["grad"],
                                               set(prog["grad"]) | set(ref["grad"]))
    med = statistics.median(ref["grad"].values())
    tiny = {k for k, g in ref["grad"].items() if g < ROUNDOFF_SHARE * med}
    keys = (set(prog["change"]) | set(ref["change"])) - tiny
    change_gap, change_leaf, change_med = _leaf_gaps(prog["change"], ref["change"], keys)
    heads = {k for k in keys if trainable(k, stage="warmup") == "10x"}
    head_gap, head_leaf, _ = _leaf_gaps(prog["change"], ref["change"], heads)
    ntm = [k for k in NTM if k in ref["change"]]
    terms = {k: abs(prog["parts"][k] - v) for k, v in ref["parts"].items()
             if k in prog["parts"]}
    out = {**_tap_errs(prog.get("taps", {}), ref.get("taps", {})),
           "loss_gap": loss_gap, "grad_gap": grad_gap, "grad_gap_median": grad_med,
           "change_gap": change_gap, "change_gap_median": change_med,
           "head_change_gap": head_gap, "grad_gap_leaf": grad_leaf,
           "change_gap_leaf": change_leaf, "head_change_gap_leaf": head_leaf,
           "roundoff_leaves": len(tiny), "loss_terms_gap": terms}
    if ntm:
        out["ntm_change_gap"] = _own_gap(prog["change"], ref["change"], ntm)
        out["ntm_grad_gap"] = _own_gap(prog["grad"], ref["grad"],
                                       [k for k in ntm if k in ref["grad"]])
    return out


def loss_core_numbers(prog: Dict[str, float], ref: Dict[str, float]) -> dict:
    """{"loss_core_gap": the largest over the loss terms of |program - reference| /
    |reference|}: the program's first-step terms against the reference's loss computed
    from the program's own logits (data the program made: the check of the loss block
    alone, the stage the trunk's chaos hides)."""
    gaps = [abs(prog[k] - r) / max(abs(r), 1e-12) if k in prog else math.inf
            for k, r in ref.items()]
    return {"loss_core_gap": max(gaps) if gaps else math.inf}


def hist_share(a: torch.Tensor, b: torch.Tensor, counted: int) -> float:
    """The share of ``counted`` pixels whose [gt, prediction] cell differs between two
    histograms of the same batch (half their L1 distance over the pixels)."""
    return float((a.long() - b.long()).abs().sum()) / (2 * max(counted, 1))


def eval_numbers(answers: List[torch.Tensor], refs: List[torch.Tensor],
                 counted: List[int]) -> dict:
    """{"hist_mismatch": the worst answer's share of pixels placed differently}."""
    worst = max(hist_share(a, refs[i % len(refs)], counted[i % len(refs)])
                for i, a in enumerate(answers))
    return {"hist_mismatch": worst, "answers": len(answers)}


def logits_err(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The larger over the scales of ||program - reference|| / ||reference||."""
    if len(prog) != len(ref):
        return math.inf
    return max(float((p.double() - r.double()).norm() / r.double().norm())
               for p, r in zip(prog, ref))


def judge(numbers: dict, limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number at or under its
    limit. A number that is not finite fails and is written as 1e300, so that the
    result stays plain JSON."""
    values = {k: float(numbers[k]) for k in limits}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    checks = {k: {"value": v if math.isfinite(v) else 1e300, "limit": float(limits[k])}
              for k, v in values.items()}
    return ok, checks
