"""The network-free T-game (counterpart of the JAX package's
``experiments/ntm_identification/tgame.py``): T evolves under the SimT step's exact
T-forces with no network, so whether the NTM dynamics identify a planted T* or fall to
the class-frequency attractor is a property of those dynamics alone.

The T-estimation part of the SimT step (reference tools/trainV2_simt.py:327-435), with
its two data-driven forces at their best case:

  - the inner W loop: ``inner_steps`` Adam steps on ``sum((W T)^2)``, W's Adam state
    carried across the outer steps; with ``quirk`` (the reference's uncleared
    gradients) the T-gradients of those inner steps leak into T's update;
  - anchors: every row of T pulled to T*'s row at every step (a perfect teacher read at
    a perfectly confident pixel), ``lam_anchor * sum((T - T*)^2)``;
  - fit: ``sum_c pi_c CE(T*[c], T[c])``, the noisy-label fit of a student that has
    already converged to the clean posterior;
  - the convex term ``-lam_convex * sum((W T)^2)`` (W held) and the volume term
    ``lam_volume * log sqrt |det(T^T T)|``;
  - one Adam step on T's parameters an outer step.

Both recovery forces are at their best, so T moving away from T* here is the dynamics'
doing, not a fixture's. ``main`` runs the four force settings (reference-verbatim:
quirk and volume 1.0; each force alone; paper-faithful: no quirk, volume 0.1) on the
toy problem (C=8, O=2) and on the reference geometry (C=19, O=3 on
``ClassDist_bapa``) and prints T's mean row L1 distance from T* before and after.

    python -m simt_tpu_torch.tools.tgame                  the card, 2000 steps a run
    python -m simt_tpu_torch.tools.tgame --device cpu --steps 200

It runs on the card unless ``--device cpu``; it is a few small matrices, so it
launches no kernel of the package's own. Adam is ``torch.optim.Adam`` with optax's
defaults (betas 0.9/0.999, eps 1e-8), one for T's parameters and one for W's.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import ntm as ntm_lib
from ..ops.losses import volume_loss

Problem = Tuple[int, int, np.ndarray, np.ndarray]

# (label, run_game keywords) of the four force settings, in main's order.
SETTINGS = (
    ("reference-verbatim (quirk, vol 1.0)", dict(quirk=True, lam_volume=1.0)),
    ("quirk only (vol 0)", dict(quirk=True, lam_volume=0.0)),
    ("vol 1.0 only (no quirk)", dict(quirk=False, lam_volume=1.0)),
    ("paper-faithful (no quirk, vol 0.1)", dict(quirk=False, lam_volume=0.1)),
)


def toy_problem() -> Problem:
    """C=8 / O=2: skewed priors (a road-like class 0), diagonal-dominant known rows with
    asymmetric leaks, flat open rows."""
    c, o = 8, 2
    pi = np.array([0.26, 0.16, 0.13, 0.11, 0.09, 0.07, 0.05, 0.05, 0.04, 0.04])
    t_star = np.array([
        [0.90, 0.04, 0.02, 0.01, 0.01, 0.01, 0.005, 0.005],
        [0.18, 0.74, 0.03, 0.02, 0.01, 0.01, 0.005, 0.005],
        [0.10, 0.03, 0.80, 0.03, 0.02, 0.01, 0.005, 0.005],
        [0.08, 0.02, 0.06, 0.78, 0.03, 0.02, 0.005, 0.005],
        [0.06, 0.02, 0.02, 0.04, 0.82, 0.02, 0.01, 0.01],
        [0.05, 0.02, 0.02, 0.02, 0.04, 0.83, 0.01, 0.01],
        [0.04, 0.02, 0.01, 0.01, 0.02, 0.02, 0.86, 0.02],
        [0.04, 0.02, 0.01, 0.01, 0.01, 0.01, 0.03, 0.87],
        [0.125] * 8,
        [0.125] * 8,
    ])
    return c, o, pi, t_star


def ref_problem() -> Problem:
    """The reference geometry: C=19, O=3, the class distribution ``ClassDist_bapa``; a
    synthetic T* (diagonal 0.8, leaks proportional to class frequency, open rows the
    class marginal)."""
    c, o = 19, 3
    cd_ref = ntm_lib.load_class_dist("bapa").astype(np.float64)
    pi = np.concatenate([cd_ref, [0.03] * o])
    pi /= pi.sum()
    t_star = np.zeros((c + o, c))
    for k in range(c):
        t_star[k] = 0.2 * cd_ref / (cd_ref.sum() - cd_ref[k])
        t_star[k, k] = 0.8
        t_star[k] /= t_star[k].sum()
    t_star[c:] = cd_ref / cd_ref.sum()
    return c, o, pi, t_star


def run_game(c: int, o: int, pi: np.ndarray, t_star: np.ndarray, *, quirk: bool = True,
             lam_volume: float = 1.0, lam_convex: float = 0.1, lam_anchor: float = 1.0,
             lr_t: float = 2.5e-2, steps: int = 2000, inner_steps: int = 10,
             seed: int = 0, init: Optional[torch.Tensor] = None,
             device: Union[str, torch.device] = "cuda",
             verbose: bool = True) -> Tuple[float, float, np.ndarray]:
    """``steps`` outer steps of the game on ``device`` (the card unless ``"cpu"``) from
    T's parameters ``init`` (default ``ntm_init`` from a generator seeded with
    ``seed``): (T's mean row L1 distance from T* before, after, the final T)."""
    device = resolve_device(device)
    cd = (pi @ t_star).astype(np.float32)
    # T* must lie inside the sigmoid * cd + identity family: ntm_invert raises if a
    # planted leak exceeds its structural cap.
    p_star = ntm_lib.ntm_invert(t_star, cd, c)
    chk = ntm_lib.ntm_forward(torch.from_numpy(p_star), torch.from_numpy(cd), c, o)
    if np.abs(chk.numpy() - t_star).max() >= 1e-5:
        raise ValueError("T* is not reproduced by its inverted parameters")

    cd_t = torch.from_numpy(cd).to(device)
    t_star_t = torch.from_numpy(t_star.astype(np.float32)).to(device)
    pi_t = torch.from_numpy(pi.astype(np.float32)).to(device)

    def fwd(param):
        return ntm_lib.ntm_forward(param, cd_t, c, o)

    def main_obj(param, w_mat):
        t = fwd(param)
        anchor = torch.sum((t - t_star_t) ** 2)
        fit = -torch.sum(pi_t[:, None] * t_star_t * torch.log(t + 1e-12))
        convex = -torch.sum((w_mat @ t) ** 2)
        return lam_anchor * anchor + fit + lam_convex * convex + lam_volume * volume_loss(t)

    if init is None:
        init = ntm_lib.ntm_init(torch.Generator().manual_seed(seed), c, o)
    p = init.detach().clone().to(device).requires_grad_()
    w = ntm_lib.w_init(c, o).to(device).requires_grad_()
    p_opt = torch.optim.Adam([p], lr=lr_t, betas=(0.9, 0.999), eps=1e-8)
    w_opt = torch.optim.Adam([w], lr=lr_t, betas=(0.9, 0.999), eps=1e-8)

    def dist() -> float:
        with torch.no_grad():
            return float(np.abs(fwd(p).cpu().numpy() - t_star).sum(1).mean())

    d0 = dist()
    for i in range(steps):
        g_quirk = torch.zeros_like(p)
        for _ in range(inner_steps):
            gw, gt = torch.autograd.grad(torch.sum((ntm_lib.w_forward(w) @ fwd(p)) ** 2),
                                         (w, p))
            g_quirk = g_quirk + gt
            w.grad = gw
            w_opt.step()
        (g,) = torch.autograd.grad(main_obj(p, ntm_lib.w_forward(w).detach()), (p,))
        p.grad = g + g_quirk if quirk else g
        p_opt.step()
        if verbose and (i + 1) % max(1, steps // 5) == 0:
            print(f"  step {i + 1}: dT={dist():.4f}", flush=True)
    d1 = dist()
    return d0, d1, fwd(p).detach().cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the network-free T-game (PyTorch)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr-t", type=float, default=2.5e-2)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """The four force settings on both problems; one line each, and the records."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = []
    for name, prob in (("toy C=8/O=2", toy_problem()),
                       ("reference C=19/O=3", ref_problem())):
        print(f"== {name} ==")
        for label, kw in SETTINGS:
            d0, d1, _ = run_game(*prob, steps=args.steps, lr_t=args.lr_t, device=dev,
                                 verbose=False, **kw)
            print(f"  {label:40s} dT {d0:.3f} -> {d1:.3f} (ratio {d1 / d0:.2f})")
            out.append({"problem": name, "setting": label, "d0": d0, "d1": d1})
    return out


if __name__ == "__main__":
    main()
