"""Seed calibration of the planted-noise run (counterpart of the JAX package's
``experiments/ntm_identification/calibrate.py``).

The JAX program runs its CPU suite's planted-noise experiment
(``tests/test_planted_noise.py::run_experiment``) once for each seed it is given, to
calibrate that test's margins across seeds. The port's counterpart of that experiment
is its planted run, ``tools/planted_noise.py`` (the fixture, the shared warmup and the
four arms of the JAX run at the reference geometry), so this runs
``planted_noise.run`` once a seed, with the planted run's own flags, and prints one
JSON line a seed in calibrate.py's layout:

  seed          the run's seed (images, labels and initial weights)
  miou_ce       the CE arm's train-clean mIoU
  miou_ce_val   the CE arm's val mIoU
  verbatim, paper, oracle
                each arm's metrics, without T1 itself: ``miou_simt`` and
                ``miou_simt_val`` (train-clean and val mIoU), ``t_dist_known`` and
                ``t_attr_known`` (T's known rows from T* and from the attractor) at
                ``_init`` and ``_final``

rounded to 4 places. The JAX lines also hold ``t_dist`` over every row of T; the
planted run measures T's known rows only (its open rows are planted at the class
marginal, the attractor's own value), so those two keys are left out. Each seed's
whole record goes to ``--out`` with ``{seed}`` filled in; the planted run's progress
goes to stderr, the JSON lines alone to stdout.

    python -m simt_tpu_torch.tools.calibrate 1 2 3 --warmup-steps 3000 \\
        --train-steps 1200 --n-train 24 --n-val 4        the card, ~12 min a seed
    python -m simt_tpu_torch.tools.calibrate 0 1 --smoke --device cpu --warmup-steps 4 \\
        --train-steps 2 --log-every 1 --n-train 2 --n-val 1     the plumbing, seconds
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from ..device import resolve_device
from . import planted_noise

DEFAULT_OUT = os.path.join(planted_noise.REPO, "build", "planted_noise",
                           "planted_seed{seed}.json")
ARMS = ("verbatim", "paper", "oracle")
T_KEYS = ("t_dist_known", "t_attr_known")


def build_parser() -> argparse.ArgumentParser:
    p = planted_noise.build_parser()
    p.description = "planted-noise seed calibration (PyTorch + CUDA)"
    p.add_argument("seeds", nargs="*", type=int,
                   help="the seeds to run (default: --seed)")
    p.set_defaults(out=DEFAULT_OUT)
    return p


def line(seed: int, results: Dict) -> Dict:
    """The calibration line of one planted run's ``results``."""
    arms = results["arms"]
    out = {"seed": seed,
           "miou_ce": round(float(arms["ce"]["train_clean_miou"]), 4),
           "miou_ce_val": round(float(arms["ce"]["val_miou"]), 4)}
    for name in ARMS:
        a = arms[name]
        metrics = {"miou_simt": a["train_clean_miou"], "miou_simt_val": a["val_miou"]}
        metrics.update({f"{k}_init": a["init"][k] for k in T_KEYS})
        metrics.update({f"{k}_final": a[k] for k in T_KEYS})
        out[name] = {k: round(float(v), 4) for k, v in metrics.items()}
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Runs the planted experiment for each seed of ``argv`` (its flags those of
    ``tools/planted_noise.py``) and prints one calibration line each; returns them."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card: raise before building anything
    template = args.out
    fx, layers, _ = planted_noise.geometry(args.smoke)
    lines = []
    for seed in args.seeds or [args.seed]:
        run_args = argparse.Namespace(**{**vars(args), "seed": seed,
                                         "out": template.format(seed=seed)})
        results = planted_noise.run(run_args, planted_noise.seeded_inits(fx, layers, seed),
                                    print_fn=lambda s: print(s, file=sys.stderr,
                                                             flush=True))
        lines.append(line(seed, results))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
