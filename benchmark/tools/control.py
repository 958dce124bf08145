"""The readings the limits of ``limits/<workload>.json`` are set from, at a cell's own
sizes, in one process:

- the program's: for each of ``--program-seeds``, set-up (the first steps of a train
  cell; for an eval cell a window of ``--window`` seconds) and the reference's check,
  as a run makes them;
- the control's, for each of ``--control-seeds``: the reference in the program's
  place in the precision below the configuration's (bf16 -> fp8: every convolution as
  fp8 training computes it), against the float32 reference; and the float32 loss (train)
  or eval head (eval) computed from bf16-rounded logits, against the same from the
  reference's float32 logits;
- for a train cell, planted faults, the same seeds: half of the batch left out and the
  mean taken over the rest, in the reference put in the program's place; and for a
  SimT cell the program with its inner W loop taking no step (``inner_w_steps`` 0). A
  state left unchanged reads 1 by ``compare``'s measure and needs no run;
- for a train cell, two witnesses, the same seeds: the reference with every convolution
  in bf16 (the configuration's precision, without the port) and the port in float32
  (the reference's precision), each against the float32 reference. (With TF32 off
  from the reference's first run on.)

    python -m benchmark.tools.control --workload simt_train_b16 \
        --program-seeds 11,12,... --control-seeds 21,22,23 [--kinds K,...] [--out FILE]

``--kinds`` keeps only the named control readings (``control_fp8``,
``control_bf16_loss``, ``control_bf16_hist``, ``fault_half_batch``,
``fault_inner_w_0``, ``witness_bf16``, ``witness_port_fp32``); all by default.

One JSON line a reading on stdout (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Iterable, List, Optional, Sequence

import torch

from .. import compare, harness, inputs


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def program_reading(workload: str, seed: int, device, window_s: float = 2.0,
                    overrides: Optional[dict] = None) -> dict:
    run = harness.Run(workload, seed, device, overrides)
    cell = harness.driver(run).Cell(run)
    if run.mix["driver"] == "eval":
        cell.window(window_s)
    cell.release()
    numbers = cell.check()
    del cell
    _free(run.device)
    return {"workload": workload, "kind": "program", "seed": seed, **numbers}


def control_readings(workload: str, seed: int, device, overrides: Optional[dict] = None,
                     kinds: Optional[Sequence[str]] = None) -> List[dict]:
    """The control's readings and, for a train cell, the faults' and the witnesses'
    (those of ``kinds``, or all)."""
    run = harness.Run(workload, seed, device, overrides)
    drv = harness.driver(run)
    c = run.config["model"]["num_classes"]
    out = []

    def want(kind: str) -> bool:
        return kinds is None or kind in kinds

    def program_cell(over: dict):
        cell = drv.Cell(harness.Run(workload, seed, device,
                                    harness.merge(overrides or {}, over)))
        cell.release()
        return cell.readings

    if run.mix["driver"] == "eval":
        pool = inputs.eval_pool(seed, run.mix, c, run.device)
        k = inputs.sub_seed(seed, "eval_sample") % len(pool)
        ref = drv.reference(run, pool, k)
        counted = [inputs.counted(b["gt"], c) for b in pool]
        if want("control_fp8"):
            ctl = drv.reference(run, pool, k, "fp8")
            out.append({"kind": "control_fp8",
                        **compare.eval_numbers(ctl["hists"], ref["hists"], counted),
                        "err_eval_logits": compare.logits_err(ctl["logits"],
                                                              ref["logits"])})
        if want("control_bf16_hist"):
            mod, gt, out_hw = drv.reference_module(run), pool[k]["gt"], run.mix["out_hw"]
            out.append({"kind": "control_bf16_hist",
                        "hist_core_mismatch": compare.hist_share(
                            mod.hist_from_logits(ref["logits"], gt, out_hw, "bf16").cpu(),
                            mod.hist_from_logits(ref["logits"], gt, out_hw).cpu(),
                            counted[k])})
    else:
        pool = inputs.train_pool(seed, run.mix, c, run.device)
        ref = drv.reference(run, pool)
        if want("control_fp8"):
            out.append({"kind": "control_fp8",
                        **compare.train_numbers(drv.reference(run, pool, "fp8"), ref)})
        if want("control_bf16_loss"):
            out.append({"kind": "control_bf16_loss", **compare.loss_core_numbers(
                drv.loss_terms(run, pool, ref["own"], "bf16"),
                drv.loss_terms(run, pool, ref["own"]))})
        if want("fault_half_batch"):
            out.append({"kind": "fault_half_batch", **compare.train_numbers(
                drv.reference(run, pool, half_batch=True), ref)})
        if run.config["stage"] == "simt" and want("fault_inner_w_0"):
            readings = program_cell({"config": {"simt": {"inner_w_steps": 0}}})
            out.append({"kind": "fault_inner_w_0",
                        **compare.train_numbers(readings, ref)})
        if want("witness_bf16"):
            out.append({"kind": "witness_bf16",
                        **compare.train_numbers(drv.reference(run, pool, "bf16"), ref)})
        if want("witness_port_fp32"):
            readings = program_cell({"config": {"model": {"compute_dtype": "float32"}}})
            out.append({"kind": "witness_port_fp32",
                        **compare.train_numbers(readings, ref)})
    del pool
    _free(run.device)
    return [{"workload": workload, "seed": seed, **r} for r in out]


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv: Optional[Iterable[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--kinds", type=lambda v: [k for k in v.split(",") if k], default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("control: no CUDA card; the readings are taken on the card")
    name = torch.cuda.get_device_name(0)

    def emit(r: dict) -> None:
        line = json.dumps({**r, "card": name})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.program_seeds:
        emit(program_reading(args.workload, seed, "cuda", args.window))
    for seed in args.control_seeds:
        for r in control_readings(args.workload, seed, "cuda", kinds=args.kinds):
            emit(r)


if __name__ == "__main__":
    main()
