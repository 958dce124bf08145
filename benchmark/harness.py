"""The benchmark's driver, ruled by data: ``BENCHMARK.json`` names the cells, and each
name leads to files of its own, found by that name alone:

- ``configs/<config>.json``: the configuration as it is run (and ``reference/<config>.py``,
  its plain reference);
- ``mixes/<traffic>.json``: the traffic's parameters; its ``driver`` names the window
  driver ``drivers/<driver>.py``, which the one input generator (``inputs.py``) feeds;
- ``limits/<workload>.json``: the limit of each number that decides ``correct``;
- ``metrics/<metric>.py``: one reader for each metric, ``read(rec) -> float | None``
  over the run's records (None: nothing to read in this cell, and the metric is left
  out of the line).

A later change adds a configuration, a mix, a cell or a metric as new files.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import torch

from . import compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "simt_tpu")  # whole top-level names


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        both = isinstance(v, dict) and isinstance(out.get(k), dict)
        out[k] = merge(out[k], v) if both else v
    return out


class Run:
    """One run of one cell: its entry in ``BENCHMARK.json``, configuration, mix,
    limits, seed and device. ``overrides`` ({"config": ..., "mix": ...}) shrink a cell
    for the benchmark's own CPU tests."""

    def __init__(self, workload: str, seed: int, device, overrides: Optional[dict] = None):
        self.spec = spec()
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"({', '.join(cells)})")
        self.workload = cells[workload]
        entry = {c["name"]: c for c in self.spec["configs"]}[self.workload["config"]]
        overrides = overrides or {}
        self.config = merge(load_json(os.path.join(ROOT, entry["file"])),
                             overrides.get("config"))
        self.mix = merge(load_json(os.path.join(HERE, "mixes",
                                                 self.workload["traffic"] + ".json")),
                          overrides.get("mix"))
        self.limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
        self.seed = int(seed)
        self.device = torch.device(device)


def reference_module(config: str):
    return importlib.import_module(f"benchmark.reference.{config}")


def driver(run: Run):
    return importlib.import_module(f"benchmark.drivers.{run.mix['driver']}")


def reader(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(run: Run, traced: bool) -> list:
    """The metrics this cell reports: its end-to-end ones (``--trace 0``) or its
    per-layer ones (``--trace 1``), each listed for the cell or for every cell."""
    entries = run.spec["per_layer" if traced else "end_to_end"]
    name = run.workload["name"]
    return [m for m in entries if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the JAX
    package's, compared whole (the port's own name begins with the JAX package's)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(run: Run, seconds: float, traced: bool, t_start: float) -> dict:
    """Set-up, the window, the traced readings (``traced``), the check; returns the
    result line (without the JSON encoding) and the records it came from."""
    t_cell = time.perf_counter()
    cell = driver(run).Cell(run)
    setup_s = time.perf_counter() - t_start
    rec = {"workload": run.workload["name"], "config": run.config, "mix": run.mix,
           "setup_s": setup_s,
           "setup_parts": {"imports": t_cell - t_start, **cell.setup_parts},
           "window": cell.window(seconds)}
    if traced:
        rec["spans"] = cell.spans()
        rec["session"] = cell.session()
        rec["host_session"] = cell.session(host=True)
    cell.release()
    numbers = cell.check()
    rec["numbers"] = numbers
    correct, checks = compare.judge(numbers, run.limits)
    win = rec["window"]
    attempted = win.get("steps", win.get("calls"))
    metrics = {}
    for m in cell_metrics(run, traced):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(run.workload["chips"]), "memory_peak_bytes": win["peak_bytes"]}
    result = {"correct": bool(correct and win["failed"] == 0), "attempted": attempted,
              "failed": win["failed"], "metrics": metrics, "device": device}
    if traced:
        from . import trace

        s = rec["session"]
        device["busy_s"] = trace.busy_us(s) / 1e6
        device["window_s"] = s["window_us"] / 1e6
        result["breakdown"] = trace.breakdown(s, rec["host_session"])
    result["checks"] = checks
    return {"result": result, "rec": rec}
