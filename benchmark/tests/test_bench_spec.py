"""BENCHMARK.json against the contract's form, and the harness finding every
configuration, mix, driver, reference, limit and metric reader by its name alone."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_limits_of_the_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    # A full check with 24 cells fits its 43200 s.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for w in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    run = harness.Run(cell, 1, "cpu")
    assert run.workload["chips"] == 1
    drv = harness.driver(run)
    assert hasattr(drv, "Cell")
    ref = harness.reference_module(run.workload["config"])
    assert hasattr(ref, "eval_logits" if run.mix["driver"] == "eval" else "train")
    assert run.limits and all(v > 0 for v in run.limits.values())
    e2e = harness.cell_metrics(run, traced=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per_layer = harness.cell_metrics(run, traced=True)
    assert per_layer
    # Each per-layer metric moves an end-to-end metric this cell reports.
    assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}


@pytest.mark.parametrize("metric",
                         [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_each_metric_has_its_reader(metric):
    assert callable(harness.reader(metric).read)


def test_each_config_file_is_under_paths_and_its_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        importlib.import_module(f"benchmark.reference.{c['name']}")
