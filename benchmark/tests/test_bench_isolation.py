"""Nothing the benchmark runs imports JAX or the JAX package, and the reference imports
nothing of the port, compared by whole top-level names (the port's name begins with
the JAX package's)."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "simt_tpu"}

_WALK = """
import importlib, pkgutil, sys, os
sys.path.insert(0, {root!r})
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.")
         if ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
from benchmark import harness
for f in os.listdir(os.path.join(harness.HERE, "metrics")):
    harness.reader(f[:-3])
{extra}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(len(names), " ".join(tops))
"""


def _tops(extra=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _WALK.format(root=harness.ROOT, extra=extra)
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, tops = res.stdout.strip().splitlines()[-1].split(" ", 1)
    return int(n), set(tops.split())


def test_the_benchmark_and_a_tiny_run_load_no_jax():
    run = ("import time, torch\n"
           "from benchmark.tests.conftest import TINY\n"
           "r = harness.Run('simt_eval_b8', 3, 'cpu', overrides=TINY)\n"
           "harness.run_cell(r, 0.1, False, time.perf_counter())\n")
    n, tops = _tops(run)
    assert n >= 15
    assert "simt_tpu_torch" in tops  # the system under test was driven
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add("." if node.level else (node.module or "").split(".")[0])
    return roots


def test_no_source_of_the_benchmark_names_jax_and_the_reference_not_the_port():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                roots = _imports(os.path.join(dirpath, f))
                assert not roots & FORBIDDEN, (f, roots)
                if os.path.basename(dirpath) == "reference":
                    allowed = {".", "__future__", "contextlib", "typing", "torch"}
                    assert roots <= allowed, (f, roots)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, pkgutil, importlib; import benchmark.reference as r\n"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages(r.__path__,"
            " 'benchmark.reference.')]\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "simt_tpu_torch" not in res.stdout and "'jax'" not in res.stdout
