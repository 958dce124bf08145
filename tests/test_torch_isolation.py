"""The port stands alone: it imports neither JAX nor the JAX package, and its entry
points run on the card unless the caller asks for the CPU."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import simt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(simt_tpu_torch.__path__, "simt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "simt_tpu"))
print(len(names), bad)
"""


def _run(args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax_and_nothing_of_simt_tpu():
    res = _run(["-c", _IMPORT_ALL])
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 15  # every module of the package was imported
    assert bad == "[]", bad


def test_chip_smoke_imports_no_jax_and_nothing_of_simt_tpu():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "simt_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "simt_tpu"}, roots


def _needs_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")


def test_chip_smoke_fails_without_a_card(tmp_path):
    _needs_a_host_without_a_card()
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # Alone in a directory, without the package, it fails too.
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _needs_a_host_without_a_card()
    from simt_tpu_torch.data.synthetic import make_cityscapes_fixture
    from simt_tpu_torch.eval import evaluate
    from simt_tpu_torch.models import ResNetMulti
    from simt_tpu_torch.tools.test import main

    paths = make_cityscapes_fixture(str(tmp_path), n_train=0, n_val=1)
    model = ResNetMulti(19, layers=(1, 1, 1, 1), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate(model, data_root=paths["root"], val_list=paths["val_txt"],
                 gt_dir=paths["gt_dir"], scales=((32, 16), (40, 20)), out_hw=(32, 64))
    assert next(model.parameters()).device.type == "cpu"  # nothing ran
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--synthetic"])


def test_kernel_needs_a_card_and_never_falls_back():
    from simt_tpu_torch.ops.kernels import _build, eval_fused

    _needs_a_host_without_a_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("eval_fused")
    # Neither CPU nor CUDA: the wrapper raises instead of computing on the host.
    la = torch.zeros((1, 3, 5, 19), device="meta")
    lb = torch.zeros((1, 1, 1, 19), device="meta")
    gt = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        eval_fused.multiscale_argmax_hist(la, lb, gt, out_hw=(8, 8))
