"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``simt_tpu_torch/csrc/`` has a plain C interface and is compiled
for ``sm_90a`` into a shared library under ``<repo>/build/kernels/`` (listed in
``.gitignore``), named by a hash of the source, the headers under ``csrc/`` and the
flags, so that an edited source or header is rebuilt. Nothing is built when a module is
imported: ``build`` runs at first use, or ahead of time from ``chip_smoke.py``, and
compiles every requested source with one ``nvcc`` each, all started together.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__)))),
    "build", "kernels",
)
SOURCES: Dict[str, str] = {"eval_fused": "eval_fused.cu", "loss_fused": "loss_fused.cu",
                           "conv3x3": "conv3x3.cu", "bottleneck": "bottleneck.cu",
                           "bn_act": "bn_act.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nvcc compiles ``build`` has started in this process (a library already built starts
# none): ``tools/soak.py`` holds it still after its warm-up.
compiles = 0


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (on PATH or at /usr/local/cuda/bin/nvcc)")
    return path


def library_path(name: str) -> str:
    """Where ``name`` is built: named by a hash of its source, every header under
    ``csrc/`` (``*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named sources (all by default) that are not built yet, in parallel.

    Raises RuntimeError with nvcc's output if any compile fails.
    """
    global compiles
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = Built(name, path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        compiles += 1
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name]} exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
        out[name] = Built(name, path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed). Needs a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device; none is available")
    return ctypes.CDLL(build([name])[name].path)
