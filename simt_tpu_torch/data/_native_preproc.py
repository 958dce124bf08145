"""ctypes bindings for the native preprocessing library (``data/_native/preproc.cpp``),
the counterpart of ``simt_tpu/data/_native_preproc.py``.

Pillow-exact: the bicubic resize is bit-identical to PIL's u8 resample path, and the
nearest resize samples PIL's floor((i + 0.5) * scale). The input pipeline uses it when
``DataConfig.use_native_preproc`` is set; PIL stays the plain version.

Nothing is built when this module is imported. ``load`` compiles the source with
``g++`` at first use into ``<repo>/build/native/`` (listed in ``.gitignore``), named by
a hash of the source, the compiler, its flags and the host CPU's feature flags (the
library is built with ``-march=native``, so a library built on another CPU is never
loaded). The write is atomic (a temporary file and ``os.replace``), so processes that
build at once all load a whole library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

SOURCE = os.path.join(os.path.dirname(__file__), "_native", "preproc.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native",
)
# The JAX package's Makefile flags (simt_tpu/data/_native/Makefile).
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")  # the Makefile's ``CXX ?= g++``


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path() -> str:
    """Where the library is built for this source, compiler, flags and CPU."""
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join((_compiler(), *CXX_FLAGS, _cpu_flags())).encode())
    return os.path.join(BUILD_DIR, f"libsimt_preproc-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library if it is not built yet; its path. Raises RuntimeError with
    the compiler's output if the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native preprocessing build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native preprocessing build failed ({' '.join(cmd)} exited "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.simt_resize_bicubic_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.simt_resize_bicubic_u8.restype = i
        lib.simt_resize_nearest_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.simt_resize_nearest_u8.restype = i
        lib.simt_bgr_meansub_f32.argtypes = [u8p, i, i, f32p, f32p, i]
        lib.simt_bgr_meansub_f32.restype = i
        lib.simt_preprocess_image.argtypes = [u8p, i, i, f32p, i, i, f32p, i]
        lib.simt_preprocess_image.restype = i
        _lib = lib
        return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _resize(fn_name: str, src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = load()
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    if src.ndim != 3:
        raise ValueError(f"expected an HW or HWC image, got shape {src.shape}")
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((dh, dw, ch), np.uint8)
    rc = getattr(lib, fn_name)(_u8(src), sh, sw, ch, _u8(dst), dh, dw)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {rc}")
    return dst[:, :, 0] if squeeze else dst


def resize_bicubic(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """u8 HWC (or HW) bicubic resize, Pillow-exact."""
    return _resize("simt_resize_bicubic_u8", src, dh, dw)


def resize_nearest(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """u8 HWC (or HW) nearest resize, Pillow-exact."""
    return _resize("simt_resize_nearest_u8", src, dh, dw)


def preprocess_image(
    src_rgb: np.ndarray, dh: int, dw: int, mean_bgr: Sequence[float], mirror: bool = False
) -> np.ndarray:
    """Fused u8 RGB HWC -> bicubic resize -> BGR, mean-sub, mirror -> f32 HWC."""
    lib = load()
    src_rgb = np.ascontiguousarray(src_rgb, np.uint8)
    if src_rgb.ndim != 3 or src_rgb.shape[2] != 3:
        raise ValueError(f"expected RGB HWC, got {src_rgb.shape}")
    sh, sw, _ = src_rgb.shape
    dst = np.empty((dh, dw, 3), np.float32)
    mean = np.asarray(mean_bgr, np.float32)
    rc = lib.simt_preprocess_image(_u8(src_rgb), sh, sw, _f32(dst), dh, dw, _f32(mean),
                                   int(mirror))
    if rc != 0:
        raise RuntimeError(f"simt_preprocess_image failed: {rc}")
    return dst
