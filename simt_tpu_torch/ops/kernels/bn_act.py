"""Eval-mode BatchNorm, its ReLU and the residual add in one pass: CUDA kernel wrapper
and its plain PyTorch version.

``bn_act(x, mean, var, weight, bias, eps, residual=None, relu=True)`` computes
``act(x * scale + shift [+ residual])`` with ``scale = weight / sqrt(var + eps)`` and
``shift = bias - mean * scale`` per channel (dim 1), ``act`` ReLU or the identity:
a BatchNorm that normalises with its running statistics, then the bottleneck's add and
ReLU. The three variants the trunk uses are BN -> ReLU, BN -> + residual -> ReLU and BN
alone (``relu=False``, no residual).

On the CPU it runs ``bn_act_plain``; on a CUDA device it launches the kernel
(``csrc/bn_act.cu``) and adds one to ``bn_act.launches``, or raises. It never falls
back. The kernel takes channels_last bfloat16 activations with a channel count that is
a multiple of 8, float32 statistics and affine parameters, and computes in float32 with
one rounding of the output. It replaces no TPU kernel: on the TPU, XLA fused this work
into one pass, and the port's eval-mode trunk ran it as three ATen passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .fma import fma32

VEC = 8  # bf16 channels a thread loads at once (16 bytes)


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float,
                 residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, operation for operation: in float32,
    ``scale = weight * (1 / sqrt(var + eps))``, ``shift = fma(-mean, scale, bias)``,
    ``fma(x, scale, shift)``, the residual's add and the ReLU, then one rounding to
    ``x``'s dtype. On the same inputs the kernel's output equals it bit for bit."""
    f32 = torch.float32
    scale = 1.0 / torch.sqrt(var.to(f32) + eps)
    if weight is not None:
        scale = weight.to(f32) * scale
    shift = fma32(-mean.to(f32), scale, bias.to(f32) if bias is not None
                  else torch.zeros_like(scale))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = fma32(x.to(f32), scale.view(shape), shift.view(shape))
    if residual is not None:
        y = y + residual.to(f32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float,
           residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """``act(x * scale + shift [+ residual])``; a new tensor of ``x``'s shape, dtype and
    memory format. ``residual`` only with ``relu`` (the trunk has no add without its
    ReLU)."""
    if residual is not None and not relu:
        raise ValueError("the residual add comes with its ReLU (relu=True)")
    dev = x.device
    if dev.type == "cpu":
        return bn_act_plain(x, mean, var, weight, bias, eps, residual, relu)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    _check(x, mean, var, weight, bias, residual)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    lib = _lib()
    err = lib.simt_bn_act(
        x.data_ptr(), _ptr(residual), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
        _ptr(weight), _ptr(bias), float(eps), x.numel(), x.shape[1], int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.simt_cuda_error_string(err).decode()
        raise RuntimeError(f"bn_act kernel launch failed: {msg} ({err})")
    bn_act.launches += int(x.numel() > 0)  # no launch for no elements
    return y


bn_act.launches = 0


def work(elements: int, residual: bool) -> int:
    """Bytes one call moves in device memory: ``x`` read and the output written, bf16,
    and the residual read when there is one (the statistics, a few KB, left out)."""
    return elements * 2 * (3 if residual else 2)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_act")
    p = ctypes.c_void_p
    lib.simt_bn_act.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, p]
    lib.simt_bn_act.restype = ctypes.c_int
    lib.simt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, mean, var, weight, bias, residual) -> None:
    """Raises unless the kernel takes these arguments: ``x`` (and the residual, of its
    shape, if any) a 4-d channels_last bfloat16 tensor on a card, 16-byte aligned, with
    a multiple of 8 channels; the statistics and affine parameters contiguous float32
    (C,) tensors on the same card."""
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not (
                t.is_cuda and t.dtype == torch.bfloat16 and t.dim() == 4
                and t.shape == x.shape and t.device == x.device and t.shape[1] % VEC == 0
                and t.is_contiguous(memory_format=torch.channels_last)
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"the CUDA kernel takes a 4-d channels_last bfloat16 x on a card, 16-byte "
                f"aligned, with a multiple of {VEC} channels, and a residual like it; got "
                f"{name} {tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}")
    c = x.shape[1]
    for name, t in (("mean", mean), ("var", var), ("weight", weight), ("bias", bias)):
        if t is None and name in ("weight", "bias"):
            continue
        if (t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
