"""The fused train-mode bottleneck: CUDA kernel wrappers (B6 forward, B7 backward) and
their plain PyTorch versions.

Counterpart of ``experiments/pallas_bottleneck/bottleneck.py`` (``_fwd_call`` /
``_bwd_call``): a whole identity bottleneck with batch-statistic BatchNorm on one image,

    out = relu(bn3(conv3(relu(bn2(conv2_d(relu(bn1(conv1(x)))))))) + x),

  - ``bottleneck_fwd`` (B6) -> out, h1raw, h2raw (the raw conv1/conv2 outputs, bf16),
    stats_p (4, P) = m1 v1 m2 v2 and stats_t (2, Ct) = m3 v3, float32;
  - ``bottleneck_bwd`` (B7) -> dx (bf16), dw1, dw2, dw3 (float32, OIHW), dgb_p (4, P) =
    dg1 db1 dg2 db2 and dgb_t (2, Ct) = dg3 db3, from the cotangent dy and B6's
    saved h1raw, h2raw and statistics.

Layouts are the port's: x (1, Ct, H, W) (``channels_last`` on a card, read as NHWC),
w1 (P, Ct, 1, 1), w2 (P, P, 3, 3), w3 (Ct, P, 1, 1) OIHW, BN vectors (P,) or (Ct,).
Numerics are the Pallas kernels': bf16 operands, float32 products and sums, each conv
output rounded to bf16 before its statistics, mean = sum/m and var = sum x^2/m - mean^2
(biased), a = g*rsqrt(var + 1e-5), c = b - mean*a, activations bf16(relu(a*raw + c)),
out = bf16(relu(a3*outraw + c3 + x)) rounded once.

Both wrappers dispatch on the tensors' device: on the CPU they run the plain versions
(``bottleneck_fwd_plain``, ``bottleneck_bwd_plain``); on a CUDA device they launch the
kernels of ``csrc/bottleneck.cu`` (and add one to their ``launches``, however many
launches the call issues) or raise. They never fall back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3 import _check_tensor, _raise_if, _stream, _vec, wgrad_splits

EPS = 1e-5
_BM = 128  # B6/B7's GEMM row tile: one partial per 128 pixels for each statistic

bf16 = torch.bfloat16


def _mat(t: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (H*W, C), the NHWC pixel-major matrix."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _img(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H*W, C) -> (1, C, H, W) in channels_last memory."""
    return m.reshape(1, h, w, -1).permute(0, 3, 1, 2)


def _shifts(m: torch.Tensor, h: int, w: int, d: int):
    """The nine tap-shifted copies (H*W, C) of ``m``, zero outside the image, in tap
    order kh*3 + kw (the SAME dilated 3x3 conv's operands)."""
    c = m.shape[1]
    mp = F.pad(m.reshape(h, w, c), (0, 0, d, d, d, d))
    return [mp[kh * d:kh * d + h, kw * d:kw * d + w].reshape(-1, c)
            for kh in range(3) for kw in range(3)]


def _stats(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    rf = raw.float()
    m = rf.shape[0]
    mean = rf.sum(0) / m
    return mean, (rf * rf).sum(0) / m - mean * mean


def _coef(mean, var, g, b):
    """(a, c, inv) of the batch-statistic BN: a*raw + c = (raw - mean)*inv*g + b."""
    inv = torch.rsqrt(var + EPS)
    a = g * inv
    return a, b - mean * a, inv


def _bn_relu(raw: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.relu(raw.float() * a + c).to(bf16)


def _weights(w1, w2, w3):
    """bf16-rounded float32 operands: w1m (Ct, P), w2t (3, 3, P_in, P_out), w3m (P, Ct)."""
    p, ct = w1.shape[0], w1.shape[1]
    w1m = w1.to(bf16).float().reshape(p, ct).T
    w2t = w2.to(bf16).float().permute(2, 3, 1, 0)
    w3m = w3.to(bf16).float().reshape(ct, p).T
    return w1m, w2t, w3m


def bottleneck_fwd_plain(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, d: int):
    """Plain version of B6 (``_fwd_kernel``, bottleneck.py:74-160, and
    ``reference_bottleneck``): returns (out, h1raw, h2raw, stats_p, stats_t)."""
    _, _, h, w = x.shape
    xm = _mat(x).to(bf16)
    w1m, w2t, w3m = _weights(w1, w2, w3)
    g1, b1, g2, b2, g3, b3 = (t.float() for t in (g1, b1, g2, b2, g3, b3))

    h1raw = (xm.float() @ w1m).to(bf16)
    m1, v1 = _stats(h1raw)
    a1, c1, _ = _coef(m1, v1, g1, b1)
    h1 = _bn_relu(h1raw, a1, c1)
    acc = None
    for t, hs in enumerate(_shifts(h1, h, w, d)):
        y = hs.float() @ w2t[t // 3, t % 3]
        acc = y if acc is None else acc + y
    h2raw = acc.to(bf16)
    m2, v2 = _stats(h2raw)
    a2, c2, _ = _coef(m2, v2, g2, b2)
    h2 = _bn_relu(h2raw, a2, c2)
    outraw = (h2.float() @ w3m).to(bf16)
    m3, v3 = _stats(outraw)
    a3, c3, _ = _coef(m3, v3, g3, b3)
    out = torch.relu(outraw.float() * a3 + c3 + xm.float()).to(bf16)
    return (_img(out, h, w), _img(h1raw, h, w), _img(h2raw, h, w),
            torch.stack([m1, v1, m2, v2]), torch.stack([m3, v3]))


def bottleneck_bwd_plain(dy, x, w1, w2, w3, g1, b1, g2, b2, g3, b3, h1raw, h2raw,
                         stats_p, stats_t, d: int,
                         need: Sequence[bool] = (True, True, True, True)):
    """Plain version of B7 (``_bwd_kernel``, bottleneck.py:195-332), written out by
    hand with the Pallas kernel's bf16 roundings: dz3 (:241), dor3 (:259), dz2 (:269),
    dor2 (:280), dz1 (:314), dor1 (:325), dx = bf16(dz3 + dor1 w1^T) (:331); outraw is
    recomputed from h2 (:234). ``need`` = (dx, dw1, dw2, dw3): a gradient not needed is
    not computed and comes back None. Returns (dx, dw1, dw2, dw3, dgb_p, dgb_t)."""
    _, ct, h, w = x.shape
    p = w1.shape[0]
    m = h * w
    w1m, w2t, w3m = _weights(w1, w2, w3)
    g1, b1, g2, b2, g3, b3 = (t.float() for t in (g1, b1, g2, b2, g3, b3))
    m1, v1, m2, v2 = stats_p.float()
    m3, v3 = stats_t.float()
    a1, c1, i1 = _coef(m1, v1, g1, b1)
    a2, c2, i2 = _coef(m2, v2, g2, b2)
    a3, c3, i3 = _coef(m3, v3, g3, b3)
    xf = _mat(x).to(bf16).float()
    dyf = _mat(dy).to(bf16).float()
    h1r = _mat(h1raw).float()
    h2r = _mat(h2raw).float()

    def dor(dz, xhat, s, q, a):
        return (a * (dz.to(bf16).float() - s / m - xhat * (q / m))).to(bf16)

    # Stage 3: dz3 = dy * [z3 > 0]; dg3 = sum dz3 * xhat3, db3 = sum dz3.
    h2 = _bn_relu(h2r, a2, c2)
    outraw = (h2.float() @ w3m).to(bf16).float()
    z3 = outraw * a3 + c3 + xf
    dz3 = torch.where(z3 > 0, dyf, torch.zeros_like(dyf))
    xhat3 = (outraw - m3) * i3
    s3, q3 = dz3.sum(0), (dz3 * xhat3).sum(0)
    dor3 = dor(dz3, xhat3, s3, q3, a3)
    dw3 = (h2.float().T @ dor3.float()).T.reshape(ct, p, 1, 1) if need[3] else None

    # Stage 2: dz2 = (dor3 w3) * [h2 > 0].
    dh2 = dor3.float() @ w3m.T
    dz2 = torch.where(h2.float() > 0, dh2, torch.zeros_like(dh2))
    xhat2 = (h2r - m2) * i2
    s2, q2 = dz2.sum(0), (dz2 * xhat2).sum(0)
    dor2 = dor(dz2, xhat2, s2, q2, a2)
    h1 = _bn_relu(h1r, a1, c1)
    dw2 = None
    if need[2]:
        taps = [hs.float().T @ dor2.float() for hs in _shifts(h1, h, w, d)]  # (C, O)
        dw2 = torch.stack(taps).reshape(3, 3, p, p).permute(3, 2, 0, 1).contiguous()

    # Stage 1: dz1 = conv_T(dor2) * [h1 > 0], the flipped io-transposed kernel.
    dh1 = None
    for t, ds in enumerate(_shifts(dor2, h, w, d)):
        y = ds.float() @ w2t[2 - t // 3, 2 - t % 3].T
        dh1 = y if dh1 is None else dh1 + y
    dz1 = torch.where(h1.float() > 0, dh1, torch.zeros_like(dh1))
    xhat1 = (h1r - m1) * i1
    s1, q1 = dz1.sum(0), (dz1 * xhat1).sum(0)
    dor1 = dor(dz1, xhat1, s1, q1, a1)
    dw1 = (xf.T @ dor1.float()).T.reshape(p, ct, 1, 1) if need[1] else None
    dx = None
    if need[0]:
        dx = _img((dz3.to(bf16).float() + dor1.float() @ w1m.T).to(bf16), h, w)
    return (dx, dw1, dw2, dw3, torch.stack([q1, s1, q2, s2]), torch.stack([q3, s3]))


def _dims(x, w1, w2, w3, vecs, d) -> Tuple[int, int]:
    """(P, Ct) after checking shapes, dtypes and devices; raises ValueError/TypeError."""
    _check_tensor(x, d, "x")
    if x.shape[0] != 1:
        raise ValueError(f"the fused bottleneck takes one image (batch 1), got batch "
                         f"{x.shape[0]}")
    ct, p = x.shape[1], w1.shape[0]
    want = {"w1": (w1, (p, ct, 1, 1)), "w2": (w2, (p, p, 3, 3)), "w3": (w3, (ct, p, 1, 1))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for x {tuple(x.shape)}, got "
                             f"{tuple(t.shape)}")
    for i, v in enumerate(vecs):
        n = p if i < 4 else ct
        if tuple(v.shape) != (n,):
            raise ValueError(f"BN vector {i} must be ({n},), got {tuple(v.shape)}")
    for t in (w1, w2, w3, *vecs):
        if t.device != x.device:
            raise TypeError(f"every operand must be on {x.device}, one is on {t.device}")
    if x.device.type == "cuda":
        if x.dtype != bf16:
            raise TypeError(f"the CUDA kernel takes bfloat16 x, got {x.dtype}")
        if w1.dtype not in (torch.float32, bf16) or not w1.dtype == w2.dtype == w3.dtype:
            raise TypeError("the weights must share one dtype, float32 or bfloat16")
        if any(v.dtype != torch.float32 for v in vecs):
            raise TypeError("the BN vectors must be float32")
    return p, ct


def _weight_args(w1, w2, w3):
    ws = [w.contiguous() for w in (w1, w2, w3)]
    return ws, int(w1.dtype == bf16)


def bottleneck_fwd(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, d: int):
    """B6: (out, h1raw, h2raw, stats_p, stats_t); see the module docstring."""
    vecs = (g1, b1, g2, b2, g3, b3)
    p, ct = _dims(x, w1, w2, w3, vecs, d)
    if x.device.type == "cpu":
        return bottleneck_fwd_plain(x, w1, w2, w3, *vecs, d)
    _, _, h, w = x.shape
    m = h * w
    dev = x.device
    img = dict(dtype=bf16, device=dev, memory_format=torch.channels_last)
    out = torch.empty((1, ct, h, w), **img)
    h1raw = torch.empty((1, p, h, w), **img)
    h2raw = torch.empty((1, p, h, w), **img)
    f32 = dict(dtype=torch.float32, device=dev)
    stats_p = torch.empty((4, p), **f32)
    stats_t = torch.empty((2, ct), **f32)
    wpack = torch.empty(2 * ct * p + 9 * p * p, dtype=bf16, device=dev)
    part = torch.empty(math.ceil(m / _BM) * 2 * max(p, ct), **f32)
    coef = torch.empty(4 * (2 * p + ct), **f32)
    (cw1, cw2, cw3), wbf = _weight_args(w1, w2, w3)
    vec = _vec(bf16, (ct, p), (x, out, h1raw, h2raw, wpack))
    lib = _lib()
    err = lib.simt_bneck_fwd(
        x.data_ptr(), cw1.data_ptr(), cw2.data_ptr(), cw3.data_ptr(), wbf,
        *(v.data_ptr() for v in vecs), out.data_ptr(), h1raw.data_ptr(), h2raw.data_ptr(),
        stats_p.data_ptr(), stats_t.data_ptr(), wpack.data_ptr(), part.data_ptr(),
        coef.data_ptr(), h, w, ct, p, d, vec, _stream(x))
    _raise_if(err, "bottleneck_fwd", lib)
    bottleneck_fwd.launches += 1
    return out, h1raw, h2raw, stats_p, stats_t


bottleneck_fwd.launches = 0


def bottleneck_bwd(dy, x, w1, w2, w3, g1, b1, g2, b2, g3, b3, h1raw, h2raw, stats_p,
                   stats_t, d: int, need: Sequence[bool] = (True, True, True, True)):
    """B7: (dx, dw1, dw2, dw3, dgb_p, dgb_t); ``need`` = (dx, dw1, dw2, dw3), a
    gradient not needed is not computed and comes back None."""
    vecs = (g1, b1, g2, b2, g3, b3)
    p, ct = _dims(x, w1, w2, w3, vecs, d)
    _, _, h, w = x.shape
    for name, t, c in (("dy", dy, ct), ("h1raw", h1raw, p), ("h2raw", h2raw, p)):
        if tuple(t.shape) != (1, c, h, w):
            raise ValueError(f"{name} must be {(1, c, h, w)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise TypeError(f"{name} is on {t.device}, x on {x.device}")
    if tuple(stats_p.shape) != (4, p) or tuple(stats_t.shape) != (2, ct):
        raise ValueError(f"stats must be (4, {p}) and (2, {ct}), got "
                         f"{tuple(stats_p.shape)} and {tuple(stats_t.shape)}")
    for t in (stats_p, stats_t):
        if t.device != x.device or (x.device.type == "cuda" and (
                t.dtype != torch.float32 or not t.is_contiguous())):
            raise TypeError("stats must be contiguous float32 on x's device")
    if x.device.type == "cpu":
        return bottleneck_bwd_plain(dy, x, w1, w2, w3, *vecs, h1raw, h2raw, stats_p,
                                    stats_t, d, need)
    for name, t in (("dy", dy), ("h1raw", h1raw), ("h2raw", h2raw)):
        if t.dtype != bf16 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"the CUDA kernel takes channels_last bfloat16 {name}")
    m = h * w
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((1, ct, h, w), dtype=bf16, device=dev,
                     memory_format=torch.channels_last)
    big = torch.empty(m * ct, dtype=bf16, device=dev)
    s2 = torch.empty(m * p, dtype=bf16, device=dev)
    s1 = torch.empty(m * p, dtype=bf16, device=dev)
    wpack = torch.empty(3 * ct * p + 9 * p * p, dtype=bf16, device=dev)
    part = torch.empty(math.ceil(m / _BM) * 2 * max(p, ct), **f32)
    coef = torch.empty(6 * (2 * p + ct), **f32)
    dgb_p = torch.empty((4, p), **f32)
    dgb_t = torch.empty((2, ct), **f32)
    # (C, O, taps) of each weight gradient's pixel contraction, and its split of pixels.
    shapes = {1: (ct, p, 1), 2: (p, p, 9), 3: (p, ct, 1)}
    splits = {k: wgrad_splits(m, c, o, taps) for k, (c, o, taps) in shapes.items()}
    dws = {k: (torch.empty(w_.shape, **f32) if need[k] else None)
           for k, w_ in ((1, w1), (2, w2), (3, w3))}
    wpart_n = max([splits[k][0] * shapes[k][0] * shapes[k][1] * shapes[k][2]
                   for k in dws if dws[k] is not None], default=1)
    wpart = torch.empty(wpart_n, **f32)
    (cw1, cw2, cw3), wbf = _weight_args(w1, w2, w3)
    vec = _vec(bf16, (ct, p), (x, dy, h1raw, h2raw, dx, big, s2, s1, wpack))

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.simt_bneck_bwd(
        x.data_ptr(), dy.data_ptr(), cw1.data_ptr(), cw2.data_ptr(), cw3.data_ptr(), wbf,
        *(v.data_ptr() for v in vecs), h1raw.data_ptr(), h2raw.data_ptr(),
        stats_p.data_ptr(), stats_t.data_ptr(), dx.data_ptr(), ptr(dws[1]), ptr(dws[2]),
        ptr(dws[3]), dgb_p.data_ptr(), dgb_t.data_ptr(), wpack.data_ptr(), big.data_ptr(),
        s2.data_ptr(), s1.data_ptr(), part.data_ptr(), wpart.data_ptr(), coef.data_ptr(),
        h, w, ct, p, d, *splits[1], *splits[2], *splits[3], int(bool(need[0])), vec,
        _stream(x))
    _raise_if(err, "bottleneck_bwd", lib)
    bottleneck_bwd.launches += 1
    return (dx if need[0] else None, dws[1], dws[2], dws[3], dgb_p, dgb_t)


bottleneck_bwd.launches = 0


def work(h: int, w: int, ct: int, p: int, op: str) -> Tuple[int, int]:
    """(bytes, operations) one call needs, each input read once and each output written
    once, bf16 activations and weights, float32 vectors and weight gradients.

    "fwd" reads x and the weights, writes out, h1raw, h2raw and the statistics;
    operations 2*H*W*(2*Ct*P + 9*P^2), the three convolutions' multiply-adds. "bwd"
    reads x, dy, the weights, h1raw, h2raw and the statistics, writes dx, dw1-3 and
    the six dg/db vectors; operations 2*H*W*(5*Ct*P + 18*P^2): outraw recomputed (its
    inputs do not hold it), dh2, dw3, dh1, dw2, dw1 and dx. The BatchNorm and ReLU
    arithmetic (a few operations an element) is not counted."""
    m = h * w
    wts = 2 * ct * p + 9 * p * p
    pair = (2 * p + ct) * 2 * 4  # one pair of float32 vectors a BN: g, b / m, v / dg, db
    if op == "fwd":
        return (2 * m * ct * 2 + 2 * m * p * 2 + wts * 2 + 2 * pair,
                2 * m * (2 * ct * p + 9 * p * p))
    if op == "bwd":
        return (3 * m * ct * 2 + 2 * m * p * 2 + wts * (2 + 4) + 3 * pair,
                2 * m * (5 * ct * p + 18 * p * p))
    raise ValueError(f"unknown op {op!r} (fwd or bwd)")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bottleneck")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.simt_bneck_fwd.argtypes = [p] * 4 + [i] + [p] * 14 + [i] * 6 + [p]
    lib.simt_bneck_fwd.restype = i
    lib.simt_bneck_bwd.argtypes = [p] * 5 + [i] + [p] * 23 + [i] * 13 + [p]
    lib.simt_bneck_bwd.restype = i
    lib.simt_cuda_error_string.argtypes = [i]
    lib.simt_cuda_error_string.restype = ctypes.c_char_p
    return lib
