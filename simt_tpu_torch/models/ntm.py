"""Simplex noise transition matrices (counterpart of ``simt_tpu/models/ntm.py``).

``sig_NTM`` / ``sig_W`` of the reference (model/deeplab_multi.py:244-286) as plain
functions of a parameter tensor: the train state holds the parameters and their Adam
states. The reference writes -10000 into ``sig_W``'s parameter diagonal under
``no_grad`` on every forward (deeplab_multi.py:279-281); here the diagonal of the
*logits* is masked instead, so the diagonal gets zero gradient and the observable W and
every off-diagonal gradient are the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ASSETS_DIR

_CLASS_DIST_DIR = os.path.join(ASSETS_DIR, "class_dist")


def load_class_dist(name_or_path: str = "bapa") -> np.ndarray:
    """The 19-vector class-frequency prior (reference ClassDist/*.npy, read at
    model/deeplab_multi.py:255): a short name ('bapa', 'sfdaseg', ...) or a path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CLASS_DIST_DIR, f"ClassDist_{name_or_path}.npy")
    return np.load(path).astype(np.float32)


def ntm_init(generator: torch.Generator, num_classes: int,
             open_classes: int = 0) -> torch.Tensor:
    """sig_NTM parameter init: kaiming-normal fan_out/relu on a (C+O, C) matrix
    (deeplab_multi.py:248-252); for a 2-D tensor fan_out is dim 0 (= C+O). Drawn on
    the CPU from ``generator``."""
    total = num_classes + open_classes
    std = float(np.sqrt(2.0 / total))
    return std * torch.randn((total, num_classes), generator=generator,
                             dtype=torch.float32)


def ntm_forward(param: torch.Tensor, class_dist: torch.Tensor, num_classes: int,
                open_classes: int = 0) -> torch.Tensor:
    """T = L1-normalise_rows(sigmoid(param) * tile(class_dist) + [I_C; 0])
    (deeplab_multi.py:259-263). Every term is non-negative, so the L1 norm is the row
    sum; F.normalize divides by max(norm, 1e-12)."""
    prior = torch.zeros((num_classes + open_classes, num_classes), dtype=torch.float32,
                        device=param.device)
    prior[:num_classes].fill_diagonal_(1.0)
    t = torch.sigmoid(param.float()) * class_dist.float() + prior
    return t / torch.clamp(t.sum(dim=1, keepdim=True), min=1e-12)


def ntm_invert(t: np.ndarray, class_dist: np.ndarray, num_classes: int) -> np.ndarray:
    """The exact inverse of :func:`ntm_forward`, on numpy: the sigmoid parameters P with
    ``normalize(sigmoid(P) * class_dist + [I; 0]) == t``. It plants a known transition
    matrix inside the representable family (``tools/planted_noise.py``), so that
    recovering it is an identification problem, not an approximation problem.

    Row k's free scale Z_k (its sum before normalisation) must put every
    s_j = sigmoid(p_kj) in (0, 1): a known row needs Z in (1/t_kk, (1 + cd_k)/t_kk)
    and below every off-diagonal cap cd_j/t_kj; an open row needs Z < min_j cd_j/t_kj.
    Each row takes the middle of its range; a leak above its structural cap cd_j
    leaves the range empty and raises ValueError."""
    c = num_classes
    cd = np.asarray(class_dist, np.float64)
    total = t.shape[0]
    p = np.zeros((total, c), np.float64)
    for k in range(total):
        if k < c:
            lo = 1.0 / t[k, k]
            hi = (1.0 + cd[k]) / t[k, k]
            for j in range(c):
                if j != k and t[k, j] > 0:
                    hi = min(hi, cd[j] / t[k, j])
        else:
            lo, hi = 0.0, min(cd[j] / t[k, j] for j in range(c) if t[k, j] > 0)
        if not lo < hi:
            raise ValueError(f"row {k}: leak above structural cap (lo={lo}, hi={hi})")
        z = 0.5 * (lo + hi)
        s = t[k] * z / cd
        if k < c:
            s[k] = (t[k, k] * z - 1.0) / cd[k]
        s = np.clip(s, 1e-7, 1 - 1e-7)
        p[k] = np.log(s) - np.log1p(-s)
    return p.astype(np.float32)


def w_init(num_classes: int, open_classes: int = 0) -> torch.Tensor:
    """sig_W parameter init: the constant 1/(classes - 1) (deeplab_multi.py:269-272)."""
    total = num_classes + open_classes
    return torch.full((total, total), 1.0 / (total - 1.0), dtype=torch.float32)


def w_forward(param: torch.Tensor) -> torch.Tensor:
    """W = -I + row_softmax(param with its diagonal masked to -10000)
    (deeplab_multi.py:278-286), the diagonal masked functionally."""
    total = param.shape[0]
    eye = torch.eye(total, dtype=torch.bool, device=param.device)
    logits = torch.where(eye, torch.full_like(param, -10000.0, dtype=torch.float32),
                         param.float())
    return torch.softmax(logits, dim=1) - eye.float()
