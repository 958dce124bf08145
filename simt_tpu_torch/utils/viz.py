"""Visualisation: NTM heat-maps (counterpart of ``simt_tpu/utils/viz.py``; reference
plot_NTM, tools/trainV2_simt.py:187-200)."""

from __future__ import annotations

import os

import numpy as np


def plot_ntm(trans_mat, path: str, title: str = "NTM", annotate: bool = True) -> str:
    """Save a heat-map of a transition matrix (a numpy array or a tensor) with its
    per-cell values to ``path`` (trainV2_simt.py:187-200, with the broken ``np.float``
    call fixed and an explicit output path instead of the hard-coded ``../NTM_vis/``).
    Needs matplotlib, imported here: without it this raises ``ImportError``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(trans_mat, "detach"):
        trans_mat = trans_mat.detach().cpu().numpy()
    trans_mat = np.asarray(trans_mat)
    fig, ax = plt.subplots()
    im = ax.imshow(trans_mat, interpolation="nearest", cmap=plt.cm.Blues)
    fig.colorbar(im)
    ax.set_title(title)
    if annotate:
        thresh = trans_mat.max() / 2.0
        for i in range(trans_mat.shape[0]):
            for j in range(trans_mat.shape[1]):
                v = trans_mat[i, j]
                ax.text(j, i, f"{v:.2f}", fontsize=2, va="center", ha="center",
                        color="white" if v > thresh else "black")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, transparent=True, dpi=600)
    plt.close(fig)
    return path
