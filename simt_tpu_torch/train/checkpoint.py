"""Full-state snapshots with resume, and the warm start (counterpart of
``simt_tpu/train/checkpoint.py``).

The reference saves bare ``state_dict`` files and can never resume. Here a snapshot is
the whole train state, so a run continues where it stopped:

  - a SimT state: the student's and the teacher's ``state_dict``, the student's SGD
    ``state_dict`` (momentum buffers), the four NTM/W parameters with their Adam
    ``state_dict``s, and ``step``;
  - a warmup state: its model, its SGD and ``step``.

``save`` writes ``<dir>/step_{step:08d}/state.pt`` with ``torch.save`` and blocks until
the file is written; it writes into a hidden directory first and renames it, so a
snapshot cut short never counts as the latest. (The JAX package's orbax save is
asynchronous; ``wait_until_finished`` is kept for the same call sites.)
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.from_jax import load_matching, load_pth
from .state import SimTState

FILE = "state.pt"
_NTM = ("t1", "t2", "w1", "w2")


def snapshot_path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"step_{step:08d}"))


def _payload(state) -> dict:
    out = {"kind": "simt" if isinstance(state, SimTState) else "warmup",
           "step": int(state.step),
           "model": state.model.state_dict(),
           "model_opt": state.model_opt.state_dict()}
    if isinstance(state, SimTState):
        out["teacher"] = state.teacher.state_dict()
        for k in _NTM:
            ntm = getattr(state, k)
            out[k] = {"param": ntm.param.detach(), "opt": ntm.opt.state_dict()}
    return out


def save(state, directory: str, step: int) -> str:
    """Write a full-state snapshot of ``state`` (a ``SimTState`` or ``WarmupState``) as
    ``step_{step:08d}``, replacing one of that name; returns its path. Tensors on the
    card are copied to the host here, so the call waits for the card."""
    path = snapshot_path(directory, step)
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_payload(state), os.path.join(tmp, FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def wait_until_finished() -> None:
    """Saves block, so nothing is ever in flight (the JAX package's async orbax save
    needs this call before a snapshot is read or deleted)."""


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def delete(directory: str, step: int) -> None:
    path = os.path.join(directory, f"step_{step:08d}")
    if os.path.isdir(path):
        shutil.rmtree(path)


def _shapes(sd: Mapping) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in sd.items()}


def _layout_errors(state, payload: Mapping) -> list:
    """How ``payload`` differs from the layout of ``state``; [] when it fits."""
    kind = "simt" if isinstance(state, SimTState) else "warmup"
    if payload.get("kind") != kind:
        return [f"a {payload.get('kind')!r} snapshot for a {kind!r} state"]
    nets = [("model", state.model)]
    if kind == "simt":
        nets.append(("teacher", state.teacher))
    errors = []
    for name, net in nets:
        want, got = _shapes(net.state_dict()), _shapes(payload[name])
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:4]
            errors.append(f"{name}: tensors differ in name or shape, e.g. {diff}")
    want = [len(g["params"]) for g in state.model_opt.param_groups]
    got = [len(g["params"]) for g in payload["model_opt"]["param_groups"]]
    if want != got:
        errors.append(f"model optimizer groups of {got} parameters, want {want}")
    if kind == "simt":
        for k in _NTM:
            want, got = tuple(getattr(state, k).param.shape), tuple(payload[k]["param"].shape)
            if want != got:
                errors.append(f"{k}: shape {got}, want {want}")
    return errors


def restore(state, directory: str, step: Optional[int] = None):
    """Load the snapshot ``step`` (the latest when None) of ``directory`` into
    ``state``, a freshly built ``SimTState`` or ``WarmupState`` of the same
    configuration, in place; returns ``state``. Tensors are read onto the state's
    device, so a snapshot written on the card restores on the CPU and the other way
    round. The modules and parameters stay the objects they were (``load_state_dict``
    copies into them), so what the kernels keep per device and stream stays valid.
    Raises ``ValueError`` before loading anything when the snapshot's layout differs."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = snapshot_path(directory, step)
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, FILE), map_location=device, weights_only=True)
    errors = _layout_errors(state, payload)
    if errors:
        raise ValueError(
            f"checkpoint at {path} does not match the current train-state layout "
            "(was it written for another stage, class count or model? resume requires "
            "a same-layout snapshot): " + "; ".join(errors))
    state.model.load_state_dict(payload["model"], strict=True)
    state.model_opt.load_state_dict(payload["model_opt"])
    if isinstance(state, SimTState):
        state.teacher.load_state_dict(payload["teacher"], strict=True)
        for k in _NTM:
            ntm = getattr(state, k)
            with torch.no_grad():
                ntm.param.copy_(payload[k]["param"])
            opt_sd = payload[k]["opt"]
            for s in opt_sd["state"].values():
                # Adam keeps its step count on the host unless capturable; on the card
                # every step would read it back.
                s["step"] = s["step"].cpu()
            ntm.opt.load_state_dict(opt_sd)
    state.step = int(payload["step"])
    return state


def snapshot_bytes(directory: str, step: int) -> int:
    """Bytes on disk of the snapshot ``step``."""
    path = snapshot_path(directory, step)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` state_dict, or an ``.npz`` of arrays, as CPU tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    return load_pth(path)


def load_warmstart(model: nn.Module, path: str, *, strip_prefix: int = 0) -> dict:
    """Overlay the ``.pth`` or ``.npz`` state_dict at ``path`` on ``model``: the entries
    whose key (after dropping ``strip_prefix`` characters) and shape match, through
    ``from_jax.load_matching`` (the reference's partial loads, trainV2_simt.py:252-255
    and, with ``strip_prefix=6``, trainV1_warmup.py:176-179). Returns its report."""
    return load_matching(model, read_state_dict(path), strip_prefix=strip_prefix)

