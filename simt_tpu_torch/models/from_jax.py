"""Weights carried across: the JAX variables tree or a reference ``.pth`` -> the port.

``state_dict_from_flax`` maps the JAX package's ``{"params", "batch_stats"}`` tree (as
numpy arrays) onto the reference key layout the port's modules use. It is the port's
own copy of the mapping in ``simt_tpu/models/import_torch.py``:

  - ``layer1_0`` -> ``layer1.0`` for the sequential stages; ``layer5_1`` / ``layer6_1``
    are module names (the open-set heads) and stay as they are;
  - ``downsample_conv`` / ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``;
  - ``branch{j}_kernel`` / ``branch{j}_bias`` -> ``conv2d_list.{j}.weight`` / ``.bias``;
  - conv kernels HWIO -> OIHW; BN ``scale`` -> ``weight``; ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_SEQ_BASES = ("layer1", "layer2", "layer3", "layer4", "features")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out: Dict[Tuple[str, ...], object] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def torch_key(path: Tuple[str, ...]) -> Optional[Tuple[str, bool]]:
    """(state_dict key, needs HWIO->OIHW) for a JAX variable path starting with its
    collection ('params' or 'batch_stats'); None for paths with no counterpart."""
    collection, *rest = path
    leaf = rest[-1]
    mods = []
    for name in rest[:-1]:
        base, _, idx = name.rpartition("_")
        if idx.isdigit() and base in _SEQ_BASES:
            mods += [base, idx]
        elif name == "downsample_conv":
            mods += ["downsample", "0"]
        elif name == "downsample_bn":
            mods += ["downsample", "1"]
        else:
            mods.append(name)

    if collection == "batch_stats":
        stat = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        return None if stat is None else (".".join(mods + [stat]), False)
    if leaf.startswith("branch") and leaf.endswith("_kernel"):
        j = leaf[len("branch"):-len("_kernel")]
        return ".".join(mods + ["conv2d_list", j, "weight"]), True
    if leaf.startswith("branch") and leaf.endswith("_bias"):
        j = leaf[len("branch"):-len("_bias")]
        return ".".join(mods + ["conv2d_list", j, "bias"]), False
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf == "scale":
        return ".".join(mods + ["weight"]), False
    if leaf == "bias":
        return ".".join(mods + ["bias"]), False
    return None


def state_dict_from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` for a JAX variables tree of numpy arrays."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, val in _flatten(variables).items():
        mapped = torch_key(path)
        if mapped is None:
            continue
        key, transpose = mapped
        arr = np.asarray(val)
        if transpose and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        out[key] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` state_dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_matching(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Load the entries of ``state_dict`` whose key and shape match the model (the
    reference's key-intersection warm start, trainV2_simt.py:252-255). Returns a report
    of loaded / skipped (shape mismatch) / missing / unused keys."""
    own = model.state_dict()
    report = {"loaded": [], "skipped": [], "missing": [], "unused": []}
    take = {}
    for k, v in state_dict.items():
        if k not in own:
            report["unused"].append(k)
        elif tuple(v.shape) != tuple(own[k].shape):
            report["skipped"].append(k)
        else:
            take[k] = v
            report["loaded"].append(k)
    report["missing"] = [k for k in own if k not in take
                         and not k.endswith("num_batches_tracked")]
    model.load_state_dict(take, strict=False)
    return report


def _as_f32(tree):
    if isinstance(tree, Mapping):
        return {k: _as_f32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def _variables(params, stats) -> "OrderedDict[str, torch.Tensor]":
    return state_dict_from_flax({"params": _as_f32(params), "batch_stats": _as_f32(stats)})


def warmup_state_from_jax(state) -> dict:
    """The port's pieces of a JAX ``WarmupState`` (``simt_tpu/train/state.py``) whose
    leaves are numpy arrays: ``model``, a state_dict of the params and batch statistics,
    and ``step``, the step as an int.

    The SGD momentum is not carried: at step 0 it is zero, which is what
    ``train.warmup.create_warmup_state`` starts from.
    """
    return {"model": _variables(state.model.params, state.model.batch_stats),
            "step": int(np.asarray(state.step))}


def simt_state_from_jax(state) -> dict:
    """The port's pieces of a JAX ``SimTState`` (``simt_tpu/train/state.py``) whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``), read by attribute:

      - ``student`` / ``teacher``: state_dicts (params and batch statistics; a
        bfloat16-stored teacher kernel comes back as float32);
      - ``t1``, ``t2``, ``w1``, ``w2``: float32 tensors of the NTM / W parameters;
      - ``step``: the outer step as an int.

    The optimizer moments are not carried: at step 0 they are zeros, which is what
    ``train.simt.create_simt_state`` starts from.
    """
    ntm = {k: torch.from_numpy(np.array(getattr(state, k).param, np.float32))
           for k in ("t1", "t2", "w1", "w2")}
    return {
        "student": _variables(state.model.params, state.model.batch_stats),
        "teacher": _variables(state.teacher_params, state.teacher_batch_stats),
        **ntm,
        "step": int(np.asarray(state.step)),
    }
