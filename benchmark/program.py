"""The system under test: the port's models, train states and entry points, built
from the benchmark's own weights through the port's public API. The benchmark's other
modules reach the port only through here; the reference never does.

On a card the models run as the port serves them: float32 parameters, bf16 autocast,
``channels_last``. On the CPU (the benchmark's own tests) they run in float32.
"""

from __future__ import annotations

from typing import Dict

import torch


def load() -> None:
    """Import the port's modules the cells drive (their import is set-up's)."""
    import simt_tpu_torch.eval.evaluate  # noqa: F401
    import simt_tpu_torch.train  # noqa: F401


def port_config(cfg: dict):
    """The port's ``TrainConfig`` of a configuration file."""
    from simt_tpu_torch.config import ModelConfig, OptimConfig, SimTConfig, TrainConfig

    m, o, s = cfg["model"], cfg["optim"], cfg["simt"]
    model = ModelConfig(num_classes=m["num_classes"], open_classes=m["open_classes"],
                        openset=m["openset"], compute_dtype=m["compute_dtype"],
                        aspp_effective_branches=m["aspp_effective_branches"])
    optim = OptimConfig(learning_rate=o["learning_rate"],
                        learning_rate_t=o["learning_rate_t"], momentum=o["momentum"],
                        weight_decay=o["weight_decay"], power=o["power"],
                        num_steps=o["num_steps"])
    simt = SimTConfig(threshold_high=s["threshold_high"], threshold_low=s["threshold_low"],
                      lambda_seg=s["lambda_seg"], lambda_place=s["lambda_place"],
                      lambda_convex=s["lambda_convex"], lambda_volume=s["lambda_volume"],
                      lambda_anchor=s["lambda_anchor"], inner_w_steps=s["inner_w_steps"])
    return TrainConfig(model=model, optim=optim, simt=simt, stage=cfg["stage"])


def dtype(cfg: dict, device: torch.device) -> torch.dtype:
    """The model's compute dtype: the configuration's on a card, float32 on the CPU."""
    if device.type == "cuda" and cfg["model"]["compute_dtype"] == "bfloat16":
        return torch.bfloat16
    return torch.float32


def model(cfg: dict, weights: Dict[str, torch.Tensor], openset: bool,
          device: torch.device) -> torch.nn.Module:
    """The port's ``ResNetMulti`` holding ``weights``: built without initialising (on
    the meta device), then given the benchmark's tensors."""
    from simt_tpu_torch.models import ResNetMulti

    m = cfg["model"]
    with torch.device("meta"):
        net = ResNetMulti(m["num_classes"], m["open_classes"] if openset else 0, openset,
                          layers=tuple(m["layers"]), dtype=dtype(cfg, device),
                          aspp_effective_branches=m["aspp_effective_branches"])
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net


def simt(cfg: dict, student: dict, teacher: dict, ntm: dict, device: torch.device):
    """(state, step) of the SimT stage: ``create_simt_state`` and ``make_simt_step`` on
    the port's models, T1 / T2 / W1 / W2 and the class prior set to the benchmark's."""
    from simt_tpu_torch.train import create_simt_state, make_simt_step

    pcfg = port_config(cfg)
    state = create_simt_state(model(cfg, student, True, device),
                              model(cfg, teacher, False, device), pcfg,
                              torch.Generator().manual_seed(0), device)
    with torch.no_grad():
        for k in ("t1", "t2", "w1", "w2"):
            getattr(state, k).param.copy_(ntm[k])
    state.class_dist = torch.tensor(cfg["class_dist"], dtype=torch.float32, device=device)
    return state, make_simt_step(pcfg)


def warmup(cfg: dict, weights: dict, device: torch.device):
    """(state, step) of the warmup stage: ``create_warmup_state`` and
    ``make_warmup_step``."""
    from simt_tpu_torch.train.warmup import create_warmup_state, make_warmup_step

    pcfg = port_config(cfg)
    state = create_warmup_state(model(cfg, weights, cfg["model"]["openset"], device),
                                pcfg, device)
    return state, make_warmup_step(pcfg)


def eval_fn(cfg: dict, weights: dict, out_hw, device: torch.device):
    """(the model, ``predict_hist`` of ``make_eval_fn`` in the two-scale "simt" mode over
    it): the port's model in eval mode (``channels_last`` on a card, as ``evaluate``
    places it)."""
    from simt_tpu_torch.eval.evaluate import make_eval_fn

    net = model(cfg, weights, cfg["model"]["openset"], device).eval()
    if device.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    return net, make_eval_fn(net, cfg["model"]["num_classes"], "simt", tuple(out_hw))[1]
