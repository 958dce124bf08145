"""Configuration (counterpart of ``simt_tpu/config.py``).

The evaluation protocol's constants and the training dataclasses of both stages
(warmup and SimT) with the named presets of the published runs. All defaults are
documented against the reference file:line they reproduce, and the (data, spatial)
mesh of the data-parallel ranks (``MeshConfig``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

# BGR mean, matching IMG_MEAN in the reference trainers (trainV2_simt.py:34).
IMG_MEAN_BGR: Tuple[float, float, float] = (104.00698793, 116.66876762, 122.67891434)

NUM_CLASSES = 19  # known classes (trainV2_simt.py:50)
OPEN_CLASSES = 15  # open-set placeholder classes (sh_simt.sh:17)

# Two input scales as (w, h) and the label resolution as (h, w)
# (evaluate_cityscapes.py:103-108).
EVAL_SCALES: Tuple[Tuple[int, int], ...] = ((1024, 512), (1280, 640))
EVAL_OUT_HW: Tuple[int, int] = (1024, 2048)

# The presets of the warmup stage (stage 1); the others are the SimT stage's.
WARMUP_PRESETS: Tuple[str, ...] = ("warmup_bapa",)

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "data", "assets")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration (reference: dataset/*.py ctor args); the JAX
    package's defaults."""

    # Root of the Cityscapes-layout dataset (images under <root>/<relative list paths>).
    root: str = ""
    # A .lst file of "image\tlabel" rows (cityscapes_dataset.py:76), or a plain name
    # list for the gta5 source (gta5_dataset.py:23).
    list_path: str = os.path.join(ASSETS_DIR, "cityscapes_list", "pseudo_bapa.lst")
    # (width, height), matching INPUT_SIZE_TARGET '1024,512' (trainV2_simt.py:46).
    crop_size: Tuple[int, int] = (1024, 512)
    mean_bgr: Tuple[float, float, float] = IMG_MEAN_BGR
    # Random horizontal mirror (cityscapes_dataset.py:111-114).
    mirror: bool = True
    ignore_label: int = 255
    num_workers: int = 4
    # Per data shard: the global batch is batch_size * MeshConfig.data_axis, so the
    # reference's batch-1 configurations scale to data parallelism unchanged.
    batch_size: int = 1
    # Batches in flight to the card (device_prefetch) and the loader's queue depth.
    prefetch: int = 2
    # The native C++ preprocessing (data/_native_preproc.py); False decodes with PIL.
    use_native_preproc: bool = True
    # Decode in spawned worker processes (the reference's DataLoader model; Pillow
    # holds the interpreter lock while it decodes, so thread workers scale negatively).
    process_workers: bool = True
    # On-disk cache of decoded and resized crops (data/pipeline.py CropCache): epochs
    # after the first decode no PNG. "" disables it.
    crop_cache_dir: str = ""
    # "cityscapes_pseudo" (the trained configuration: image + pseudo-label rows) or
    # "gta5" (name lists with the GTA5 id remap).
    source: str = "cityscapes_pseudo"


# The model families (the reference's MODEL choices, evaluate_cityscapes.py:38).
ARCHS: Tuple[str, ...] = ("deeplab_multi", "deeplab_single", "deeplab_vgg", "deeplabv3")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model family and head configuration (reference: model/deeplab_multi.py)."""

    # One of ARCHS. The SimT stage trains deeplab_multi only (trainV2_simt.py:250).
    arch: str = "deeplab_multi"
    num_classes: int = NUM_CLASSES  # NUM_CLASSES, trainV2_simt.py:50
    open_classes: int = OPEN_CLASSES  # sh_simt.sh:17 (module default 15, :51)
    # The open-set heads (layer5_1/layer6_1). The SimT stage's student has them
    # whatever this says, as in the JAX package; the presets set it per stage.
    openset: bool = False
    # "bfloat16": convolutions under bf16 autocast, float32 parameters and head sums;
    # "float32": everything in float32.
    compute_dtype: str = "bfloat16"
    # The ASPP branches the heads sum: 2 is the reference quirk (a return inside the
    # loop, deeplab_multi.py:115-119). Res_Deeplab always sums 4 (deeplab.py:112-116),
    # so for that arch the config holds 4 whatever it is given. Branches past the
    # count are frozen in every stage.
    aspp_effective_branches: int = 2

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r} (one of {', '.join(ARCHS)})")
        if self.arch == "deeplab_single":
            object.__setattr__(self, "aspp_effective_branches", 4)
        if not 1 <= self.aspp_effective_branches <= 4:
            raise ValueError(f"aspp_effective_branches={self.aspp_effective_branches}: an "
                             "ASPP head has 4 branches")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """SGD/Adam + poly schedule (trainV2_simt.py:174-185, 271-280, 296-297)."""

    learning_rate: float = 2.5e-4  # LEARNING_RATE trainV2_simt.py:47
    learning_rate_t: float = 2.5e-3  # sh_simt.sh:17 uses lr_T = 10x lr (logs lr25)
    momentum: float = 0.9  # MOMENTUM :49
    weight_decay: float = 5e-4  # WEIGHT_DECAY :59
    power: float = 0.9  # POWER :54
    num_steps: int = 250_000  # NUM_STEPS :52 (schedule horizon)
    # Gradient accumulation: sub-batches per optimizer step, each loss scaled by
    # 1/iter_size (ITER_SIZE trainV2_simt.py:38,85-86; sub-loop :345,:426-436).
    iter_size: int = 1


@dataclasses.dataclass(frozen=True)
class SimTConfig:
    """SimT loss hyper-parameters (canonical set: sh_simt.sh:17)."""

    threshold_high: float = 0.8  # --Threshold-high
    threshold_low: float = 0.2  # --Threshold-low
    lambda_seg: float = 0.1  # LAMBDA_SEG trainV2_simt.py:68
    lambda_place: float = 0.1  # --lambda-Place
    lambda_convex: float = 0.1  # --lambda-Convex
    lambda_volume: float = 1.0  # --lambda-Volume
    lambda_anchor: float = 1.0  # --lambda-Anchor
    inner_w_steps: int = 10  # inner W-optimisation loop count (trainV2_simt.py:327)
    # Class-distribution prior for sig_NTM (deeplab_multi.py:255): a name under
    # data/assets/class_dist or a .npy path.
    class_dist: str = "bapa"
    # Cache the frozen teacher's per-image posterior instead of recomputing it every step
    # (train/teacher_cache.py). Off by default: cached entries are rounded to float16.
    cache_teacher: bool = False
    # Output-row chunk of the plain (CPU) loss core; the math is chunk-invariant.
    loss_chunk_rows: int = 64
    # False (reference-verbatim): the inner W loop's T-gradients of MSE(W@T, 0) stay in
    # T's .grad and join the T update (trainV2_simt.py:317,:337,:435). True discards
    # them, as a zero_grad between :339 and :345 would.
    clear_inner_t_grads: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, spatial) mesh of the ranks (the reference has no distribution; the JAX
    package's ``MeshConfig``, simt_tpu/config.py:130-135). One rank is one process on
    one device, so ``data_axis * spatial_axis`` must equal the process group's world
    size (``parallel/mesh.py::make_mesh``); a single process runs 1 x 1."""

    data_axis: int = 1  # data parallelism degree (batch dim)
    spatial_axis: int = 1  # spatial (H) sharding degree: each image's rows split


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level training configuration."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    simt: SimTConfig = dataclasses.field(default_factory=SimTConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    num_steps: int = 250_000  # NUM_STEPS trainV2_simt.py:52
    num_steps_stop: int = 40_000  # NUM_STEPS_STOP :53 (warmup uses 150k, trainV1:52)
    save_pred_every: int = 1_000  # SAVE_PRED_EVERY :57
    log_every: int = 100  # print cadence trainV2_simt.py:438
    random_seed: int = 1234  # RANDOM_SEED :55
    snapshot_dir: str = "snapshots"
    restore_from: str = ""
    ignore_label: int = 255
    # Stage: "warmup" or "simt".
    stage: str = "simt"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> TrainConfig:
    """Named presets of the published runs (those of ``simt_tpu/config.py``):

    - ``warmup_bapa``: sh_warmup.sh stage-1 training (trainV1_warmup.py defaults:
      the warmup stage, closed set, NUM_STEPS_STOP 150 000, :52);
    - ``simt_bapa_lr25``: logs/BAPA_SimT_lr25.out (lr 2.5e-4 / lr_T 2.5e-3);
    - ``simt_bapa_lr6``: sh_simt.sh:17 (lr 6e-4 / lr_T 6e-3);
    - ``simt_sfda``: logs/SFDA_SimT.out (lr 2.5e-4 / lr_T 2.5e-3). It differs from
      ``simt_bapa_lr25`` only in its pseudo-label list, ``pseudo_sfdaseg.lst``; sig_NTM
      reads ClassDist_bapa.npy in every run (deeplab_multi.py:255).

    The SimT presets set ``stage="simt"`` and ``openset=True``. Every other preset
    trains on ``pseudo_bapa.lst``, ``DataConfig``'s default.
    """
    base = TrainConfig()
    if name == "warmup_bapa":
        return base.replace(stage="warmup", num_steps_stop=150_000,
                            model=ModelConfig(openset=False))
    lrs = {"simt_bapa_lr25": (2.5e-4, 2.5e-3), "simt_bapa_lr6": (6e-4, 6e-3),
           "simt_sfda": (2.5e-4, 2.5e-3)}
    if name not in lrs:
        raise ValueError(f"unknown preset: {name!r}")
    lr, lr_t = lrs[name]
    cfg = base.replace(
        stage="simt", model=ModelConfig(openset=True),
        optim=dataclasses.replace(base.optim, learning_rate=lr, learning_rate_t=lr_t))
    if name == "simt_sfda":
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, list_path=os.path.join(
            ASSETS_DIR, "cityscapes_list", "pseudo_sfdaseg.lst")))
    return cfg
