"""simt_tpu_torch — the PyTorch + CUDA port of simt_tpu for NVIDIA Hopper (H100).

The package mirrors ``simt_tpu``'s layout module for module, so each file has a
counterpart of the same name there. It imports ``torch`` and never ``jax`` nor
anything of ``simt_tpu``: what it needs of the JAX package (constants, list files,
the interpolation matrices) it keeps as its own copy.

Ported so far: the two-scale Cityscapes evaluation (with the fused
upsample+argmax+histogram kernel, ``ops/kernels/eval_fused.py``), the SimT train step
(with the streamed loss core's kernels, ``ops/kernels/loss_fused.py``) and the warmup
train step, on DeepLabv2-ResNet-101 whose bottleneck 3x3 convs run the port's own
kernels (``ops/kernels/conv3x3.py``); the host input pipeline from list files on disk
to the card (``data/pipeline.py``, ``train/loop.py::build_loader``) and the bench entry
(``tools/bench.py``); the training loop with evaluation in the loop, full-state
snapshots and resume (``train/loop.py::train``, ``train/checkpoint.py``), the CLIs on
their shared flags (``tools/common.py``: ``train_simt``, ``train_warmup``, ``test``)
and the offline tools (``compute_iou``, ``compute_class_distribution``,
``compute_confusion_matrix``, ``export_torch``). Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from . import config

__version__ = "0.1.0"
