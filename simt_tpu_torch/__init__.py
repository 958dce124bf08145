"""simt_tpu_torch — the PyTorch + CUDA port of simt_tpu for NVIDIA Hopper (H100).

The package mirrors ``simt_tpu``'s layout module for module, so each file has a
counterpart of the same name there. It imports ``torch`` and never ``jax`` nor
anything of ``simt_tpu``: what it needs of the JAX package (constants, list files,
the interpolation matrices) it keeps as its own copy.

Slice 1 covers the two-scale Cityscapes evaluation: the data path, DeepLabv2-ResNet-101
with open-set heads, weights carried over from JAX or a reference ``.pth``, the
align-corners upsample, the metrics and the fused upsample+argmax+histogram CUDA kernel
(``ops/kernels/eval_fused.py``). Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""

from . import config

__version__ = "0.1.0"
