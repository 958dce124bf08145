"""Hand-written CUDA kernels for Hopper, one module per kernel, each beside its plain
PyTorch version. Sources live in ``simt_tpu_torch/csrc/``; ``_build`` compiles them."""

from .eval_fused import multiscale_argmax_hist, multiscale_argmax_hist_reference
