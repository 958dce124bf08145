"""Hand-written CUDA kernels for Hopper, one module per kernel, each beside its plain
PyTorch version. Sources live in ``simt_tpu_torch/csrc/``; ``_build`` compiles them."""

from .bottleneck import (bottleneck_bwd, bottleneck_bwd_plain, bottleneck_fwd,
                         bottleneck_fwd_plain)
from .conv3x3 import conv3x3_fwd, conv3x3_taps, conv3x3_wgrad, wgrad_taps
from .eval_fused import multiscale_argmax_hist, multiscale_argmax_hist_reference
from .loss_fused import (SimTLossCore, loss_core_bwd, loss_core_bwd_reference,
                         loss_core_fwd, loss_core_fwd_reference)
