"""Dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).

Copied from ``simt_tpu_torch/device.py`` (PEAK_BF16_FLOP_S, PEAK_F32_FLOP_S,
PEAK_BYTES_S) and ``simt_tpu_torch/ops/kernels/loss_fused.py`` (PEAK_SFU_S) at commit
57e0c1f20d09ebc147d8826943b2979c8e4667bf.
"""

PEAK_BF16_FLOP_S = 989e12  # bf16 tensor cores, dense
PEAK_F32_FLOP_S = 67e12  # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # HBM3
# The special-function units' results/s (16 a clock on each of 132 SMs at 1.98 GHz).
PEAK_SFU_S = 16 * 132 * 1.98e9
