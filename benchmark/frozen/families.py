"""Kernel families by name on the card.

Copied from ``simt_tpu_torch/tools/profile_trace.py`` (``FAMILIES``, ``OTHER``,
``family``) at commit 57e0c1f20d09ebc147d8826943b2979c8e4667bf.
"""

# (family, words): a kernel's family is the first whose words one of appears in its
# name, lower-cased; "other" if none does. The port's own kernels first, by name; then
# cuDNN's convolutions by direction before the GEMMs (its implicit GEMMs hold "gemm");
# BatchNorm before the reductions and element-wise kernels its names also match; the
# copies and fills before the element-wise kernels that implement them.
FAMILIES = (
    ("B1 eval_fused", ("eval_fused",)),
    ("B2 loss_fwd", ("loss_fwd",)),
    ("B3 loss_bwd", ("loss_bwd",)),
    ("B5 conv3x3 wgrad", ("conv3x3_wgrad",)),
    ("B4 conv3x3 fwd/dx", ("conv3x3_fwd",)),
    ("B6/B7 bneck", ("bneck_",)),
    ("conv dgrad (cuDNN)", ("dgrad",)),
    ("conv wgrad (cuDNN)", ("wgrad",)),
    ("conv fprop (cuDNN)", ("fprop", "convolve", "conv2d", "implicit_gemm", "cudnn",
                            "nchwtonhwc", "nhwctonchw")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("GEMM (cuBLAS/nvjet/cutlass)", ("gemm", "nvjet", "cutlass", "cublas", "gemv",
                                     "splitkreduce", "xmma")),
    ("optimizer", ("multi_tensor_apply", "fused_adam", "fused_sgd")),
    ("NCCL", ("nccl",)),
    ("copy / memset", ("memcpy", "memset", "copy_kernel", "direct_copy", "catarray",
                       "fillfunctor", "fill_kernel")),
    ("reduction", ("reduce", "softmax", "max_pool", "avg_pool", "scan", "argmax",
                   "cunn_", "norm_kernel")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index_put", "where")),
)
OTHER = "other"


def family(name: str) -> str:
    """The family of a kernel (or memory operation) by its name on the card."""
    low = name.lower()
    for fam, words in FAMILIES:
        if any(w in low for w in words):
            return fam
    return OTHER
