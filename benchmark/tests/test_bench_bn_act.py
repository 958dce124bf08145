"""The fused BatchNorm's launch counts, read from hand-made sessions: by the kernel's
name, per step or call, and absent where no launch holds the name."""

from benchmark import harness
from benchmark.frozen.families import family

KERNEL = ("void (anonymous namespace)::bn_fw_act_kernel<true, true>(uint4 const*, "
          "uint4 const*, uint4*, float const*, float const*, float const*, float const*, "
          "float, long long, int)")


def _rec(driver, ops, calls):
    return {"mix": {"driver": driver}, "session": {"calls": calls, "window_us": 1e3,
                                                   "ops": ops, "host": []}}


def test_counts_the_kernel_by_name_per_call():
    ops = [(KERNEL, 1.0, 2.0)] * 6 + [("batch_norm_transform_input_kernel", 4.0, 1.0)]
    assert harness.reader("bn_act_launches.eval").read(_rec("eval", ops, 3)) == 2.0
    assert harness.reader("bn_act_launches.simt").read(_rec("eval", ops, 3)) is None
    assert harness.reader("bn_act_launches.simt").read(_rec("train", ops, 2)) == 3.0
    assert family(KERNEL) == "batch norm"  # batchnorm_ms counts it


def test_absent_without_the_kernel():
    ops = [("batch_norm_transform_input_kernel", 4.0, 1.0)]
    assert harness.reader("bn_act_launches.eval").read(_rec("eval", ops, 3)) is None
    assert harness.reader("bn_act_launches.simt").read(_rec("train", ops, 3)) is None
    assert harness.reader("bn_act_launches.eval").read({"mix": {"driver": "eval"}}) is None
