"""The frozen copies equal the port's originals at today's shapes (the copies are the
yardstick; a later change to the port moves the originals, never the copies)."""

import inspect

import pytest
import torch

from benchmark.frozen import families, peaks, timing, work
from simt_tpu_torch import device as port_device
from simt_tpu_torch.ops.kernels import conv3x3, eval_fused, loss_fused
from simt_tpu_torch.tools import profile_trace
from simt_tpu_torch.tools import timing as port_timing

# (batch, H, W, C) of the trunk's 3x3 convs at 512x1024 and 640x1280.
CONV_SHAPES = [(16, 129, 257, 64), (16, 65, 129, 128), (16, 65, 129, 256),
               (16, 65, 129, 512), (8, 161, 321, 64), (8, 81, 161, 512)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("op", ["fwd", "dx", "wgrad"])
def test_conv3x3_work(shape, op):
    b, h, w, c = shape
    assert work.conv3x3_work(b, h, w, c, c, 2, op) == conv3x3.work(b, h, w, c, c,
                                                                    torch.bfloat16, op)


@pytest.mark.parametrize("labelled", [None, 123456, 2 * 16 * 512 * 1024 * 9 // 10])
def test_loss_core_work_and_bound(labelled):
    args = (16, 65, 129, 512, 1024, 19, 15)
    assert work.loss_core_work(*args, labelled=labelled) == loss_fused.work(
        *args, labelled=labelled)
    for k in ("fwd", "bwd"):
        w = loss_fused.work(*args, labelled=labelled)[k]
        ms, _, term = loss_fused.bound(*w)
        s, t = work.bound(*w)
        assert s * 1e3 == pytest.approx(ms, rel=1e-12) and t == term


@pytest.mark.parametrize("counted", [0, 8 * 1024 * 2048 * 9 // 10])
def test_eval_head_work(counted):
    args = (65, 129, 81, 161, (1024, 2048), 19, 8, counted)
    assert work.eval_head_work(*args, gt_bytes=1) == eval_fused.work(*args, gt_bytes=1)


def test_peaks_and_families_and_primer():
    assert peaks.PEAK_BF16_FLOP_S == port_device.PEAK_BF16_FLOP_S
    assert peaks.PEAK_F32_FLOP_S == port_device.PEAK_F32_FLOP_S
    assert peaks.PEAK_BYTES_S == port_device.PEAK_BYTES_S
    assert peaks.PEAK_SFU_S == loss_fused.PEAK_SFU_S
    assert families.FAMILIES == profile_trace.FAMILIES
    for name in ("void conv3x3_fwd_wgmma<...>", "cudnn::bn_fw_tr_1C11", "Memcpy DtoD",
                 "nvjet_tst_128x256", "loss_fwd_kernel", "vectorized_elementwise_kernel"):
        assert families.family(name) == profile_trace.family(name)
    assert timing.PRIMER_LAUNCHES == port_timing.PRIMER_LAUNCHES
    assert timing.PRIMER_WORD == port_timing.PRIMER_WORD
    for fn in ("prime_session", "kernel_events"):
        body = inspect.getsource(getattr(port_timing, fn)).split('"""')[-1]
        assert inspect.getsource(getattr(timing, fn)).split('"""')[-1] == body
