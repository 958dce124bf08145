"""The port's profiling tools on the CPU (simt_tpu_torch/tools/{flops, roofline,
profile_trace, profile_step, profile_model, profile_trunk, profile_layer3, timing}.py)
and the card's peaks in one place (simt_tpu_torch/device.py).

  - ``flops.step_work`` of the SimT step at layers (1,1,1,1), 64x128, 19 + 15 classes,
    float32 within 5% of XLA's cost analysis of the JAX step compiled on the CPU at the
    same geometry (0.976 measured when the tool was written);
  - the count does not depend on the implementation: conv2 on the plain taps (the port's
    op on the CPU: aten.bmm + aten.mm) and on ``F.conv2d`` (aten.convolution and its
    backward) count the same FLOPs to 1e-9, alone and inside a bottleneck, forward and
    forward + backward;
  - ``profile_trace.family`` on fixed kernel names (the port's own kernels' symbols
    from ``csrc/`` and library kernels' names as the H100's profiler reports them), and
    the families partition a session's total;
  - ``roofline.roofline``'s arithmetic on a given count and time, and its raise above
    1.05;
  - each tool's ``main(["--device", "cpu", ...])`` at a tiny geometry prints its lines
    and one JSON line last with its keys, the device numbers null (not measured); each
    raises without a card when ``--device cpu`` is not given;
  - the bounds and schedules that read ``device.py``'s peaks return the numbers they
    returned when the peaks were copies in their modules.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from simt_tpu.config import ModelConfig as JModelConfig
from simt_tpu.config import SimTConfig as JSimTConfig
from simt_tpu.config import TrainConfig as JTrainConfig
from simt_tpu.data import synthetic as jsynthetic
from simt_tpu.models.resnet_multi import ResNetMulti as JResNetMulti
from simt_tpu.train import create_simt_state as j_create, make_simt_step as j_make
from simt_tpu_torch import device
from simt_tpu_torch.models import layers
from simt_tpu_torch.ops.conv import dilated_conv3x3
from simt_tpu_torch.ops.kernels import conv3x3, loss_fused
from simt_tpu_torch.tools import (flops, profile_layer3, profile_model, profile_step,
                                  profile_trace, profile_trunk, roofline, timing)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny calls run faster on one thread than on threads that the test run's other
    workers share."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------------
# The count
# ---------------------------------------------------------------------------------

def test_step_count_matches_the_jax_executables():
    hw, layers_ = (64, 128), (1, 1, 1, 1)
    cfg = JTrainConfig(model=JModelConfig(num_classes=19, open_classes=15, openset=True,
                                          compute_dtype="float32"),
                       simt=JSimTConfig())
    student = JResNetMulti(num_classes=19, open_classes=15, openset=True, layers=layers_,
                           dtype=jnp.float32)
    teacher = JResNetMulti(num_classes=19, layers=layers_, dtype=jnp.float32)
    x0 = jnp.zeros((1, *hw, 3))
    sv = jax.jit(lambda r: student.init(r, x0, False))(jax.random.PRNGKey(0))
    tv = jax.jit(lambda r: teacher.init(r, x0, False))(jax.random.PRNGKey(1))
    state = j_create(sv, tv, cfg, jax.random.PRNGKey(2))
    raw = jsynthetic.synthetic_batch(batch_size=1, hw=hw, num_classes=19, seed=0)
    batch = {"image": jnp.asarray(raw["image"]), "label": jnp.asarray(raw["label"])}
    ca = j_make(student, teacher, cfg).lower(state, batch).compile().cost_analysis()
    want = float((ca[0] if isinstance(ca, list) else ca)["flops"])

    got = flops.step_work("step", layers=layers_, hw=hw)
    assert got["flops"] == pytest.approx(want, rel=0.05), (got["flops"], want)
    assert sum(v["flops"] for v in got["by_op"].values()) == got["flops"]
    assert got["bytes"] > 0
    again = flops.step_work("step", layers=layers_, hw=hw)
    assert again == got and again is not got  # cached, each caller its own copy


def _conv_calls(x, w, conv):
    def fwd():
        return conv(x, w)

    def fwdbwd():
        xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        return torch.autograd.grad((conv(xl, wl) ** 2).sum(), (xl, wl))

    return fwd, fwdbwd


def _cudnn_conv2(x, w, d=2):
    return F.conv2d(x, w, padding=d, dilation=d)


def test_conv2_counts_the_same_on_the_taps_and_on_conv2d():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 9, 13, generator=gen)
    w = torch.randn(16, 32, 3, 3, generator=gen)
    taps = _conv_calls(x, w, lambda a, b: dilated_conv3x3(a, b, 2))
    lib = _conv_calls(x, w, _cudnn_conv2)
    want = 2 * 9 * 13 * 9 * 32 * 16  # 1,078,272 multiply-adds' worth
    for (t, ref), n in zip(zip(taps, lib), (want, 3 * want)):
        a, b = flops.count(t), flops.count(ref)
        assert a["flops"] == b["flops"] == n
        assert set(a["by_op"]) <= {"aten.bmm", "aten.mm"}
        assert set(b["by_op"]) <= {"aten.convolution", "aten.convolution_backward"}


def test_bottleneck_counts_the_same_whatever_runs_conv2(monkeypatch):
    gen = torch.Generator().manual_seed(1)
    block = layers.Bottleneck(64, 16, dilation=2).train()
    x = torch.randn(1, 64, 9, 13, generator=gen)

    def calls():
        def fwd():
            with torch.no_grad():
                return block(x)

        def fwdbwd():
            xl = x.detach().requires_grad_(True)
            ws = [block.conv1.weight, block.conv2.weight, block.conv3.weight]
            # a view into the block: the counter's module hooks cannot take a leaf input
            return torch.autograd.grad((block(xl.view_as(xl)) ** 2).sum(), (xl, *ws))

        return flops.count(fwd)["flops"], flops.count(fwdbwd)["flops"]

    taps = calls()
    monkeypatch.setattr(layers, "dilated_conv3x3", _cudnn_conv2)
    lib = calls()
    for a, b in zip(taps, lib):
        assert a == pytest.approx(b, rel=1e-9)
    assert taps[1] > 2 * taps[0] > 0


# ---------------------------------------------------------------------------------
# Families, the roofline's arithmetic
# ---------------------------------------------------------------------------------

# Kernel names as torch.profiler reported them on an H100 (torch 2.11, CUDA 12.8), cut
# short; the port's own are its csrc/ symbols.
@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::eval_fused_hist_kernel(float const*, float const*, "
     "unsigned char const*)", "B1 eval_fused"),
    ("void (anonymous namespace)::loss_fwd_kernel<34>(float const*, int const*)",
     "B2 loss_fwd"),
    ("void (anonymous namespace)::loss_bwd_kernel<34>(float const*, float const*)",
     "B3 loss_bwd"),
    ("void (anonymous namespace)::conv3x3_fwd_wgmma_kernel<128>(CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, int)", "B4 conv3x3 fwd/dx"),
    ("conv3x3_fwd_kernel", "B4 conv3x3 fwd/dx"),
    ("void (anonymous namespace)::conv3x3_wgrad_wgmma_kernel<128, 256>(CUtensorMap_st, "
     "CUtensorMap_st, float*, int*, float*)", "B5 conv3x3 wgrad"),
    ("conv3x3_wgrad_kernel", "B5 conv3x3 wgrad"),
    ("bneck_gemm_wgmma_kernel", "B6/B7 bneck"),
    ("bneck_wgrad_wgmma_kernel", "B6/B7 bneck"),
    ("bneck_wgrad_reduce_kernel", "B6/B7 bneck"),
    ("bneck_stats_kernel", "B6/B7 bneck"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_"
     "256x64_32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_"
     "32x4_nhwc_align8::Params)", "conv fprop (cuDNN)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv fprop (cuDNN)"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int, int, int, int)", "conv fprop (cuDNN)"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64_"
     "warpgroupsize2x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv dgrad (cuDNN)"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_optimized_bf16_"
     "128x128_32x3_nhwc_unity_stride_align8>", "conv dgrad (cuDNN)"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
     "64x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn",
     "conv wgrad (cuDNN)"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolutionINS1_11thread"
     "block22ImplicitGemmMultistageINS_4gemm9GemmShapeILi64ELi128ELi32EEENS4_52Conv2dWgrad"
     "OutputGradientTileAccessIteratorOptimized", "conv wgrad (cuDNN)"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
     "c10::BFloat16, float, 4>(c10::BFloat16 const*, float*, float*)", "batch norm"),
    ("void at::native::batch_norm_backward_elemt_channels_last_kernel<4, c10::BFloat16, "
     "float, float>(c10::BFloat16 const*)", "batch norm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
     "batch_norm_calc_invstd(at::Tensor const&, at::Tensor const&, double)", "batch norm"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "GEMM (cuBLAS/nvjet/cutlass)"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float>",
     "GEMM (cuBLAS/nvjet/cutlass)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8_stage3_warpsize2x2x1_ffma_"
     "aligna4_alignc4_execute_kernel__5x_cublas", "GEMM (cuBLAS/nvjet/cutlass)"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(cutlass_80_simt_"
     "sgemm_64x64_8x5_nn_align1::Params)", "GEMM (cuBLAS/nvjet/cutlass)"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
     "(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::"
     "BinaryOpListAlphaFunctor<float, 2, 2, 0>>", "optimizer"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "NCCL"),
    ("Memcpy DtoD (Device -> Device)", "copy / memset"),
    ("Memset (Device)", "copy / memset"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_"
     "cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >",
     "copy / memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
     "std::array<char*, 1ul> >", "copy / memset"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::"
     "MaxOps<float>, unsigned int, float, 4, 4> >", "reduction"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16, int>"
     "(c10::BFloat16 const*, int)", "reduction"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 6, false, "
     "false>(float*, float const*, int, int, int, bool const*, int, bool)", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
     "launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar)",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::"
     "BFloat16>, std::array<char*, 3ul> >", "elementwise"),
    ("void getrf_pivot<getrf_params_<float, 32, 1, 32, 32, 1> >(int, int, int, void*)",
     "other"),
])
def test_family_of_a_kernel_name(name, fam):
    assert profile_trace.family(name) == fam


def test_families_partition_a_sessions_total():
    by_name = {"loss_fwd_kernel": (2, 0.25), "nvjet_tst_x": (6, 1.5),
               "Memset (Device)": (4, 0.125), "mystery": (2, 0.0625),
               "sm90_xmma_wgrad_implicit_gemm": (10, 3.0)}
    fams, kernels = profile_trace.by_family(by_name, calls=2)
    total = sum(ms for _, ms in by_name.values()) / 2
    assert sum(f["ms"] for f in fams.values()) == pytest.approx(total, rel=1e-12)
    assert sum(f["share"] for f in fams.values()) == pytest.approx(1.0, rel=1e-12)
    assert list(fams)[0] == "conv wgrad (cuDNN)" and fams["other"]["launches"] == 1
    assert [k[0] for k in kernels][:2] == ["sm90_xmma_wgrad_implicit_gemm", "nvjet_tst_x"]


def test_roofline_arithmetic():
    flop = 0.01 * device.PEAK_BF16_FLOP_S  # 10 ms at the bf16 peak
    nbytes = 0.004 * device.PEAK_BYTES_S  # 4 ms at the memory rate
    r = roofline.roofline(flop, nbytes, ms=100.0, device_ms=20.0)
    assert r["floor_ms_compute"] == pytest.approx(10.0)
    assert r["floor_ms_bytes"] == pytest.approx(4.0)
    assert r["mfu"] == pytest.approx(0.1) and r["mfu_device"] == pytest.approx(0.5)
    assert r["busy"] == pytest.approx(0.2) and r["headroom_x"] == pytest.approx(10.0)
    assert r["steps_per_sec"] == pytest.approx(10.0)
    assert r["achieved_tflops"] == pytest.approx(flop / 0.1 / 1e12)
    assert r["hbm_frac"] == pytest.approx(0.04)
    assert r["tflop_per_step"] == pytest.approx(flop / 1e12)
    assert roofline.roofline(flop, nbytes, ms=100.0)["mfu_device"] is None
    for kw in (dict(ms=9.0), dict(ms=100.0, device_ms=9.0), dict(ms=10.0, device_ms=11.0)):
        with pytest.raises(ValueError, match="above 1.05"):
            roofline.roofline(flop, nbytes, **kw)
    # The computed bytes are an upper bound: their share may pass 1 without a fault.
    assert roofline.roofline(flop, 100 * nbytes, ms=100.0)["hbm_frac"] > 1


def test_timed_steps_keeps_the_timed_metrics():
    calls = []

    def step(state, batch):
        calls.append(batch)
        return {"loss": torch.tensor(float(len(calls)))}

    batches = iter(range(10))
    out = []
    ms = timing.timed_steps(step, None, lambda: next(batches), 2, 3,
                            torch.device("cpu"), "loss", out)
    assert ms >= 0 and calls == [0, 1, 2, 3, 4]
    assert [float(m["loss"]) for m in out] == [3.0, 4.0, 5.0]
    assert timing.timed_steps(step, None, lambda: 0, 0, 1, torch.device("cpu"), None) >= 0


# ---------------------------------------------------------------------------------
# Each tool on the CPU
# ---------------------------------------------------------------------------------

TINY = ["--device", "cpu", "--layers", "1,1,1,1", "--hw", "32,64"]
TOOLS = {
    "roofline": (roofline, TINY + ["--n", "1"],
                 {"metric", "ms_per_step", "device_ms_per_step", "steps_per_sec", "busy",
                  "tflop_per_step", "gb_per_step_computed", "achieved_tflops", "mfu",
                  "mfu_device", "achieved_gbs", "floor_ms_compute", "floor_ms_bytes",
                  "headroom_x", "card", "power_limit_w"},
                 ("device_ms_per_step", "mfu", "mfu_device", "busy")),
    "profile_trace": (profile_trace, TINY + ["--what", "fwd"],
                      {"metric", "device_ms", "launches", "families", "top", "card",
                       "power_limit_w"}, ("device_ms", "launches")),
    "profile_step": (profile_step, TINY + ["--n", "1"],
                     {"metric", "rows", "spans", "card", "power_limit_w"}, ("spans",)),
    "profile_model": (profile_model, TINY + ["--n", "1"],
                      {"metric", "rows", "card", "power_limit_w"}, ()),
    "profile_trunk": (profile_trunk, TINY + ["--n", "1"],
                      {"metric", "rows", "sums", "card", "power_limit_w"}, ()),
    "profile_layer3": (profile_layer3, ["--device", "cpu", "--hw", "9,13", "--planes", "16",
                                        "--reps", "1", "--n", "1"],
                       {"metric", "reps", "rows", "gflop_per_rep", "card", "power_limit_w"},
                       ()),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_on_the_cpu_prints_its_lines_and_json(capsys, name):
    tool, argv, keys, nulls = TOOLS[name]
    out = tool.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) >= 2, lines  # the human block, then the JSON line
    line = json.loads(lines[-1])
    assert keys <= set(line), keys - set(line)
    assert line["card"] == "cpu" and line["power_limit_w"] is None
    assert json.loads(json.dumps(out)) == line
    for key in nulls:
        assert line[key] is None, key
    for row in line.get("rows", {}).values():  # not measured on the CPU
        assert row["device_ms"] is None and row["busy"] is None and row["wall_ms"] > 0


def test_roofline_on_the_cpu_counts_the_tiny_step(capsys):
    line = roofline.main(TINY + ["--n", "1"])
    work = flops.step_work("step", layers=(1, 1, 1, 1), hw=(32, 64))
    assert line["tflop_per_step"] == pytest.approx(work["flops"] / 1e12)
    assert line["floor_ms_compute"] == pytest.approx(
        work["flops"] / device.PEAK_BF16_FLOP_S * 1e3)
    assert "not HBM traffic" in capsys.readouterr().out


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a host without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        TOOLS[name][0].main([])


# ---------------------------------------------------------------------------------
# The peaks in one place
# ---------------------------------------------------------------------------------

def test_peaks_are_the_data_sheets():
    assert (device.PEAK_BF16_FLOP_S, device.PEAK_F32_FLOP_S, device.PEAK_BYTES_S) == \
        (989e12, 67e12, 3.35e12)


def test_loss_core_bound_unchanged():
    w = loss_fused.work(1, 65, 129, 512, 1024, 19, 15)
    assert loss_fused.bound(*w["fwd"]) == (0.018053994490358126, "operations", "sfu")
    assert loss_fused.bound(*w["bwd"]) == (0.01962531152238806, "operations", "float32")
    w = loss_fused.work(1, 65, 129, 512, 1024, 19, 15, place=600000, labelled=800000)
    assert loss_fused.bound(*w["fwd"]) == (0.014240113253749617, "operations", "sfu")
    assert loss_fused.bound(3.35e9, 0, 0)[1:] == ("bytes", "bytes")


@pytest.mark.parametrize("pixels,c,taps,o,want", [
    (129 * 257, 64, 9, 64, (64, 64, 14, 2432)),
    (65 * 129, 128, 9, 128, (128, 128, 11, 768)),
    (65 * 129, 256, 9, 256, (128, 128, 3, 2816)),
    (65 * 129, 512, 9, 512, (128, 256, 3, 2816)),
    (161 * 321, 64, 9, 64, (64, 64, 14, 3712)),
    (129 * 257, 64, 1, 256, (64, 64, 29, 1152)),
    (65 * 129, 256, 1, 1024, (128, 128, 7, 1216)),
    (65 * 129, 512, 1, 2048, (128, 128, 2, 4224)),
])
def test_conv_wgrad_schedule_unchanged(pixels, c, taps, o, want):
    t = conv3x3.wgrad_tiles(pixels, c, o, taps=taps)
    assert (t.bc, t.bo, t.splits, t.per_split) == want
