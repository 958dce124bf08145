// Eval-mode BatchNorm with its ReLU and the bottleneck's residual add, in one pass, for
// Hopper (sm_90a): y = act(x * scale + shift [+ residual]) on channels_last bf16, with
// scale = weight / sqrt(running_var + eps) and shift = bias - running_mean * scale per
// channel, and act ReLU or the identity. Three variants: BN -> ReLU (the stem, bn1 and
// bn2 of every bottleneck), BN -> + residual -> ReLU (bn3) and BN alone (the downsample).
//
// Replaces no TPU kernel. On the TPU, XLA fused the running-statistics BatchNorm, its
// ReLU and the residual add into one pass over the activations, so the JAX package has
// no Pallas kernel for them (simt_tpu/models/layers.py leaves them to flax). The port's
// eval-mode trunk (the frozen SimT teacher, every evaluation) ran them as ATen's three
// passes: the BatchNorm transform, the ReLU and the add, each reading and writing every
// element in device memory.
//
// Arithmetic: fp32 throughout, each operation written with its rounding (__f*_rn, no
// contraction left to the compiler), so that ops/kernels/bn_act.py::bn_act_plain can
// repeat it bit for bit: each thread computes its 8 channels' scale = weight * (1 /
// sqrt(var + eps)) and shift = fma(-mean, scale, bias) once, then for each element
// fma(x, scale, shift), the residual's add and the ReLU, and one rounding to bf16
// (round to nearest even). The ReLU keeps a NaN, as torch.relu does. Rounded to bf16
// otherwise than ATen's three passes (which round after the transform and after the
// add), the output differs from theirs by about an ulp, more where the add cancels.
//
// Bound on an H100 SXM: bytes. Two flops an element against 4 bytes (BN -> ReLU, BN
// alone: x read, y written) or 6 (with the residual): about 0.5 flop a byte, far below
// the ~20 where float32 arithmetic (67 TFLOP/s) would bind. At layer3 of a batch of 16
// (65x129, 1024 channels) bn3 moves 825 MB: 0.246 ms at 3.35 TB/s.
//
// Design for HBM:
//   - 16-byte loads and stores, 8 channels a thread (C is a multiple of 8, checked by
//     the wrapper), neighbouring threads on neighbouring vectors: a warp moves 512
//     contiguous bytes an instruction;
//   - streaming cache hints (ld.global.cs / st.global.cs): every operand is read or
//     written once, and most of the trunk's tensors (17-550 MB at batch 8 to 16) are
//     larger than the 50 MB L2;
//   - a persistent grid: as many blocks as fit on the card at once, each thread walking
//     the tensor with a stride (the grid's threads) that is a multiple of C / 8, so the
//     channels of every vector it takes are the same and its 16 scale and shift values
//     stay in registers;
//   - kUnroll vectors a thread in flight (all loads issued before the first store), so
//     a resident SM has tens of KB of loads outstanding, enough to cover the latency;
//     the first ones are issued before the scale and shift are computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it stores
// Blocks an SM must hold, which caps a thread's registers: 4 (64 registers, 1024
// threads an SM), or 3 with the residual (80), whose 2 x kUnroll vectors in flight
// spill at 64.
template <bool kResidual>
constexpr int kMinBlocksPerSm = kResidual ? 3 : 4;
constexpr int kVec = 8;  // bf16 channels in a 16-byte vector

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return v;
}

// x, res, y: `vectors` 16-byte vectors of channels_last bf16 (res only if kResidual);
// groups = C / 8 vectors a pixel. gridDim.x * kThreads is a multiple of groups.
template <bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm<kResidual>)
    bn_fw_act_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                     uint4* __restrict__ y, const float* __restrict__ mean,
                     const float* __restrict__ var, const float* __restrict__ weight,
                     const float* __restrict__ bias, float eps, long long vectors,
                     int groups) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  uint4 xv[kUnroll], rv[kUnroll];
  auto load = [&](long long base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < vectors) {
        xv[u] = __ldcs(x + i);
        if constexpr (kResidual) rv[u] = __ldcs(res + i);
      }
    }
  };
  load(v);  // in flight while the channels' scale and shift are computed
  const int c0 = static_cast<int>(v % groups) * kVec;
  float scale[kVec], shift[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c0 + k], eps)));
    scale[k] = weight != nullptr ? __fmul_rn(weight[c0 + k], inv) : inv;
    shift[k] = __fmaf_rn(-mean[c0 + k], scale[k], bias != nullptr ? bias[c0 + k] : 0.0f);
  }
  for (; v < vectors; v += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * stride;
      if (i < vectors) {
        float f[kVec];
        unpack(xv[u], f);
        float r[kVec];
        if constexpr (kResidual) unpack(rv[u], r);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          float t = __fmaf_rn(f[k], scale[k], shift[k]);
          if constexpr (kResidual) t = __fadd_rn(t, r[k]);
          if constexpr (kRelu) t = t < 0.0f ? 0.0f : t;  // NaN stays NaN
          f[k] = t;
        }
        __stcs(y + i, pack(f));
      }
    }
    load(v + kUnroll * stride);
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks of the persistent grid: those resident on the card at once (the occupancy of
// this variant, read once), no more than the vectors need, and a whole multiple of
// groups / gcd(groups, kThreads), so that the grid's stride is a multiple of groups.
template <bool kResidual, bool kRelu>
int grid_blocks(long long vectors, int groups, int* blocks) {
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bn_fw_act_kernel<kResidual, kRelu>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long q = groups / gcd(groups, kThreads);
  const long long need = (vectors + static_cast<long long>(kThreads) * kUnroll - 1) /
                         (static_cast<long long>(kThreads) * kUnroll);
  long long n = need < resident ? need : resident;
  n = n / q * q;
  *blocks = static_cast<int>(n < q ? q : n);
  return 0;
}

template <bool kResidual, bool kRelu>
int launch(const void* x, const void* res, void* y, const float* mean, const float* var,
           const float* weight, const float* bias, float eps, long long vectors,
           int groups, cudaStream_t stream) {
  int blocks = 0;
  const int err = grid_blocks<kResidual, kRelu>(vectors, groups, &blocks);
  if (err != 0) return err;
  bn_fw_act_kernel<kResidual, kRelu><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(res), static_cast<uint4*>(y),
      mean, var, weight, bias, eps, vectors, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = act(x * scale + shift [+ res]) over `elements` bf16 values of channels_last
// tensors with C channels (a multiple of 8); every pointer 16-byte aligned, res null for
// the variants without the residual; weight and bias may be null (BatchNorm without an
// affine). The three variants: relu 1 with or without res, relu 0 without. Returns
// cudaGetLastError() after the launch (0 on success).
int simt_bn_act(const void* x, const void* res, void* y, const float* mean,
                const float* var, const float* weight, const float* bias, float eps,
                long long elements, int C, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C % kVec != 0 || elements % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (elements == 0) return 0;
  const long long vectors = elements / kVec;
  const int groups = C / kVec;
  if (res != nullptr && relu)
    return launch<true, true>(x, res, y, mean, var, weight, bias, eps, vectors, groups, s);
  if (res == nullptr && relu)
    return launch<false, true>(x, res, y, mean, var, weight, bias, eps, vectors, groups, s);
  if (res == nullptr && !relu)
    return launch<false, false>(x, res, y, mean, var, weight, bias, eps, vectors, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
