// Fused two-scale eval head for Hopper (sm_90a): align-corners upsample of both
// scales' stride-8 logits, sum, first-index argmax and the confusion histogram.
//
// Replaces: simt_tpu/ops/pallas/eval_fused.py::_kernel (launched by _rowblock_hist,
// wrapped by multiscale_argmax_hist). The TPU kernel applies the upsample as two dense
// f32 matmuls per output-row chunk and builds the histogram with one-hot matmuls. Here
// every row of the interpolation matrices has two non-zeros, so each output pixel is
// computed directly from at most 2x2 source logits per scale, with the weights read out
// of the same matrices on the host (interp_taps in simt_tpu_torch/ops/interp.py).
//
// Order of operations, as in the JAX package: H first, then W, then the sum of the
// two scales. Per source column w:  z[w,k] = w0h*x[lo_h,w,k] + w1h*x[hi_h,w,k]  (kept in
// shared memory for the block's current output row); per output pixel:
// out[k] = w0w*z[lo_w,k] + w1w*z[hi_w,k], pred[k] = out_a[k] + out_b[k]. Each two-term
// sum is one fmaf after a rounded product, the order of a sequential float32 dot.
// Argmax over k in ascending order with strict '>' (first index wins a tie, a NaN wins
// as in jnp.argmax). Pixels with gt outside [0, C) (255 included) are skipped.
//
// Histogram: one (C,C) int histogram per block in shared memory (shared atomicAdd),
// added once into the global (C,C) int32 output with integer atomicAdd at block end.
// Integer atomics commute, so the result does not depend on block order.
//
// Bound on an H100 SXM (1024x2048 output, 65x129 and 81x161 logits, C = 19): the
// inputs are gt as int32 (8.4 MB), the logits (1.6 MB) and the tap tables (0.1 MB),
// about 10.1 MB, 3.0 us at 3.35 TB/s. The arithmetic is 3 flops per (source column,
// class) per output row for the H step (17 M) plus, per counted pixel, 6C for the two
// W steps, C for the scale sum and C compares (152 at C = 19; 319 M if every pixel
// counts): about 0.34 G float32 operations, 5.0 us at 67 TFLOP/s. So operations bound
// it. The dense form of the TPU kernel would need about 24 GFLOP; this design does the
// two-tap arithmetic only, reads gt once, coalesced, and never writes the upsampled
// logits anywhere. Grid: (ceil(H / kRowsPerBlock), batch), kThreads threads a block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ float two_tap(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w1, x1, __fmul_rn(w0, x0));
}

// taps_i: int32 [scale a: lo(L), hi(L) | scale b: lo(L), hi(L)], L = H + W, rows first
// then columns; taps_f: float32 weights [a: w0(L), w1(L) | b: w0(L), w1(L)].
__global__ void __launch_bounds__(kThreads) eval_fused_hist_kernel(
    const float* __restrict__ la, const float* __restrict__ lb,
    const int* __restrict__ gt, const int* __restrict__ taps_i,
    const float* __restrict__ taps_f, int* __restrict__ hist,
    int ha, int wa, int hb, int wb, int H, int W, int C) {
  extern __shared__ float smem[];
  float* za = smem;                              // wa * C
  float* zb = za + wa * C;                       // wb * C
  int* sh_hist = reinterpret_cast<int*>(zb + wb * C);  // C * C

  const int L = H + W;
  const int* lo_a = taps_i;
  const int* hi_a = taps_i + L;
  const int* lo_b = taps_i + 2 * L;
  const int* hi_b = taps_i + 3 * L;
  const float* w0_a = taps_f;
  const float* w1_a = taps_f + L;
  const float* w0_b = taps_f + 2 * L;
  const float* w1_b = taps_f + 3 * L;

  const int n = blockIdx.y;
  const float* xa = la + static_cast<size_t>(n) * ha * wa * C;
  const float* xb = lb + static_cast<size_t>(n) * hb * wb * C;
  const int* g = gt + static_cast<size_t>(n) * H * W;

  for (int i = threadIdx.x; i < C * C; i += blockDim.x) sh_hist[i] = 0;

  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, H);
  for (int r = row0; r < row_end; ++r) {
    __syncthreads();  // the previous row's readers of za/zb are done
    {
      const float* x0 = xa + static_cast<size_t>(lo_a[r]) * wa * C;
      const float* x1 = xa + static_cast<size_t>(hi_a[r]) * wa * C;
      const float w0 = w0_a[r], w1 = w1_a[r];
      for (int i = threadIdx.x; i < wa * C; i += blockDim.x)
        za[i] = two_tap(w0, x0[i], w1, x1[i]);
    }
    {
      const float* x0 = xb + static_cast<size_t>(lo_b[r]) * wb * C;
      const float* x1 = xb + static_cast<size_t>(hi_b[r]) * wb * C;
      const float w0 = w0_b[r], w1 = w1_b[r];
      for (int i = threadIdx.x; i < wb * C; i += blockDim.x)
        zb[i] = two_tap(w0, x0[i], w1, x1[i]);
    }
    __syncthreads();

    const int* grow = g + static_cast<size_t>(r) * W;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int label = grow[c];
      if (label < 0 || label >= C) continue;
      const float* a0 = za + lo_a[H + c] * C;
      const float* a1 = za + hi_a[H + c] * C;
      const float u0 = w0_a[H + c], u1 = w1_a[H + c];
      const float* b0 = zb + lo_b[H + c] * C;
      const float* b1 = zb + hi_b[H + c] * C;
      const float v0 = w0_b[H + c], v1 = w1_b[H + c];
      float best = __fadd_rn(two_tap(u0, a0[0], u1, a1[0]), two_tap(v0, b0[0], v1, b1[0]));
      int arg = 0;
      for (int k = 1; k < C; ++k) {
        const float v = __fadd_rn(two_tap(u0, a0[k], u1, a1[k]),
                                  two_tap(v0, b0[k], v1, b1[k]));
        if (v > best || (v != v && best == best)) {
          best = v;
          arg = k;
        }
      }
      atomicAdd(&sh_hist[label * C + arg], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
    const int v = sh_hist[i];
    if (v) atomicAdd(&hist[i], v);
  }
}

}  // namespace

extern "C" {

// Adds the histogram of `batch` images into hist (C*C int32, zeroed by the caller).
// Returns cudaGetLastError() after the launch (0 on success).
int simt_eval_fused_hist(const float* la, const float* lb, const int* gt,
                         const int* taps_i, const float* taps_f, int* hist, int batch,
                         int ha, int wa, int hb, int wb, int H, int W, int C,
                         void* stream) {
  const size_t smem = static_cast<size_t>(wa + wb) * C * sizeof(float) +
                      static_cast<size_t>(C) * C * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eval_fused_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  eval_fused_hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      la, lb, gt, taps_i, taps_f, hist, ha, wa, hb, wb, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
