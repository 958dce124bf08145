// Fused two-scale eval head for Hopper (sm_90a): align-corners upsample of both
// scales' stride-8 logits, sum, first-index argmax and the confusion histogram.
//
// Replaces: simt_tpu/ops/pallas/eval_fused.py::_kernel (launched by _rowblock_hist,
// wrapped by multiscale_argmax_hist and multiscale_argmax_hist_spatial). The TPU kernel
// applies the upsample as two dense f32 matmuls per output-row chunk and builds the
// histogram with one-hot matmuls. Here every row of the interpolation matrices has two
// non-zeros, so each output pixel is computed directly from at most 2x2 source logits
// per scale, with the weights read out of the same matrices on the host (interp_taps in
// simt_tpu_torch/ops/interp.py).
//
// Order of operations, as in the JAX package: H first, then W, then the sum of the
// two scales. Per source column w:  z[w,k] = w0h*x[lo_h,w,k] + w1h*x[hi_h,w,k];  per
// output pixel: out[k] = w0w*z[lo_w,k] + w1w*z[hi_w,k], pred[k] = out_a[k] + out_b[k].
// Each two-term sum is one fmaf after a rounded product, the order of a sequential
// float32 dot. The argmax takes the first index of the maximum, and the first NaN if
// there is one (jnp.argmax). Pixels with gt outside [0, C) (255 included) are skipped.
// The first port's kernel did the same arithmetic, so the two histograms are equal bit
// for bit.
//
// Work: a block table from ops/kernels/eval_fused.py::schedule, one row a block: a band
// of at most 8 output rows (reading at most 3 source rows of each scale) by a segment
// of at most 512 output columns, one thread a column. At 1024x2048 that is 132 bands x
// 4 segments = 528 blocks of 512 threads: two whole waves of two blocks an SM (32
// warps an SM; 64 registers a thread). A block
//   1. writes each output row's H taps into shared memory and copies its gt tile there
//      (16-byte cp.async where rows allow; uint8 or int32 gt, read as bytes), while each
//      thread loads its H-step slots' source values into registers: a slot is one
//      (scale, source column, class), read at the band's source rows;
//   2. forms z for every output row of the band from those registers, with C padded to
//      CP floats a column, so a tap's channels load as CP/4 float4s; and notes whether
//      any z is NaN, inf or large enough to overflow a sum (`wild`);
//   3. runs its pixels: the W step, the scale sum, a tree argmax (depth log2 CP, not C
//      dependent steps; the NaN rule only in a wild block and only for a pixel whose
//      values sum to NaN, which every pixel holding a NaN does), then one shared
//      atomicAdd a pixel into a histogram private to its warp;
//   4. sums its warps' histograms in a fixed order and adds each non-zero bin into the
//      caller's (C, C) int32 histogram with one integer atomicAdd. Integer adds
//      commute, so the result does not depend on block order. The kernel is the only
//      device operation of a call: the caller's histogram is accumulated in place.
// Measured on an H100 (tools/bench_eval_fused.py): lanes grouped by bin with
// __match_any_sync before one add a group, or by runs of equal bins, were slower than
// one shared atomic a pixel on every gt map, region-shaped ones included; so were
// source rows staged in shared memory, and a warp forming its own z (no block barrier).
//
// Bound on an H100 SXM (1024x2048 output, 65x129 and 81x161 logits, C = 19). Bytes:
// gt as uint8 (2.1 MB; 8.4 MB as int32), the logits (1.6 MB), the tap tables and the
// block table (0.03 MB): about 3.7 MB, 1.1 us at 3.35 TB/s (3.0 us with int32 gt).
// Operations: 3 flops per (source column, class) per output row for the H step (17 M),
// plus, per counted pixel, 6C for the two W steps, C for the scale sum and C compares
// (152 at C = 19): 0.336 G float32 operations, 5.0 us at 67 TFLOP/s, if every pixel
// counts; on the timed iid map (20% of gt 255 and 5 of 24 labels >= C, 63% counted)
// 0.219 G, 3.27 us. So operations bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // ops/kernels/eval_fused.py::THREADS
// One block-table row (ops/kernels/eval_fused.py::BLOCK_FIELDS): output rows [r0, r1),
// columns [c0, c1); the source rows [ia0, ia1] and columns [ja0, ja1] of scale a it
// reads, and [ib0, ib1], [jb0, jb1] of scale b.
constexpr int kFields = 12;
constexpr int kSlots = 3;  // H-step slots a thread loads at once

struct Geometry {
  int ha, wa, hb, wb, H, W, C;
  int band;      // most output rows of a block
  int xca, xcb;  // most source columns of scale a / b a block reads
  int gt_vec;    // gt rows and segment starts allow 16-byte copies
};

// Shared memory of a block, in bytes from its start; mirrored by
// ops/kernels/eval_fused.py::smem_bytes (the wrapper passes its total, checked here).
struct Layout {
  int za, zb, hist, rowp, gt, total;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

template <int CP>
__host__ __device__ inline Layout layout(const Geometry& g, int threads) {
  Layout l;
  l.za = 0;
  l.zb = l.za + round16(g.band * g.xca * CP * 4);
  l.hist = l.zb + round16(g.band * g.xcb * CP * 4);
  l.rowp = l.hist + round16((threads / 32) * g.C * g.C * 4);
  l.gt = l.rowp + round16(2 * g.band * 16);
  l.total = l.gt + round16(g.band * threads);
  return l;
}

__device__ __forceinline__ float two_tap(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w1, x1, __fmul_rn(w0, x0));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (value, index) pairs are combined left to right, lower indices on the left: the right
// one wins if it is strictly greater or, with kNan, if it is NaN and the left is not.
// This is associative, so any bracketing in index order gives what a serial strict '>'
// scan (with the NaN rule: the first NaN wins) gives.
template <bool kNan>
__device__ __forceinline__ void combine(float& v, int& a, float rv, int ra) {
  const bool take = kNan ? (rv > v || (rv != rv && v == v)) : rv > v;
  v = take ? rv : v;
  a = take ? ra : a;
}

// The argmax of one pixel from the z rows of both scales. Channels at or above C are
// -inf: they never win. With kSum, `sum` returns the sum of all CP values, NaN if one
// is NaN (or if one is +inf: the caller then takes the NaN rule, which gives the same
// index).
template <int CP, int CC, bool kNan, bool kSum>
__device__ __forceinline__ int pixel_argmax(const float* pa0, const float* pa1,
                                            const float* pb0, const float* pb1, float u0,
                                            float u1, float v0, float v1, int c_rt,
                                            float& sum) {
  const int C = CC ? CC : c_rt;
  float best = 0.f;
  int arg = 0;
  sum = 0.f;
#pragma unroll
  for (int q = 0; q < CP / 4; ++q) {
    const float4 a0 = reinterpret_cast<const float4*>(pa0)[q];
    const float4 a1 = reinterpret_cast<const float4*>(pa1)[q];
    const float4 b0 = reinterpret_cast<const float4*>(pb0)[q];
    const float4 b1 = reinterpret_cast<const float4*>(pb1)[q];
    const float xa0[4] = {a0.x, a0.y, a0.z, a0.w}, xa1[4] = {a1.x, a1.y, a1.z, a1.w};
    const float xb0[4] = {b0.x, b0.y, b0.z, b0.w}, xb1[4] = {b1.x, b1.y, b1.z, b1.w};
    float v[4];
    int a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      a[i] = k;
      v[i] = k < C ? __fadd_rn(two_tap(u0, xa0[i], u1, xa1[i]),
                               two_tap(v0, xb0[i], v1, xb1[i]))
                   : -INFINITY;
    }
    if (kSum) sum = __fadd_rn(sum, __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])));
    combine<kNan>(v[0], a[0], v[1], a[1]);
    combine<kNan>(v[2], a[2], v[3], a[3]);
    combine<kNan>(v[0], a[0], v[2], a[2]);
    if (q == 0) {
      best = v[0];
      arg = a[0];
    } else {
      combine<kNan>(best, arg, v[0], a[0]);
    }
  }
  return arg;
}

// The block-table row `blockIdx.x` of image `blockIdx.y`; adds its histogram into hist.
// taps_i: int32 [scale a: lo(L), hi(L) | scale b: lo(L), hi(L)], L = H + W, rows first
// then columns; taps_f: float32 weights [a: w0(L), w1(L) | b: w0(L), w1(L)].
template <int CP, int CC, typename GT>
__global__ void __launch_bounds__(kMaxThreads, 2) eval_fused_hist_kernel(
    const float* __restrict__ la, const float* __restrict__ lb, const GT* __restrict__ gt,
    const int* __restrict__ taps_i, const float* __restrict__ taps_f,
    const int* __restrict__ blocks, int* __restrict__ hist, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CC ? CC : g.C;
  const int threads = blockDim.x;
  const Layout sl = layout<CP>(g, threads);
  float* za = reinterpret_cast<float*>(smem + sl.za);
  float* zb = reinterpret_cast<float*>(smem + sl.zb);
  int* wh_all = reinterpret_cast<int*>(smem + sl.hist);
  int4* rowp = reinterpret_cast<int4*>(smem + sl.rowp);
  unsigned char* gts = smem + sl.gt;

  const int H = g.H, W = g.W, L = H + W;
  const int* lo_a = taps_i;
  const int* hi_a = taps_i + L;
  const int* lo_b = taps_i + 2 * L;
  const int* hi_b = taps_i + 3 * L;
  const float* w0_a = taps_f;
  const float* w1_a = taps_f + L;
  const float* w0_b = taps_f + 2 * L;
  const float* w1_b = taps_f + 3 * L;

  const int* blk = blocks + blockIdx.x * kFields;
  const int r0 = blk[0], r1 = blk[1], c0 = blk[2], c1 = blk[3];
  const int ia0 = blk[4], ia1 = blk[5], ja0 = blk[6], ja1 = blk[7];
  const int ib0 = blk[8], ib1 = blk[9], jb0 = blk[10], jb1 = blk[11];
  const int rows = r1 - r0, cols = c1 - c0;
  const int na = ja1 - ja0 + 1, nb = jb1 - jb0 + 1;
  const int t = threadIdx.x;

  const int n = blockIdx.y;
  const float* xa = la + static_cast<size_t>(n) * g.ha * g.wa * C;
  const float* xb = lb + static_cast<size_t>(n) * g.hb * g.wb * C;
  const GT* gimg = gt + static_cast<size_t>(n) * H * W;

  // 1. Stage: each output row's H taps as {lo, hi rows from the band's first source
  //    row, w0, w1} (scale a in rowp[0, rows), scale b in rowp[rows, 2 rows)), the gt
  //    tile (one byte a pixel: the label if it is in [0, C), else 255; 16-byte copies
  //    where rows allow), and, in registers, each thread's first H-step slots' source
  //    values (below), whose loads stay in flight across the barrier.
  if (t < 2 * rows) {
    const bool sa = t < rows;
    const int r = r0 + (sa ? t : t - rows), i0 = sa ? ia0 : ib0;
    rowp[t] = make_int4(__ldg((sa ? lo_a : lo_b) + r) - i0,
                        __ldg((sa ? hi_a : hi_b) + r) - i0,
                        __float_as_int(__ldg((sa ? w0_a : w0_b) + r)),
                        __float_as_int(__ldg((sa ? w1_a : w1_b) + r)));
  }
  // H-step slots: (scale, column, class), e in [0, slots), scale b after na * C; each
  // thread takes kSlots of them (t, t + threads, ...) a round, with their values at the
  // band's source rows (at most 3, the schedule's bound) in x.
  const int slots = (na + nb) * C;
  float x[kSlots][3];
  auto load = [&](int base) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = base + t + s * threads;
      if (e >= slots) continue;
      const bool sa = e < na * C;
      const float* p = sa ? xa + (static_cast<size_t>(ia0) * g.wa + ja0) * C + e
                          : xb + (static_cast<size_t>(ib0) * g.wb + jb0) * C + (e - na * C);
      const size_t xrow = static_cast<size_t>(sa ? g.wa : g.wb) * C;
      const int ns = sa ? ia1 - ia0 + 1 : ib1 - ib0 + 1;
      x[s][0] = __ldg(p);
      x[s][1] = ns > 1 ? __ldg(p + xrow) : 0.f;
      x[s][2] = ns > 2 ? __ldg(p + 2 * xrow) : 0.f;
    }
  };
  load(0);
  if (sizeof(GT) == 1 && g.gt_vec) {
    const int chunks = cols / 16;  // cols is a multiple of 16 here
    for (int e = t; e < rows * chunks; e += threads) {
      const int rr = e / chunks, q = e - rr * chunks;
      cp_async16(gts + rr * threads + 16 * q,
                 gimg + static_cast<size_t>(r0 + rr) * W + c0 + 16 * q);
    }
  } else if (sizeof(GT) == 4 && g.gt_vec) {
    const int chunks = cols / 4;  // cols is a multiple of 4 here
    for (int e = t; e < rows * chunks; e += threads) {
      const int rr = e / chunks, q = e - rr * chunks;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          gimg + static_cast<size_t>(r0 + rr) * W + c0 + 4 * q));
      const int lab[4] = {v.x, v.y, v.z, v.w};
      unsigned packed = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned b = static_cast<unsigned>(lab[i]) < static_cast<unsigned>(C)
                               ? static_cast<unsigned>(lab[i]) : 255u;
        packed |= b << (8 * i);
      }
      *reinterpret_cast<unsigned*>(gts + rr * threads + 4 * q) = packed;
    }
  } else {
    for (int e = t; e < rows * cols; e += threads) {
      const int rr = e / cols, cc = e - rr * cols;
      const long long v =
          static_cast<long long>(gimg[static_cast<size_t>(r0 + rr) * W + c0 + cc]);
      gts[rr * threads + cc] = (v >= 0 && v < C) ? static_cast<unsigned char>(v) : 255;
    }
  }
  for (int e = t; e < (threads / 32) * C * C; e += threads) wh_all[e] = 0;
  cp_async_wait_all();
  __syncthreads();

  // 2. H step: z[rr][j][k] of both scales for every output row of the band, from the
  //    slots' source values; every row of a slot. Channels C..CP-1 are never written:
  //    no pixel uses them. `wild` is set if a z is NaN, inf or above 2^125 in
  //    magnitude: only then can a pixel's value be NaN (each W step is a convex
  //    combination, so |pred| <= ~2 max|z| < FLT_MAX otherwise), and only then do the
  //    pixels check for NaN.
  bool wild = false;
  for (int base = 0; base < slots; base += kSlots * threads) {
    if (base) load(base);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = base + t + s * threads;
      if (e >= slots) continue;
      const bool sa = e < na * C;
      const int jk = sa ? e : e - na * C;  // j * C + k
      float* z = (sa ? za : zb) + jk + (jk / C) * (CP - C);  // j * CP + k
      const int zrow = (sa ? g.xca : g.xcb) * CP;
      const int4* rp = rowp + (sa ? 0 : rows);
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr) {
        const int4 p = rp[rr];
        const float lo = p.x == 0 ? x[s][0] : (p.x == 1 ? x[s][1] : x[s][2]);
        const float hi = p.y == 0 ? x[s][0] : (p.y == 1 ? x[s][1] : x[s][2]);
        const float v = two_tap(__int_as_float(p.z), lo, __int_as_float(p.w), hi);
        wild |= !(fabsf(v) <= 0x1p125f);
        z[rr * zrow] = v;
      }
    }
  }
  wild = __syncthreads_or(wild);

  // 3. Pixels: one column a thread, every row of the band.
  int* wh = wh_all + (t >> 5) * C * C;
  const int c = c0 + t;
  const bool col = t < cols;
  int oa0 = 0, oa1 = 0, ob0 = 0, ob1 = 0;
  float u0 = 0.f, u1 = 0.f, v0 = 0.f, v1 = 0.f;
  if (col) {
    oa0 = (__ldg(lo_a + H + c) - ja0) * CP;
    oa1 = (__ldg(hi_a + H + c) - ja0) * CP;
    ob0 = (__ldg(lo_b + H + c) - jb0) * CP;
    ob1 = (__ldg(hi_b + H + c) - jb0) * CP;
    u0 = __ldg(w0_a + H + c);
    u1 = __ldg(w1_a + H + c);
    v0 = __ldg(w0_b + H + c);
    v1 = __ldg(w1_b + H + c);
  }
  for (int rr = 0; rr < rows; ++rr) {
    const int label = col ? gts[rr * threads + t] : 255;
    if (label < C) {
      const float* pa = za + rr * g.xca * CP;
      const float* pb = zb + rr * g.xcb * CP;
      float sum = 0.f;
      int arg;
      if (!wild) {
        arg = pixel_argmax<CP, CC, false, false>(pa + oa0, pa + oa1, pb + ob0, pb + ob1, u0,
                                                 u1, v0, v1, C, sum);
      } else {
        arg = pixel_argmax<CP, CC, false, true>(pa + oa0, pa + oa1, pb + ob0, pb + ob1, u0,
                                                u1, v0, v1, C, sum);
        if (sum != sum)
          arg = pixel_argmax<CP, CC, true, false>(pa + oa0, pa + oa1, pb + ob0, pb + ob1, u0,
                                                  u1, v0, v1, C, sum);
      }
      atomicAdd(wh + label * C + arg, 1);
    }
  }
  __syncthreads();

  // 4. The warps' histograms in order, then one atomicAdd a non-zero bin.
  for (int i = t; i < C * C; i += threads) {
    int s = 0;
    for (int w = 0; w < threads / 32; ++w) s += wh_all[w * C * C + i];
    if (s) atomicAdd(hist + i, s);
  }
}

template <int CP, int CC, typename GT>
int launch(const float* la, const float* lb, const void* gt, const int* taps_i,
           const float* taps_f, const int* blocks, int n_blocks, int* hist, int batch,
           const Geometry& g, int threads, int smem, cudaStream_t stream) {
  if (layout<CP>(g, threads).total != smem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = eval_fused_hist_kernel<CP, CC, GT>;
  static int allowed = 48 * 1024;  // the dynamic shared memory this kernel may take
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  kernel<<<dim3(n_blocks, batch), threads, smem, stream>>>(
      la, lb, static_cast<const GT*>(gt), taps_i, taps_f, blocks, hist, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Adds the histogram of the block table's rows of `batch` images into hist (C*C int32,
// the caller's running histogram). gt is uint8 (gt_bytes 1) or int32 (4). cp is the
// channel padding the wrapper chose: 20 for C = 19, else 32 (C <= 32). Returns
// cudaGetLastError() after the launch (0 on success).
int simt_eval_fused_hist(const float* la, const float* lb, const void* gt, int gt_bytes,
                         const int* taps_i, const float* taps_f, const int* blocks,
                         int n_blocks, int* hist, int batch, int ha, int wa, int hb, int wb,
                         int H, int W, int C, int cp, int band, int xca,
                         int xcb, int gt_vec, int threads, int smem, void* stream) {
  const Geometry g{ha, wa, hb, wb, H, W, C, band, xca, xcb, gt_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads % 32 || threads > kMaxThreads || (gt_bytes != 1 && gt_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cp == 20 && C == 19)
    return gt_bytes == 1
               ? launch<20, 19, uint8_t>(la, lb, gt, taps_i, taps_f, blocks, n_blocks, hist,
                                         batch, g, threads, smem, s)
               : launch<20, 19, int32_t>(la, lb, gt, taps_i, taps_f, blocks, n_blocks, hist,
                                         batch, g, threads, smem, s);
  if (cp == 32 && C <= 32)
    return gt_bytes == 1
               ? launch<32, 0, uint8_t>(la, lb, gt, taps_i, taps_f, blocks, n_blocks, hist,
                                        batch, g, threads, smem, s)
               : launch<32, 0, int32_t>(la, lb, gt, taps_i, taps_f, blocks, n_blocks, hist,
                                        batch, g, threads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
