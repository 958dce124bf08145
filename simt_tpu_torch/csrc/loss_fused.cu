// The SimT streamed loss core for Hopper (sm_90a): forward (kernel B2) and backward
// (kernel B3) of the per-pixel losses of both heads at full resolution.
//
// Replaces: experiments/pallas_alternates/loss_fused.py::_fwd_kernel (launched by
// _core_fwd_call, wrapped by simt_loss_core_pallas) and ::_bwd_kernel (launched by
// _loss_core_bwd), the VMEM-resident twin of the lax.scan core of
// simt_tpu/ops/fused_losses.py::simt_loss_block. What each computes is documented in
// simt_tpu_torch/ops/kernels/loss_fused.py, whose plain PyTorch versions these kernels
// are held against.
//
// Design, against what the TPU kernel does:
//  - Upsample by taps. Every row of the align-corners matrices has two non-zeros, so a
//    block keeps one output row's H step z[w8][2*(C+O)] in shared memory and each
//    thread forms its pixel's logits from two columns of z. Each value is
//    w0*x0 + w1*x1 as two rounded products and one rounded add (no FMA contraction):
//    the plain version computes the same bits.
//  - Only one column of q = T^T softmax is needed: the picked posterior is
//    sum_k T[k, y] * sm[k], in ascending k; in the backward dq is one-hot, so
//    dT[:, y] += sm * dq and dsm = T[:, y] * dq.
//  - No carry across a sequential grid: each block streams its rows and writes
//    per-block partials; a second launch sums them in a fixed order (in double), so
//    the 16 sums and dT do not depend on block order. The anchor is a 64-bit atomicMax
//    of (order-preserving float bits << 32 | ~global index): the largest value, and
//    for equal values the smallest global batch-major index, whatever the order.
//    Presence is an atomicOr.
//  - dxcat: each backward block forms a tile of per-pixel cotangents in shared memory,
//    gathers them per source column (the transposed W taps, ascending column order)
//    into the row's dz[w8][2*(C+O)] and writes dz to a scratch buffer; a third launch
//    gathers each source row's contributing output rows in ascending order. dT is the
//    one place with float atomics: a block's threads add their pixels' sm * dq into a
//    shared-memory dT with atomicAdd, so its last bits may differ between runs; the
//    blocks' partials are then summed in a fixed order.
//  - All argmaxes take the first index (strict '>', ascending channel order); the
//    placeholder zeroes the argmax channel and takes its open-class argmax over a row
//    whose known channels are 0; a pixel is valid when its label is >= 0 and not the
//    ignore label. NaN logits are not given torch's NaN-wins argmax semantics.
//
// The per-pixel logits of both heads live in registers, so C+O is a template
// parameter (instantiated for 6, 8 and 34; the wrapper rejects others).
//
// Bound on an H100 SXM at the main path's shapes (xcat 1x65x129x68 f32, label
// 1x512x1024 int32, conf uint8, T 34x19; simt_tpu_torch/ops/kernels/loss_fused.py::
// work): the forward reads about 5.0 MB (1.5 us at 3.35 TB/s) and does about 0.62 G
// float32 operations (34 per pixel and channel: the W taps of both heads and, per head,
// the softmax, the suppressed softmax, the picked posterior and the argmaxes; 9.3 us at
// 67 TFLOP/s), so operations bound it; the backward moves about 7.4 MB and does about
// 1.3 G operations (19 us). Every exp and log counts as one operation, though the
// card's special-function units issue them at a quarter of the FMA rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kWarps = kFwdThreads / 32;

__device__ __forceinline__ float two_tap(float w0, float x0, float w1, float x1) {
  return __fadd_rn(__fmul_rn(w0, x0), __fmul_rn(w1, x1));
}

// Order-preserving map of a float's bits to an unsigned int, and back.
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ bool is_valid(int label, int ignore) {
  return label >= 0 && label != ignore;
}

// The wrapper's tables (loss_fused.py::device_tables).
struct Tables {
  const int* lo_h;
  const int* hi_h;
  const int* lo_w;
  const int* hi_w;
  const int* col_begin;
  const int* col_end;
  const int* row_begin;
  const int* row_end;
  const float* w0_h;
  const float* w1_h;
  const float* w0_w;
  const float* w1_w;
};

__device__ __forceinline__ Tables make_tables(const int* ti, const float* tf, int h8,
                                              int w8, int H, int W) {
  Tables t;
  t.lo_h = ti;
  t.hi_h = ti + H;
  t.lo_w = ti + 2 * H;
  t.hi_w = ti + 2 * H + W;
  t.col_begin = ti + 2 * H + 2 * W;
  t.col_end = t.col_begin + w8;
  t.row_begin = t.col_end + w8;
  t.row_end = t.row_begin + h8;
  t.w0_h = tf;
  t.w1_h = tf + H;
  t.w0_w = tf + 2 * H;
  t.w1_w = tf + 2 * H + W;
  return t;
}

// H step of output row r: z[j * CAT + ch] for every source column j.
template <int CAT>
__device__ __forceinline__ void h_step(const float* __restrict__ xb, const Tables& t,
                                       int r, int w8, float* z) {
  const float* x0 = xb + static_cast<size_t>(t.lo_h[r]) * w8 * CAT;
  const float* x1 = xb + static_cast<size_t>(t.hi_h[r]) * w8 * CAT;
  const float w0 = t.w0_h[r], w1 = t.w1_h[r];
  for (int i = threadIdx.x; i < w8 * CAT; i += blockDim.x) z[i] = two_tap(w0, x0[i], w1, x1[i]);
}

// W step of one head (channels off .. off + TOT) at one output column.
template <int TOT>
__device__ __forceinline__ void load_head(const float* z, int lo, int hi, float u0,
                                          float u1, int off, float (&p)[TOT]) {
  constexpr int CAT = 2 * TOT;
#pragma unroll
  for (int k = 0; k < TOT; ++k)
    p[k] = two_tap(u0, z[lo * CAT + off + k], u1, z[hi * CAT + off + k]);
}

template <int TOT>
__device__ __forceinline__ int argmax_first(const float (&p)[TOT], float& mx) {
  mx = p[0];
  int a = 0;
#pragma unroll
  for (int k = 1; k < TOT; ++k) {
    if (p[k] > mx) {
      mx = p[k];
      a = k;
    }
  }
  return a;
}

// p[r] for 0 <= r < TOT, else 0 (static register indices only).
template <int TOT>
__device__ __forceinline__ float pick(const float (&p)[TOT], int r) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < TOT; ++k)
    if (k == r) v = p[k];
  return v;
}

// What both directions need of one head at one pixel.
template <int TOT>
struct HeadPixel {
  float e[TOT];  // exp(p - max); divided by den into the softmax where needed
  float den, lz;
  float mxu, denu, lzu;  // the suppressed logits' softmax (placeholder unknown CE)
  int pseudo, known, place;
};

template <int TOT>
__device__ __forceinline__ void head_pixel(const float (&p)[TOT], int C, float th,
                                           int ignore, HeadPixel<TOT>& h) {
  float mx;
  h.pseudo = argmax_first(p, mx);
#pragma unroll
  for (int k = 0; k < TOT; ++k) h.e[k] = expf(__fsub_rn(p[k], mx));
  float den = h.e[0];
#pragma unroll
  for (int k = 1; k < TOT; ++k) den = __fadd_rn(den, h.e[k]);
  h.den = den;
  h.lz = __fadd_rn(mx, logf(den));
  const float pred_max = __fdiv_rn(1.f, den);
  h.known = (h.pseudo < C && pred_max > th) ? h.pseudo : ignore;

  // Suppressed logits: the argmax channel set to 0 (trainV2_simt.py:205-209).
  float mxu = (h.pseudo == 0) ? 0.f : p[0];
#pragma unroll
  for (int k = 1; k < TOT; ++k) {
    const float v = (k == h.pseudo) ? 0.f : p[k];
    if (v > mxu) mxu = v;
  }
  float denu = expf(__fsub_rn((h.pseudo == 0) ? 0.f : p[0], mxu));
#pragma unroll
  for (int k = 1; k < TOT; ++k)
    denu = __fadd_rn(denu, expf(__fsub_rn((k == h.pseudo) ? 0.f : p[k], mxu)));
  h.mxu = mxu;
  h.denu = denu;
  h.lzu = __fadd_rn(mxu, logf(denu));
  // Open-class argmax over a row whose known channels are 0 (:219-223).
  float best = 0.f;
  int arg = 0;
#pragma unroll
  for (int k = 0; k < TOT; ++k) {
    if (k >= C) {
      const float v = (k == h.pseudo) ? 0.f : p[k];
      if (v > best) {
        best = v;
        arg = k;
      }
    }
  }
  h.place = (h.known == ignore) ? ignore : arg;
}

// sum_k T[k, y] * sm[k] in ascending k (the picked noisy posterior).
template <int TOT>
__device__ __forceinline__ float picked_posterior(const HeadPixel<TOT>& h,
                                                  const float* __restrict__ T, int C,
                                                  int y) {
  float acc = __fmul_rn(T[y], __fdiv_rn(h.e[0], h.den));
#pragma unroll
  for (int k = 1; k < TOT; ++k)
    acc = __fadd_rn(acc, __fmul_rn(T[k * C + y], __fdiv_rn(h.e[k], h.den)));
  return acc;
}

// ------------------------------------------------------------------------------------
// Forward (B2)
// ------------------------------------------------------------------------------------

template <int TOT>
__device__ __forceinline__ void head_forward(const float (&p)[TOT], int refined, int y,
                                             const float* __restrict__ T, int C,
                                             float th, int ignore, unsigned int gidx,
                                             float (&acc)[8],
                                             unsigned long long* sh_keys,
                                             int* sh_pres) {
  HeadPixel<TOT> h;
  head_pixel(p, C, th, ignore, h);
  if (is_valid(refined, ignore)) {
    acc[0] += __fsub_rn(h.lz, pick(p, refined));
    acc[1] += 1.f;
  }
  if (is_valid(h.known, ignore)) {
    acc[2] += __fsub_rn(h.lz, pick(p, h.known));
    acc[3] += 1.f;
  }
  if (is_valid(h.place, ignore)) {
    const float v = (h.place == h.pseudo) ? 0.f : pick(p, h.place);
    acc[4] += __fsub_rn(h.lzu, v);
    acc[5] += 1.f;
  }
  if (is_valid(y, ignore)) {
    const float picked = (y < C) ? picked_posterior(h, T, C, y) : 0.f;
    acc[6] += -logf(picked);
    acc[7] += 1.f;
  }
  // Anchor: the running maximum per channel, first global index on a tie.
  volatile unsigned long long* seen = sh_keys;
  const unsigned long long low = static_cast<unsigned long long>(0xffffffffu - gidx);
#pragma unroll
  for (int k = 0; k < TOT; ++k) {
    const unsigned long long key =
        (static_cast<unsigned long long>(ordered_bits(p[k])) << 32) | low;
    if (key > seen[k]) atomicMax(&sh_keys[k], key);
  }
  if (!sh_pres[h.pseudo]) sh_pres[h.pseudo] = 1;
}

template <int TOT>
__global__ void __launch_bounds__(kFwdThreads) loss_fwd_kernel(
    const float* __restrict__ xcat, const int* __restrict__ label,
    const unsigned char* __restrict__ conf, const float* __restrict__ t1,
    const float* __restrict__ t2, const int* __restrict__ taps_i,
    const float* __restrict__ taps_f, float* __restrict__ partials,
    unsigned long long* __restrict__ keys, int* __restrict__ presence, int h8, int w8,
    int H, int W, int C, float th, int ignore) {
  constexpr int CAT = 2 * TOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* sh_keys = reinterpret_cast<unsigned long long*>(smem_raw);  // 2*TOT
  int* sh_pres = reinterpret_cast<int*>(sh_keys + 2 * TOT);                       // 2*TOT
  float* sh_red = reinterpret_cast<float*>(sh_pres + 2 * TOT);                    // 16*warps
  float* z = sh_red + 16 * kWarps;                                                // w8*CAT

  const Tables tb = make_tables(taps_i, taps_f, h8, w8, H, W);
  const int b = blockIdx.y;
  const float* xb = xcat + static_cast<size_t>(b) * h8 * w8 * CAT;
  for (int i = threadIdx.x; i < 2 * TOT; i += blockDim.x) {
    sh_keys[i] = 0ull;
    sh_pres[i] = 0;
  }
  float acc1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float acc2[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int r = blockIdx.x; r < H; r += gridDim.x) {
    __syncthreads();  // the previous row's readers of z are done
    h_step<CAT>(xb, tb, r, w8, z);
    __syncthreads();
    const size_t row = (static_cast<size_t>(b) * H + r) * W;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int lo = tb.lo_w[c], hi = tb.hi_w[c];
      const float u0 = tb.w0_w[c], u1 = tb.w1_w[c];
      const int y = label[row + c];
      const int cf = conf[row + c];
      const unsigned int gidx = static_cast<unsigned int>(row + c);
      float p[TOT];
      // Head 2 first: its argmax refines the teacher label of both heads.
      load_head<TOT>(z, lo, hi, u0, u1, TOT, p);
      float mx2;
      const int pseudo2 = argmax_first(p, mx2);
      const int refined = (cf == C) ? (pseudo2 >= C ? pseudo2 : ignore) : cf;
      head_forward<TOT>(p, refined, y, t2, C, th, ignore, gidx, acc2, sh_keys + TOT,
                        sh_pres + TOT);
      load_head<TOT>(z, lo, hi, u0, u1, 0, p);
      head_forward<TOT>(p, refined, y, t1, C, th, ignore, gidx, acc1, sh_keys, sh_pres);
    }
  }

  // Block sums in a fixed order: warp shuffles, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float v = (i < 8) ? acc1[i] : acc2[i - 8];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh_red[warp * 16 + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh_red[w * 16 + threadIdx.x];
    partials[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 16 + threadIdx.x] = s;
  }
  for (int i = threadIdx.x; i < 2 * TOT; i += blockDim.x) {
    if (sh_keys[i]) atomicMax(&keys[i], sh_keys[i]);
    if (sh_pres[i]) atomicOr(&presence[i], 1);
  }
}

// One block of 256 threads: thread (i, s) sums partials s, s + 16, ... of sum i in
// double; thread i then adds the 16 slices in order.
__global__ void loss_fwd_finalize(const float* __restrict__ partials, int n_part,
                                  const unsigned long long* __restrict__ keys,
                                  const int* __restrict__ presence, int n_keys,
                                  float* __restrict__ sums, float* __restrict__ amax,
                                  int* __restrict__ aidx, float* __restrict__ pres) {
  __shared__ double slices[256];
  const int i = threadIdx.x & 15, s = threadIdx.x >> 4;
  double v = 0.0;
  for (int p = s; p < n_part; p += 16) v += partials[static_cast<size_t>(p) * 16 + i];
  slices[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < 16) {
    double t = 0.0;
    for (int k = 0; k < 16; ++k) t += slices[k * 16 + threadIdx.x];
    sums[threadIdx.x] = static_cast<float>(t);
  }
  for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
    const unsigned long long key = keys[k];
    amax[k] = key ? from_ordered_bits(static_cast<unsigned int>(key >> 32)) : -INFINITY;
    aidx[k] = key ? static_cast<int>(0xffffffffu - static_cast<unsigned int>(key)) : 0;
    pres[k] = presence[k] ? 1.f : 0.f;
  }
}

// ------------------------------------------------------------------------------------
// Backward (B3)
// ------------------------------------------------------------------------------------

// Cotangent of one head's logits at one pixel into dp[0 .. TOT); sm * dq into the
// block's shared dT (TOT x C) at column y.
template <int TOT>
__device__ __forceinline__ void head_backward(const float (&p)[TOT], int refined, int y,
                                              const float* __restrict__ T,
                                              const float* __restrict__ g, int C,
                                              float th, int ignore, float* dp,
                                              float* sh_dt) {
  HeadPixel<TOT> h;
  head_pixel(p, C, th, ignore, h);
  const float v_ce = is_valid(refined, ignore) ? 1.f : 0.f;
  const float v_kn = is_valid(h.known, ignore) ? 1.f : 0.f;
  const float v_un = is_valid(h.place, ignore) ? 1.f : 0.f;
  const bool has_y = is_valid(y, ignore) && y < C;
  float dq = 0.f, s = 0.f;
  if (has_y) {
    dq = -g[6] * (1.f / picked_posterior(h, T, C, y));
#pragma unroll
    for (int k = 0; k < TOT; ++k) s += T[k * C + y] * dq * (h.e[k] / h.den);
  }
#pragma unroll
  for (int k = 0; k < TOT; ++k) {
    const float sm = h.e[k] / h.den;
    float d = g[0] * (sm - (k == refined ? 1.f : 0.f)) * v_ce +
              g[2] * (sm - (k == h.known ? 1.f : 0.f)) * v_kn;
    if (k != h.pseudo) {
      const float smu = expf(p[k] - h.mxu) / h.denu;
      d += g[4] * (smu - (k == h.place ? 1.f : 0.f)) * v_un;
    }
    if (has_y) {
      d += sm * (T[k * C + y] * dq - s);
      atomicAdd(&sh_dt[k * C + y], sm * dq);
    }
    dp[k] = d;
  }
}

template <int TOT>
__global__ void __launch_bounds__(kBwdThreads) loss_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ xcat,
    const int* __restrict__ label, const unsigned char* __restrict__ conf,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const int* __restrict__ taps_i, const float* __restrict__ taps_f,
    float* __restrict__ dz_rows, float* __restrict__ dt_part, int h8, int w8, int H,
    int W, int C, float th, int ignore) {
  constexpr int CAT = 2 * TOT;
  constexpr int DP = CAT + 1;  // odd row stride of the cotangent tile: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sh_dt = reinterpret_cast<float*>(smem_raw);  // 2 * TOT * C
  float* z = sh_dt + 2 * TOT * C;                      // w8 * CAT
  float* dz = z + w8 * CAT;                            // w8 * CAT
  float* dp = dz + w8 * CAT;                           // kBwdThreads * DP

  const Tables tb = make_tables(taps_i, taps_f, h8, w8, H, W);
  const int b = blockIdx.y;
  const float* xb = xcat + static_cast<size_t>(b) * h8 * w8 * CAT;
  float g1[8], g2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    g1[i] = g[i];
    g2[i] = g[8 + i];
  }
  for (int i = threadIdx.x; i < 2 * TOT * C; i += blockDim.x) sh_dt[i] = 0.f;

  for (int r = blockIdx.x; r < H; r += gridDim.x) {
    __syncthreads();  // the previous row's readers of z and dz are done
    h_step<CAT>(xb, tb, r, w8, z);
    for (int i = threadIdx.x; i < w8 * CAT; i += blockDim.x) dz[i] = 0.f;
    __syncthreads();
    const size_t row = (static_cast<size_t>(b) * H + r) * W;
    for (int t0 = 0; t0 < W; t0 += kBwdThreads) {
      const int c = t0 + threadIdx.x;
      if (c < W) {
        const int lo = tb.lo_w[c], hi = tb.hi_w[c];
        const float u0 = tb.w0_w[c], u1 = tb.w1_w[c];
        const int y = label[row + c];
        const int cf = conf[row + c];
        float p[TOT];
        load_head<TOT>(z, lo, hi, u0, u1, TOT, p);
        float mx2;
        const int pseudo2 = argmax_first(p, mx2);
        const int refined = (cf == C) ? (pseudo2 >= C ? pseudo2 : ignore) : cf;
        float* mine = dp + threadIdx.x * DP;
        head_backward<TOT>(p, refined, y, t2, g2, C, th, ignore, mine + TOT,
                           sh_dt + TOT * C);
        load_head<TOT>(z, lo, hi, u0, u1, 0, p);
        head_backward<TOT>(p, refined, y, t1, g1, C, th, ignore, mine, sh_dt);
      }
      __syncthreads();
      // Transposed W taps: each (source column, channel) of the tile's range gathers
      // its output columns in ascending order.
      const int t1c = min(t0 + kBwdThreads, W);
      const int jlo = tb.lo_w[t0], jhi = tb.hi_w[t1c - 1];
      const int n_items = (jhi - jlo + 1) * CAT;
      for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
        const int j = jlo + it / CAT, ch = it % CAT;
        const int cb = max(tb.col_begin[j], t0), ce = min(tb.col_end[j], t1c);
        float v = 0.f;
        for (int cc = cb; cc < ce; ++cc) {
          const float d = dp[(cc - t0) * DP + ch];
          if (tb.lo_w[cc] == j) v += tb.w0_w[cc] * d;
          if (tb.hi_w[cc] == j) v += tb.w1_w[cc] * d;
        }
        dz[j * CAT + ch] += v;
      }
      __syncthreads();
    }
    float* out = dz_rows + (static_cast<size_t>(b) * H + r) * w8 * CAT;
    for (int i = threadIdx.x; i < w8 * CAT; i += blockDim.x) out[i] = dz[i];
  }
  __syncthreads();
  float* part = dt_part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 * TOT * C;
  for (int i = threadIdx.x; i < 2 * TOT * C; i += blockDim.x) part[i] = sh_dt[i];
}

// dT (2, TOT, C): each element sums the blocks' partials in order, in double.
__global__ void loss_bwd_finalize_dt(const float* __restrict__ dt_part, int n_part,
                                     int n, float* __restrict__ dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  int p = 0;
  for (; p + 4 <= n_part; p += 4) {
    a0 += dt_part[static_cast<size_t>(p) * n + i];
    a1 += dt_part[static_cast<size_t>(p + 1) * n + i];
    a2 += dt_part[static_cast<size_t>(p + 2) * n + i];
    a3 += dt_part[static_cast<size_t>(p + 3) * n + i];
  }
  for (; p < n_part; ++p) a0 += dt_part[static_cast<size_t>(p) * n + i];
  dt[i] = static_cast<float>((a0 + a1) + (a2 + a3));
}

// dxcat row i of image b: the transposed H taps over the output rows that read source
// row i, in ascending order. Every element of dxcat is written.
template <int CAT>
__global__ void loss_bwd_gather_rows(const float* __restrict__ dz_rows,
                                     const int* __restrict__ taps_i,
                                     const float* __restrict__ taps_f,
                                     float* __restrict__ dx, int h8, int w8, int H,
                                     int W) {
  const Tables tb = make_tables(taps_i, taps_f, h8, w8, H, W);
  const int i = blockIdx.x, b = blockIdx.y;
  const int rb = tb.row_begin[i], re = tb.row_end[i];
  const size_t n = static_cast<size_t>(w8) * CAT;
  float* out = dx + (static_cast<size_t>(b) * h8 + i) * n;
  for (size_t e = threadIdx.x; e < n; e += blockDim.x) {
    float v = 0.f;
    for (int r = rb; r < re; ++r) {
      const float d = dz_rows[(static_cast<size_t>(b) * H + r) * n + e];
      if (tb.lo_h[r] == i) v += tb.w0_h[r] * d;
      if (tb.hi_h[r] == i) v += tb.w1_h[r] * d;
    }
    out[e] = v;
  }
}

// Blocks in the grid's x dimension for one image: as many as fit on the card at once
// (each block streams rows r = blockIdx.x, blockIdx.x + gridDim.x, ...).
template <typename K>
cudaError_t grid_rows(K kernel, int threads, size_t smem, int H, int batch, int* rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // too much shared memory
  const int g = (per_sm * sms + batch - 1) / batch;
  *rows = g < H ? g : H;
  return cudaSuccess;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TOT>
int launch_fwd(const float* xcat, const int* label, const unsigned char* conf,
               const float* t1, const float* t2, const int* taps_i, const float* taps_f,
               float* partials, unsigned long long* keys, int* presence, float* sums,
               float* amax, int* aidx, float* pres, int batch, int h8, int w8, int H,
               int W, int C, float th, int ignore, cudaStream_t stream) {
  constexpr int CAT = 2 * TOT;
  const size_t smem = 2 * TOT * (sizeof(unsigned long long) + sizeof(int)) +
                      16 * kWarps * sizeof(float) +
                      static_cast<size_t>(w8) * CAT * sizeof(float);
  cudaError_t e = allow_smem(loss_fwd_kernel<TOT>, smem);
  if (e != cudaSuccess) return e;
  int rows = 0;
  e = grid_rows(loss_fwd_kernel<TOT>, kFwdThreads, smem, H, batch, &rows);
  if (e != cudaSuccess) return e;
  loss_fwd_kernel<TOT><<<dim3(rows, batch), kFwdThreads, smem, stream>>>(
      xcat, label, conf, t1, t2, taps_i, taps_f, partials, keys, presence, h8, w8, H, W,
      C, th, ignore);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  loss_fwd_finalize<<<1, 256, 0, stream>>>(partials, rows * batch, keys, presence,
                                           2 * TOT, sums, amax, aidx, pres);
  return cudaGetLastError();
}

template <int TOT>
int launch_bwd(const float* g, const float* xcat, const int* label,
               const unsigned char* conf, const float* t1, const float* t2,
               const int* taps_i, const float* taps_f, float* dz_rows, float* dt_part,
               float* dx, float* dt, int batch, int h8, int w8, int H, int W, int C,
               float th, int ignore, cudaStream_t stream) {
  constexpr int CAT = 2 * TOT;
  const size_t smem = (2 * TOT * C + 2 * static_cast<size_t>(w8) * CAT +
                       kBwdThreads * (CAT + 1)) * sizeof(float);
  cudaError_t e = allow_smem(loss_bwd_kernel<TOT>, smem);
  if (e != cudaSuccess) return e;
  int rows = 0;
  e = grid_rows(loss_bwd_kernel<TOT>, kBwdThreads, smem, H, batch, &rows);
  if (e != cudaSuccess) return e;
  loss_bwd_kernel<TOT><<<dim3(rows, batch), kBwdThreads, smem, stream>>>(
      g, xcat, label, conf, t1, t2, taps_i, taps_f, dz_rows, dt_part, h8, w8, H, W, C,
      th, ignore);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = 2 * TOT * C;
  loss_bwd_finalize_dt<<<(n + 127) / 128, 128, 0, stream>>>(dt_part, rows * batch, n,
                                                             dt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  loss_bwd_gather_rows<CAT><<<dim3(h8, batch), 256, 0, stream>>>(dz_rows, taps_i, taps_f,
                                                                 dx, h8, w8, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward of the loss core. partials: >= batch*H*16 floats of scratch; keys
// (2*TOT uint64) and presence (2*TOT int32) zeroed by the caller. Outputs: sums
// (2, 8), amax / aidx / pres (2, TOT). Returns cudaGetLastError() after the launches
// (0 on success), cudaErrorInvalidValue for a C+O it is not compiled for.
int simt_loss_core_fwd(const float* xcat, const int* label, const unsigned char* conf,
                       const float* t1, const float* t2, const int* taps_i,
                       const float* taps_f, float* partials, unsigned long long* keys,
                       int* presence, float* sums, float* amax, int* aidx, float* pres,
                       int batch, int h8, int w8, int H, int W, int C, int TOT, float th,
                       int ignore, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMT_FWD(N)                                                                  \
  case N:                                                                            \
    return launch_fwd<N>(xcat, label, conf, t1, t2, taps_i, taps_f, partials, keys,  \
                         presence, sums, amax, aidx, pres, batch, h8, w8, H, W, C, th, \
                         ignore, s);
  switch (TOT) {
    SIMT_FWD(6)
    SIMT_FWD(8)
    SIMT_FWD(34)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIMT_FWD
}

// Backward of the loss core for the cotangent g (2, 8) of the sums. dz_rows:
// batch*H*w8*2*TOT floats and dt_part: >= batch*H*2*TOT*C floats of scratch. Outputs:
// dx (batch, h8, w8, 2*TOT), dt (2, TOT, C). Returns as simt_loss_core_fwd.
int simt_loss_core_bwd(const float* g, const float* xcat, const int* label,
                       const unsigned char* conf, const float* t1, const float* t2,
                       const int* taps_i, const float* taps_f, float* dz_rows,
                       float* dt_part, float* dx, float* dt, int batch, int h8, int w8,
                       int H, int W, int C, int TOT, float th, int ignore,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMT_BWD(N)                                                                   \
  case N:                                                                             \
    return launch_bwd<N>(g, xcat, label, conf, t1, t2, taps_i, taps_f, dz_rows,       \
                         dt_part, dx, dt, batch, h8, w8, H, W, C, th, ignore, s);
  switch (TOT) {
    SIMT_BWD(6)
    SIMT_BWD(8)
    SIMT_BWD(34)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIMT_BWD
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
