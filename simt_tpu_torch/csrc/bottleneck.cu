// The fused train-mode bottleneck for Hopper (sm_90a): forward (B6) and backward (B7)
// of a whole identity block with batch-statistic BatchNorm,
//   out = relu(bn3(conv3(relu(bn2(conv2_d(relu(bn1(conv1(x)))))))) + x),
// single image, bf16 activations, float32 statistics.
//
// Replaces: experiments/pallas_bottleneck/bottleneck.py::_fwd_kernel (launched by
// _fwd_call, wrapped by fused_bottleneck's custom VJP) and ::_bwd_kernel (launched by
// _bwd_call). Like them it is not on the model's paths: the JAX package keeps its
// trunk on the composed block, and so does the port.
//
// Why a sequence of launches: the Pallas kernel keeps the whole block in VMEM (x alone
// is 17.2 MB at layer3) and walks the image in order, carrying each BatchNorm's sums
// from one row tile to the next. A Hopper block has 227 KB and blocks run in no order,
// and every BatchNorm needs its statistics over all pixels before the next GEMM may
// use them: a grid-wide dependency. So each GEMM is one launch over device-memory
// intermediates, and each statistic goes through fixed-order partials.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at layer3 (65x129,
// Ct 1024, P 256, d 2): forward 2*H*W*(2*Ct*P + 9*P^2) = 18.7 GFLOP, 19 us, against
// about 45 MB, 13 us, so the tensor cores bound it; backward about 41.8 GFLOP, 42 us.
// Only wgmma reaches that rate, and only while shared memory is refilled as fast as it
// drains; beside the products, every intermediate (h1raw, h2raw, outraw, dz, dor) still
// crosses device memory, about 52 MB forward and 80 MB more backward at layer3.
//
// The wgmma path (bf16 with Ct and P multiples of 8 and 16-byte-aligned tensors: every
// trunk geometry). B6 is seven launches, B7 twelve:
//   - bneck_prep_kernel: every weight of the call, float32 or bf16 OIHW, packed to the
//     bf16 K-major B layout (N, taps, K) in one launch; in B7 the same launch forms the
//     three BatchNorms' coefficients from B6's statistics;
//   - bneck_bn_relu_kernel: h1 = bf16(relu(a1*h1raw + c1)) and h2 likewise, written once
//     (B6: each after the GEMM that finishes its statistics; B7: both in one launch).
//     A first design applied this BatchNorm + ReLU to the operand inside the GEMMs and
//     weight gradients, rewriting each landed stage in shared memory before wgmma read
//     it; on an H100 at layer3 that cost more than the products it fed (conv2 0.066 ms
//     against 0.032 for the same GEMM and epilogue without it, dw2 0.091 against 0.029),
//     because every tap (9) and every N tile (2-4) of a consumer transforms the same
//     values again, at about ten instructions an element. The pass moves 8.6 MB at
//     layer3, about 3 us;
//   - bneck_gemm_wgmma_kernel<BN, EPI>: B4's pipeline (hopper.cuh; one producer thread
//     keeps TMA loads of the A rows at the tap's flat offset and of the B slice in a
//     ring of stages, two consumer warpgroups run wgmma k16 steps), generalised to taps
//     1 (the 1x1 convs) or 9 (the dilated 3x3); for a 3x3 each consumer thread zeroes
//     its half row of a landed stage wherever the output pixel's shifted (h, w) leaves
//     the image (fence.proxy.async and the warpgroup barrier before wgmma reads it).
//     Tiles of 128 pixels x BN (64, 128 or 256) from the shapes alone
//     (ops/kernels/conv3x3.py::fwd_tiles). Epilogue: the float32 accumulators go to
//     shared memory; each thread then owns 8 columns of a few rows, issues the global
//     loads of a batch of rows before using them, stores its 16-byte outputs (EPI: the
//     rounded conv output; outraw and dz3; dz; dx += ) and keeps its column statistics
//     in registers; the tile's column sums go to (m tile, 2, N) partials, and the last
//     m tile of each N tile to finish (an integer ticket) adds the partials in m-tile
//     order and writes the statistics with the BatchNorm coefficients (forward) or dg,
//     db and the BN-backward terms (backward): no statistics launch;
//   - bneck_wgrad_wgmma_kernel: B5's weight-gradient pipeline (hopper.cuh::
//     wgrad_wgmma), taps 1 or 9, C != O (dw1 = x^T dor1, dw2 = the nine taps of
//     h1_tap^T dor2, dw3 = h2^T dor3); its last split of a tile adds the float32
//     partials in split order and writes OIHW: no reduce launch;
//   - bneck_residual_kernel (out = relu(a3*outraw + c3 + x), rounded once) and
//     bneck_dor_kernel (dor = bf16(a*(dz - sum dz/m - xhat*sum(dz*xhat)/m))) need a
//     grid-wide statistic first and stay elementwise launches, 16 bytes a thread.
// Off the vector width or on unaligned tensors the first port's kernels run
// (bneck_gemm_kernel: 128x64 tiles, 32-deep K chunks staged synchronously, 16x16x16
// nvcuda::wmma, the BatchNorm + ReLU applied to A as it is loaded; bneck_stats_kernel /
// bneck_grad_stats_kernel; bneck_wgrad_kernel with bneck_wgrad_reduce_kernel), with
// the same prep, residual and dor kernels.
// Every product runs on the tensor cores inside these kernels; none goes to a library.
//
// Numerics follow the Pallas kernels on both paths: each conv output is rounded to bf16
// before its statistics; mean = sum/m, var = sum x^2/m - mean^2 (biased); the affine
// a = g*rsqrt(var + 1e-5), c = b - mean*a is applied with separately rounded multiply
// and add (no FMA contraction), as the plain PyTorch version computes it. The backward
// recomputes h1, h2 and outraw = bf16(h2 w3) from the saved h1raw/h2raw (outraw is
// recomputed, not saved by B6: one GEMM of P x Ct per pixel instead of a 17.2 MB
// residual at layer3), takes the ReLU3 mask from z3 before rounding, stores dz3, dz2,
// dz1 and dor3, dor2, dor1 in bf16 at the Pallas kernel's points, and forms
// dx = bf16(dz3 + dor1 w1^T). Every cross-block sum runs in a fixed order with no float
// atomics (integer tickets only), so reruns are bitwise equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 b16(float v) { return __float2bfloat16_rn(v); }

// bf16(relu(raw*a + c)), multiply and add each rounded (no FMA).
__device__ __forceinline__ bf16 bn_relu(float raw, float a, float c) {
  return b16(fmaxf(__fadd_rn(__fmul_rn(raw, a), c), 0.0f));
}

// A load unit: 16 bytes (8 bf16) on the vector path, one element otherwise.
template <int EV>
struct Unit {
  using type = uint4;
  __device__ static type zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <>
struct Unit<1> {
  using type = bf16;
  __device__ static type zero() { return b16(0.0f); }
};

template <int EV>
__device__ __forceinline__ void bn_relu_unit(typename Unit<EV>::type& u,
                                             const float* __restrict__ a,
                                             const float* __restrict__ c, int k) {
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < EV; ++i) e[i] = bn_relu(f(e[i]), a[k + i], c[k + i]);
}

// Eight float32 values from 32-byte-aligned global memory.
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// BN coefficients (a, c, mean, inv) into coef (4, N) from the batch mean and variance.
__device__ __forceinline__ void write_coef(float* coef, int N, int n, float mean, float var,
                                           float g, float b) {
  const float inv = rsqrtf(__fadd_rn(var, kEps));
  const float a = __fmul_rn(g, inv);
  coef[n] = a;
  coef[N + n] = __fsub_rn(b, __fmul_rn(mean, a));
  coef[2 * N + n] = mean;
  coef[3 * N + n] = inv;
}

enum Epi {
  kStore = 0,   // y = bf16(acc); stats (sum y, sum y^2)
  kDz3 = 1,     // y = outraw = bf16(acc); z = a*outraw + c + x; dz = z > 0 ? dy : 0
  kDzMask = 2,  // dz = bf16(relu(a*raw + c)) > 0 ? acc : 0; y = bf16(dz)
  kAddDx = 3,   // y = bf16(y + acc) (dx = dz3 + dor1 w1^T), no statistics
};

// ---------------------------------------------------------------------------------
// The first port's implicit GEMM (off the vector width): BN prologue on the loaded A,
// fused epilogues, per-tile column sums
// ---------------------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = C_BYTES > A_BYTES + B_BYTES ? C_BYTES : A_BYTES + B_BYTES;

struct GemmArgs {
  const bf16* a;   // A operand, (H*W, K) NHWC
  const float* pa;  // prologue scale per k (nullptr: A is used as stored)
  const float* pc;  // prologue shift per k
  const bf16* b;   // B operand, (taps, K, N)
  bf16* y;         // (H*W, N), see Epi
  float* part;     // (gridDim.x, 2, N) column sums of this tile's two statistics
  const bf16* ex;  // kDz3: x; kDzMask: the raw conv output that gave the mask
  const bf16* edy;  // kDz3: dy
  bf16* edz;        // kDz3: dz3 out
  const float* coef;  // (4, N): a, c, mean, 1/sqrt(var + eps) of the epilogue's BN
  int H, W, K, N, taps, d;
};

template <int EV, int EPI>
__global__ void __launch_bounds__(THREADS) bneck_gemm_kernel(GemmArgs p) {
  using U = Unit<EV>;
  using UT = typename U::type;
  constexpr int UA = BK / EV / 2;  // A units per thread: one pixel, half a K chunk
  constexpr int UB = BN / EV / 8;  // B units per thread: one k row, an eighth of it
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][4][BN];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);

  const int tid = threadIdx.x;
  const int M = p.H * p.W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int a_row = tid >> 1, a_half = tid & 1;
  const int am = m0 + a_row;
  const bool a_ok = am < M;
  const int a_h = a_ok ? am / p.W : 0;
  const int a_w = a_ok ? am - a_h * p.W : 0;
  const int b_row = tid >> 3, b_part = tid & 7;
  const int kchunks = (p.K + BK - 1) / BK;
  const int n_it = p.taps * kchunks;
  UT ra[UA], rb[UB];

  auto load = [&](int it) {
    const int tap = it / kchunks;
    const int c0 = (it - tap * kchunks) * BK;
    int hs = a_h, ws = a_w;
    if (p.taps == 9) {
      hs += (tap / 3 - 1) * p.d;
      ws += (tap % 3 - 1) * p.d;
    }
    const bool pix = a_ok && hs >= 0 && hs < p.H && ws >= 0 && ws < p.W;
    const long long abase = (static_cast<long long>(hs) * p.W + ws) * p.K;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int k = c0 + (a_half * UA + u) * EV;
      if (pix && k < p.K) {
        ra[u] = *reinterpret_cast<const UT*>(p.a + abase + k);
        if (p.pa != nullptr) bn_relu_unit<EV>(ra[u], p.pa, p.pc, k);
      } else {
        ra[u] = U::zero();
      }
    }
    const int k = c0 + b_row;
    const bf16* brow = p.b + (static_cast<long long>(tap) * p.K + k) * p.N;
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int n = n0 + (b_part * UB + u) * EV;
      rb[u] = (k < p.K && n < p.N) ? *reinterpret_cast<const UT*>(brow + n) : U::zero();
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < UA; ++u)
      *reinterpret_cast<UT*>(As + a_row * A_LD + (a_half * UA + u) * EV) = ra[u];
#pragma unroll
    for (int u = 0; u < UB; ++u)
      *reinterpret_cast<UT*>(Bs + b_row * B_LD + (b_part * UB + u) * EV) = rb[u];
  };

  const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  store();
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load(it + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (it + 1 < n_it) {
      store();
      __syncthreads();
    }
  }

  // Epilogue: accumulators -> shared float32 tile; each thread owns 32 columns of one
  // row, stores its outputs and leaves its two statistics for the column sums.
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  const int row = tid >> 1, col0 = (tid & 1) * 32;
  const int m = m0 + row;
  const int N = p.N;
  float q[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = n0 + col0 + j;
    const float v = Cs[row * C_LD + col0 + j];
    float s1 = 0.0f, s2 = 0.0f;
    if (m < M && n < N) {
      const long long i = static_cast<long long>(m) * N + n;
      if constexpr (EPI == kStore) {
        const float r = f(b16(v));
        p.y[i] = b16(r);
        s1 = r;
        s2 = r * r;
      } else if constexpr (EPI == kDz3) {
        const float r = f(b16(v));
        p.y[i] = b16(r);
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(r, p.coef[n]), p.coef[N + n]),
                                  f(p.ex[i]));
        const float dz = z > 0.0f ? f(p.edy[i]) : 0.0f;
        p.edz[i] = b16(dz);
        s1 = dz;
        s2 = dz * ((r - p.coef[2 * N + n]) * p.coef[3 * N + n]);
      } else if constexpr (EPI == kDzMask) {
        const float raw = f(p.ex[i]);
        const float dz = f(bn_relu(raw, p.coef[n], p.coef[N + n])) > 0.0f ? v : 0.0f;
        p.y[i] = b16(dz);
        s1 = dz;
        s2 = dz * ((raw - p.coef[2 * N + n]) * p.coef[3 * N + n]);
      } else {
        p.y[i] = b16(f(p.y[i]) + v);
      }
    }
    Cs[row * C_LD + col0 + j] = s1;
    q[j] = s2;
  }
  if constexpr (EPI == kAddDx) return;

  // Column sums of the tile, in a fixed order: four row quarters, then their sum.
  const int col = tid & (BN - 1), quarter = tid >> 6;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    __syncthreads();
    if (s == 1) {
#pragma unroll
      for (int j = 0; j < 32; ++j) Cs[row * C_LD + col0 + j] = q[j];
      __syncthreads();
    }
    float sum = 0.0f;
    for (int r = quarter * 32; r < quarter * 32 + 32; ++r) sum += Cs[r * C_LD + col];
    red[s][quarter][col] = sum;
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int s = tid / BN, c = tid % BN;
    if (n0 + c < N)
      p.part[(static_cast<long long>(blockIdx.x) * 2 + s) * N + n0 + c] =
          ((red[s][0][c] + red[s][1][c]) + red[s][2][c]) + red[s][3][c];
  }
}

// ---------------------------------------------------------------------------------
// The first port's statistics: partials summed in block order
// ---------------------------------------------------------------------------------

__global__ void bneck_stats_kernel(const float* __restrict__ part, int blocks, int N,
                                   float m, const float* __restrict__ g,
                                   const float* __restrict__ b, float* __restrict__ mean_out,
                                   float* __restrict__ var_out, float* __restrict__ coef) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f, q = 0.0f;
  for (int i = 0; i < blocks; ++i) {
    s += part[(2LL * i) * N + n];
    q += part[(2LL * i + 1) * N + n];
  }
  const float mean = __fdiv_rn(s, m);
  const float var = __fsub_rn(__fdiv_rn(q, m), __fmul_rn(mean, mean));
  mean_out[n] = mean;
  var_out[n] = var;
  write_coef(coef, N, n, mean, var, g[n], b[n]);
}

// dg = sum dz*xhat, db = sum dz; sq (2, N) = (sum dz / m, sum dz*xhat / m).
__global__ void bneck_grad_stats_kernel(const float* __restrict__ part, int blocks, int N,
                                        float m, float* __restrict__ dg,
                                        float* __restrict__ db, float* __restrict__ sq) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f, q = 0.0f;
  for (int i = 0; i < blocks; ++i) {
    s += part[(2LL * i) * N + n];
    q += part[(2LL * i + 1) * N + n];
  }
  dg[n] = q;
  db[n] = s;
  sq[n] = __fdiv_rn(s, m);
  sq[N + n] = __fdiv_rn(q, m);
}

// ---------------------------------------------------------------------------------
// Elementwise passes: EV elements (16 bytes on the vector path) a thread
// ---------------------------------------------------------------------------------

// EV per-channel float32 values from p (32-byte aligned when EV is 8).
template <int EV>
__device__ __forceinline__ void load_ev(const float* __restrict__ p, float (&v)[EV]) {
  if constexpr (EV == 8) {
    load8(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < EV; ++e) v[e] = p[e];
  }
}

// out = bf16(relu(a*out + c + x)); out holds outraw on entry.
template <int EV>
__global__ void bneck_residual_kernel(bf16* out, const bf16* __restrict__ x, long long total,
                                      int N, const float* __restrict__ coef) {
  using UT = typename Unit<EV>::type;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       u < total / EV; u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = u * EV;
    const int n0 = static_cast<int>(i % N);
    UT o = *reinterpret_cast<const UT*>(out + i);
    const UT xv = *reinterpret_cast<const UT*>(x + i);
    float a[EV], c[EV];
    load_ev<EV>(coef + n0, a);
    load_ev<EV>(coef + N + n0, c);
    bf16* oe = reinterpret_cast<bf16*>(&o);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      const float y = __fadd_rn(__fadd_rn(__fmul_rn(f(oe[e]), a[e]), c[e]), f(xe[e]));
      oe[e] = b16(fmaxf(y, 0.0f));
    }
    *reinterpret_cast<UT*>(out + i) = o;
  }
}

// out = bf16(a*(dz - sum dz/m - xhat*(sum dz*xhat/m))), xhat = (raw - mean)*inv; out
// may alias dz or raw.
template <int EV>
__global__ void bneck_dor_kernel(const bf16* dz, const bf16* raw, bf16* out, long long total,
                                 int N, const float* __restrict__ coef,
                                 const float* __restrict__ sq) {
  using UT = typename Unit<EV>::type;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       u < total / EV; u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = u * EV;
    const int n0 = static_cast<int>(i % N);
    const UT dv = *reinterpret_cast<const UT*>(dz + i);
    const UT rv = *reinterpret_cast<const UT*>(raw + i);
    UT o;
    float a[EV], mean[EV], inv[EV], s[EV], q[EV];
    load_ev<EV>(coef + n0, a);
    load_ev<EV>(coef + 2 * N + n0, mean);
    load_ev<EV>(coef + 3 * N + n0, inv);
    load_ev<EV>(sq + n0, s);
    load_ev<EV>(sq + N + n0, q);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
    const bf16* re = reinterpret_cast<const bf16*>(&rv);
    bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      const float xhat = __fmul_rn(__fsub_rn(f(re[e]), mean[e]), inv[e]);
      const float t = __fsub_rn(__fsub_rn(f(de[e]), s[e]), __fmul_rn(xhat, q[e]));
      oe[e] = b16(__fmul_rn(a[e], t));
    }
    *reinterpret_cast<UT*>(out + i) = o;
  }
}

// ---------------------------------------------------------------------------------
// Preparation, one launch a call: weight packing and (B7) the BN coefficients
// ---------------------------------------------------------------------------------

// dst (d0, d1, d2) bf16, contiguous = src[off + i0*s0 + i1*s1 + i2*s2], float32 or bf16.
struct PackJob {
  const void* src;
  bf16* dst;
  int d0, d1, d2;
  long long off, s0, s1, s2;
};

// coef (4, n) of one BatchNorm from its saved mean and variance.
struct CoefJob {
  const float* mean;
  const float* var;
  const float* g;
  const float* b;
  float* coef;
  int n;
};

struct PrepArgs {
  PackJob pack[4];
  CoefJob coef[3];
  int packs, coefs, src_bf16;
};

// blockIdx.y picks the job: packs first, then coefficients. (__grid_constant__: the
// job is read in place, without a per-thread copy of the arguments.)
__global__ void bneck_prep_kernel(const __grid_constant__ PrepArgs a) {
  const long long start = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int job = blockIdx.y;
  if (job < a.packs) {
    const PackJob& j = a.pack[job];
    const int total = j.d0 * j.d1 * j.d2;  // a weight: under 2**31 elements
    for (int i = static_cast<int>(start); i < total; i += static_cast<int>(stride)) {
      const int i2 = i % j.d2, t = i / j.d2;
      const int i1 = t % j.d1, i0 = t / j.d1;
      const long long s = j.off + i0 * j.s0 + i1 * j.s1 + i2 * j.s2;
      j.dst[i] = a.src_bf16 ? static_cast<const bf16*>(j.src)[s]
                            : b16(static_cast<const float*>(j.src)[s]);
    }
  } else {
    const CoefJob& c = a.coef[job - a.packs];
    for (long long n = start; n < c.n; n += stride)
      write_coef(c.coef, c.n, static_cast<int>(n), c.mean[n], c.var[n], c.g[n], c.b[n]);
  }
}

// ---------------------------------------------------------------------------------
// The first port's weight gradients: part[s][tap][c][o] = sum over split s's pixels of
// A'(p shifted by tap)[c] * G[p][o], then a fixed-order sum over splits
// ---------------------------------------------------------------------------------

constexpr int G_BC = 64, G_BO = 64, G_BP = 32, G_THREADS = 128;
constexpr int G_LD = 64 + 8, G_CLD = G_BO + 4;
constexpr int G_TILE_BYTES = G_BP * G_LD * 2;
constexpr int G_C_BYTES = G_BC * G_CLD * 4;
constexpr int G_BYTES = 2 * G_TILE_BYTES > G_C_BYTES ? 2 * G_TILE_BYTES : G_C_BYTES;

struct WgradArgs {
  const bf16* a;    // (H*W, C)
  const float* pa;  // prologue scale per c (nullptr: none)
  const float* pc;
  const bf16* g;    // (H*W, O)
  float* part;      // (splits, taps, C, O)
  int H, W, C, O, taps, d, per_split;
};

template <int EV>
__global__ void __launch_bounds__(G_THREADS) bneck_wgrad_kernel(WgradArgs p) {
  using U = Unit<EV>;
  using UT = typename U::type;
  constexpr int UPT = 64 / EV / 4;  // units per thread per tile: a quarter row
  __shared__ __align__(128) unsigned char smem[G_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);                  // [pixel][c]
  bf16* Bs = reinterpret_cast<bf16*>(smem + G_TILE_BYTES);   // [pixel][o]

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int c_tiles = (p.C + G_BC - 1) / G_BC;
  const int c0 = (blockIdx.y % c_tiles) * G_BC;
  const int o0 = (blockIdx.y / c_tiles) * G_BO;
  const int tap = blockIdx.z;
  const int dh = p.taps == 9 ? (tap / 3 - 1) * p.d : 0;
  const int dw = p.taps == 9 ? (tap % 3 - 1) * p.d : 0;
  const int M = p.H * p.W;
  const long long pb = static_cast<long long>(split) * p.per_split;
  const long long pe = pb + p.per_split < M ? pb + p.per_split : M;
  const int n_it = pe > pb ? static_cast<int>((pe - pb + G_BP - 1) / G_BP) : 0;
  const int row = tid >> 2, quarter = tid & 3;
  UT ra[UPT], rb[UPT];

  auto load = [&](int it) {
    const long long px = pb + static_cast<long long>(it) * G_BP + row;
    const bool in_split = px < pe;
    bool ok = false;
    long long src = 0;
    if (in_split) {
      const int h = static_cast<int>(px / p.W), w = static_cast<int>(px % p.W);
      const int hs = h + dh, ws = w + dw;
      ok = hs >= 0 && hs < p.H && ws >= 0 && ws < p.W;
      src = static_cast<long long>(hs) * p.W + ws;
    }
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int col = (quarter * UPT + u) * EV;
      if (ok && c0 + col < p.C) {
        ra[u] = *reinterpret_cast<const UT*>(p.a + src * p.C + c0 + col);
        if (p.pa != nullptr) bn_relu_unit<EV>(ra[u], p.pa, p.pc, c0 + col);
      } else {
        ra[u] = U::zero();
      }
      rb[u] = (in_split && o0 + col < p.O)
                  ? *reinterpret_cast<const UT*>(p.g + px * p.O + o0 + col) : U::zero();
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int col = (quarter * UPT + u) * EV;
      *reinterpret_cast<UT*>(As + row * G_LD + col) = ra[u];
      *reinterpret_cast<UT*>(Bs + row * G_LD + col) = rb[u];
    }
  };

  const int warp = tid >> 5, wc = warp & 1, wo = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  if (n_it > 0) {
    load(0);
    store();
  }
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load(it + 1);
#pragma unroll
    for (int kk = 0; kk < G_BP; kk += 16) {
      // A = A'^T (c x pixel): the column-major view of the [pixel][c] tile.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * G_LD + wc * 32 + i * 16, G_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * G_LD + wo * 32 + j * 16, G_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (it + 1 < n_it) {
      store();
      __syncthreads();
    }
  }
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wc * 32 + i * 16) * G_CLD + wo * 32 + j * 16,
                              acc[i][j], G_CLD, wmma::mem_row_major);
  __syncthreads();
  float* out = p.part + ((static_cast<long long>(split) * p.taps + tap) * p.C) * p.O;
  for (int e = tid; e < G_BC * G_BO; e += G_THREADS) {
    const int r = e / G_BO, q = e % G_BO;
    if (c0 + r < p.C && o0 + q < p.O)
      out[static_cast<long long>(c0 + r) * p.O + o0 + q] = Cs[r * G_CLD + q];
  }
}

// dw[tap*sot + c*soc + o*sow] (float32) = sum over s in order of part[s][tap][c][o].
__global__ void bneck_wgrad_reduce_kernel(const float* __restrict__ part,
                                          float* __restrict__ dw, int taps, int C, int O,
                                          int splits, long long sot, long long soc,
                                          long long soo) {
  const long long total = static_cast<long long>(taps) * C * O;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(i % O);
    const long long tc = i / O;
    const int c = static_cast<int>(tc % C);
    const int t = static_cast<int>(tc / C);
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * total + i];
    dw[t * sot + c * soc + o * soo] = s;
  }
}

// ---------------------------------------------------------------------------------
// The wgmma path: BatchNorm + ReLU written once, and the zeroed padding rows
// ---------------------------------------------------------------------------------

// out = bf16(relu(a*raw + c)) for one or two (pixels, N) tensors (blockIdx.y), each with
// its BN coefficients (4, N): h1 and h2, the GEMMs' and weight gradients' operands.
struct NormJob {
  const bf16* raw;
  bf16* out;
  const float* coef;
};

struct NormArgs {
  NormJob job[2];
  long long total;  // elements of each tensor, a multiple of 8
  int N;
};

__global__ void bneck_bn_relu_kernel(const __grid_constant__ NormArgs a) {
  const NormJob& j = a.job[blockIdx.y];
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       u < a.total / 8; u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = u * 8;
    const int n0 = static_cast<int>(i % a.N);
    uint4 v = __ldg(reinterpret_cast<const uint4*>(j.raw + i));
    float ca[8], cc[8];
    load8(j.coef + n0, ca);
    load8(j.coef + a.N + n0, cc);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = bn_relu(f(e[k]), ca[k], cc[k]);
    *reinterpret_cast<uint4*>(j.out + i) = v;
  }
}

// A tile row whose shifted pixel leaves the image: its half (four 16-byte chunks).
__device__ __forceinline__ void zero_half_row(uint4* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) p[q] = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------------
// The wgmma path's implicit GEMM: Y[m][n] = sum over (tap, k) of A'(m shifted by
// tap)[k] * B[n][tap][k], with the epilogues of Epi and the statistics finished in
// the kernel
// ---------------------------------------------------------------------------------

template <int BN_>
struct GemmCfg {
  static constexpr int A_BYTES = H_BM * 128;
  static constexpr int B_BYTES = BN_ * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = BN_ == 256 ? 4 : (BN_ == 128 ? 6 : 8);  // stages: <= 192 KB
  static constexpr int LD = BN_ + 8;  // float pitch of the staged accumulators
  static constexpr int R = H_CONSUMERS / (BN_ / 8);  // rows an epilogue pass covers
  static constexpr int SMEM = ST * STAGE + 2 * ST * 8 + 1024;
  static_assert(H_BM * LD * 4 + 2 * R * BN_ * 4 <= ST * STAGE, "epilogue fits the ring");
};

struct HArgs {
  bf16* y;          // (M, N): kStore/kDz3 the rounded conv output, kDzMask dz, kAddDx dx
  const bf16* ex;   // kDz3: x; kDzMask: the raw conv output whose BN + ReLU gave the mask
  const bf16* edy;  // kDz3: dy
  bf16* edz;        // kDz3: dz3 out
  const float* coef;  // (4, N): a, c, mean, inv of the epilogue's BN (kDz3, kDzMask)
  float* part;        // (m tiles, 2, N) the tiles' column sums
  int* tickets;       // one per N tile: zero on entry, left zero
  const float* g;     // kStore: the BN affine of this conv's output
  const float* b;
  float* out0;  // kStore: mean; kDz3/kDzMask: dg = sum dz*xhat
  float* out1;  // kStore: var; kDz3/kDzMask: db = sum dz
  float* out2;  // kStore: coef (4, N) of this BN; kDz3/kDzMask: sq (2, N)
  int H, W, K, N, taps, d;
};

// One block: a 128-pixel x BN-channel output tile; the K loop runs the taps outer and
// K in chunks of 64 inner, through a ring of ST stages (B4's pipeline, hopper.cuh).
template <int BN_, int EPI>
__global__ void __launch_bounds__(H_THREADS, 1) bneck_gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const HArgs p) {
  using Cfg = GemmCfg<BN_>;
  constexpr int ST = Cfg::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * Cfg::STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int M = p.H * p.W, N = p.N;
  const int m0 = blockIdx.x * H_BM;
  const int n0 = blockIdx.y * BN_;
  const int kchunks = (p.K + H_BK - 1) / H_BK;
  const int n_it = p.taps * kchunks;
  const uint32_t sbase = smem_u32(smem);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival; the TMA bytes complete it
      mbar_init(&empty[s], H_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= H_CONSUMERS) {
    if (tid != H_CONSUMERS) return;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
      const int tap = it / kchunks;
      const int c0 = (it - tap * kchunks) * H_BK;
      const int shift =
          p.taps == 9 ? (tap / 3 - 1) * p.d * p.W + (tap % 3 - 1) * p.d : 0;
      const uint32_t sa = sbase + s * Cfg::STAGE;
      mbar_arrive_expect_tx(&full[s], Cfg::STAGE);
      tma_load_2d(sa, &amap, &full[s], c0, m0 + shift);
      tma_load_3d(sa + Cfg::A_BYTES, &bmap, &full[s], c0, tap, n0);
    }
    return;
  }

  // Consumer warpgroup wg: output rows wg*64 .. wg*64+63 of the tile. This thread zeroes
  // half (four 16-byte chunks) of row `row` of a stage wherever the row's shifted pixel
  // leaves the image (the flat shift wraps across image rows).
  const int wg = tid / 128, lt = tid % 128;
  const int row = wg * 64 + (lt >> 1), half = lt & 1;
  int rh = -1, rw = 0;  // the row's output pixel (h, w); rh -1 past M
  if (m0 + row < M) {
    rh = (m0 + row) / p.W;
    rw = m0 + row - rh * p.W;
  }
  float acc[BN_ / 2];
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const int tap = it / kchunks;
    mbar_wait(&full[s], (it / ST) & 1);
    if (p.taps == 9 && rh >= 0) {
      const int hs = rh + (tap / 3 - 1) * p.d, ws = rw + (tap % 3 - 1) * p.d;
      if (hs < 0 || hs >= p.H || ws < 0 || ws >= p.W)
        zero_half_row(reinterpret_cast<uint4*>(smem + s * Cfg::STAGE + row * 128) + 4 * half);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    const uint32_t sa = sbase + s * Cfg::STAGE + wg * 64 * 128;
    const uint32_t sb = sbase + s * Cfg::STAGE + Cfg::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma<BN_, 0, 0>(acc, gmma_desc(sa + 32 * k, 16, 1024),
                       gmma_desc(sb + 32 * k, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(&empty[(it - 1) % ST]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Both consumer warpgroups are done with the ring: the float32 tile is staged there.
  named_sync(1, H_CONSUMERS);
  constexpr int LD = Cfg::LD, G = BN_ / 8, R = Cfg::R;
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int warp = lt / 32, lane = lt % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4, cq = (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(tile + (r0 + 8 * i) * LD + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  named_sync(1, H_CONSUMERS);

  // Thread (r0, g) owns columns n .. n+7 of rows r0, r0 + R, ...: 16-byte loads and
  // stores along each row, its column statistics summed in row order in registers.
  // Rows go in batches of RB whose global loads are all issued before any is used.
  const int g = tid % G, r0 = tid / G;
  const int n = n0 + 8 * g;
  const bool col_ok = n < N;  // N is a multiple of 8
  constexpr int ROWS = H_BM / R, RB = ROWS < 4 ? ROWS : 4;
  float s1[8], s2[8], ca[8], cc[8], cm[8], ci[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;
  if constexpr (EPI == kDz3 || EPI == kDzMask) {
    if (col_ok) {
      load8(p.coef + n, ca);
      load8(p.coef + N + n, cc);
      load8(p.coef + 2 * N + n, cm);
      load8(p.coef + 3 * N + n, ci);
    }
  }
  for (int q0 = 0; q0 < ROWS; q0 += RB) {
    bool ok[RB];
    long long idx[RB];
    uint4 in0[RB], in1[RB];  // kDz3: x, dy; kDzMask: raw; kAddDx: dz3
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int m = m0 + r0 + (q0 + b) * R;
      ok[b] = col_ok && m < M;
      idx[b] = static_cast<long long>(m) * N + n;
      if (ok[b]) {
        if constexpr (EPI == kDz3) {
          in0[b] = __ldg(reinterpret_cast<const uint4*>(p.ex + idx[b]));
          in1[b] = __ldg(reinterpret_cast<const uint4*>(p.edy + idx[b]));
        } else if constexpr (EPI == kDzMask) {
          in0[b] = __ldg(reinterpret_cast<const uint4*>(p.ex + idx[b]));
        } else if constexpr (EPI == kAddDx) {
          in0[b] = *reinterpret_cast<const uint4*>(p.y + idx[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (!ok[b]) continue;
      const int r = r0 + (q0 + b) * R;
      const float4 lo = *reinterpret_cast<const float4*>(tile + r * LD + 8 * g);
      const float4 hi = *reinterpret_cast<const float4*>(tile + r * LD + 8 * g + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const long long i = idx[b];
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
      if constexpr (EPI == kStore) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = b16(v[j]);
          const float r_ = f(o[j]);
          s1[j] += r_;
          s2[j] += r_ * r_;
        }
        *reinterpret_cast<uint4*>(p.y + i) = out;
      } else if constexpr (EPI == kDz3) {
        const bf16* xe = reinterpret_cast<const bf16*>(&in0[b]);
        const bf16* dye = reinterpret_cast<const bf16*>(&in1[b]);
        uint4 dzv;
        bf16* dze = reinterpret_cast<bf16*>(&dzv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = b16(v[j]);
          const float r_ = f(o[j]);
          const float z = __fadd_rn(__fadd_rn(__fmul_rn(r_, ca[j]), cc[j]), f(xe[j]));
          const float dz = z > 0.0f ? f(dye[j]) : 0.0f;
          dze[j] = b16(dz);
          s1[j] += dz;
          s2[j] += dz * ((r_ - cm[j]) * ci[j]);
        }
        *reinterpret_cast<uint4*>(p.y + i) = out;
        *reinterpret_cast<uint4*>(p.edz + i) = dzv;
      } else if constexpr (EPI == kDzMask) {
        const bf16* re = reinterpret_cast<const bf16*>(&in0[b]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float raw = f(re[j]);
          const float dz = f(bn_relu(raw, ca[j], cc[j])) > 0.0f ? v[j] : 0.0f;
          o[j] = b16(dz);
          s1[j] += dz;
          s2[j] += dz * ((raw - cm[j]) * ci[j]);
        }
        *reinterpret_cast<uint4*>(p.y + i) = out;
      } else {
        const bf16* ye = reinterpret_cast<const bf16*>(&in0[b]);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = b16(f(ye[j]) + v[j]);
        *reinterpret_cast<uint4*>(p.y + i) = out;
      }
    }
  }
  if constexpr (EPI == kAddDx) return;

  // The tile's column sums: the R row-sets' sums added in row-set order, into this m
  // tile's partials.
  float* red = tile + H_BM * LD;  // [2][R][BN], beside the staged tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[r0 * BN_ + 8 * g + j] = s1[j];
    red[(R + r0) * BN_ + 8 * g + j] = s2[j];
  }
  named_sync(1, H_CONSUMERS);
  for (int e = tid; e < 2 * BN_; e += H_CONSUMERS) {
    const int s = e / BN_, c = e % BN_;
    float t = 0.0f;
    for (int q = 0; q < R; ++q) t += red[(s * R + q) * BN_ + c];
    if (n0 + c < N) p.part[(static_cast<long long>(blockIdx.x) * 2 + s) * N + n0 + c] = t;
  }

  // The last m tile of this N tile to finish (integer ticket) sums the partials in
  // m-tile order and writes the statistics, then resets the ticket for the next launch.
  __threadfence();
  named_sync(1, H_CONSUMERS);
  if (tid == 0) {
    const int is_last =
        atomicAdd(p.tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
    if (is_last) p.tickets[blockIdx.y] = 0;
    last = is_last;
  }
  named_sync(1, H_CONSUMERS);
  if (!last) return;
  __threadfence();
  // Thread e sums statistic e / BN_ of column e % BN_ over the m tiles in order, 16
  // loads in flight; the sums meet in shared memory.
  const int tiles = static_cast<int>(gridDim.x);
  for (int e = tid; e < 2 * BN_; e += H_CONSUMERS) {
    const int nn = n0 + e % BN_;
    if (nn >= N) continue;
    const float* src = p.part + static_cast<long long>(e / BN_) * N + nn;
    float t = 0.0f;
    int i = 0;
    for (; i + 16 <= tiles; i += 16) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = __ldcg(src + 2LL * (i + j) * N);
#pragma unroll
      for (int j = 0; j < 16; ++j) t += v[j];
    }
    for (; i < tiles; ++i) t += __ldcg(src + 2LL * i * N);
    red[e] = t;
  }
  named_sync(1, H_CONSUMERS);
  const float mf = static_cast<float>(M);
  for (int c = tid; c < BN_; c += H_CONSUMERS) {
    const int nn = n0 + c;
    if (nn >= N) continue;
    const float s = red[c], q = red[BN_ + c];
    if constexpr (EPI == kStore) {
      const float mean = __fdiv_rn(s, mf);
      const float var = __fsub_rn(__fdiv_rn(q, mf), __fmul_rn(mean, mean));
      p.out0[nn] = mean;
      p.out1[nn] = var;
      write_coef(p.out2, N, nn, mean, var, p.g[nn], p.b[nn]);
    } else {
      p.out0[nn] = q;
      p.out1[nn] = s;
      p.out2[nn] = __fdiv_rn(s, mf);
      p.out2[N + nn] = __fdiv_rn(q, mf);
    }
  }
}

// The wgmma path's weight gradient: hopper.cuh's wgrad_wgmma, taps 1 or 9, on A' = x,
// h1 or h2.
template <int BC, int BO>
__global__ void __launch_bounds__(GradCfg<BC, BO>::THREADS, 1) bneck_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    float* __restrict__ part, int* __restrict__ tickets, float* __restrict__ dw, int H,
    int W, int C, int O, int taps, int d, int pix_per_split) {
  wgrad_wgmma<BC, BO>(xmap, gmap, part, tickets, dw, 1, H, W, C, O, taps, d, pix_per_split);
}

// ---------------------------------------------------------------------------------
// Host side: one call per direction, every launch on the caller's stream
// ---------------------------------------------------------------------------------

int grid_1d(long long total) {
  const long long need = (total + 255) / 256;
  return static_cast<int>(need < 8192 ? need : 8192);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

#define CHECK(call)            \
  do {                         \
    const int e_ = (call);     \
    if (e_ != 0) return e_;    \
  } while (0)

// dst (d0, d1, d2) of src's elements at off + i0*s0 + i1*s1 + i2*s2.
PackJob pack_job(const void* src, bf16* dst, int d0, int d1, int d2, long long off,
                 long long s0, long long s1, long long s2) {
  return PackJob{src, dst, d0, d1, d2, off, s0, s1, s2};
}

int prep(PrepArgs a, cudaStream_t s) {
  long long most = 0;
  for (int j = 0; j < a.packs; ++j) {
    const long long t = static_cast<long long>(a.pack[j].d0) * a.pack[j].d1 * a.pack[j].d2;
    most = t > most ? t : most;
  }
  for (int j = 0; j < a.coefs; ++j) most = a.coef[j].n > most ? a.coef[j].n : most;
  const dim3 grid(static_cast<unsigned>(grid_1d(most)),
                  static_cast<unsigned>(a.packs + a.coefs));
  bneck_prep_kernel<<<grid, 256, 0, s>>>(a);
  return last_error();
}

int residual(int ev, void* out, const void* x, long long total, int N, const float* coef,
             cudaStream_t s) {
  if (ev == 8)
    bneck_residual_kernel<8><<<grid_1d(total / 8), 256, 0, s>>>(
        static_cast<bf16*>(out), static_cast<const bf16*>(x), total, N, coef);
  else
    bneck_residual_kernel<1><<<grid_1d(total), 256, 0, s>>>(
        static_cast<bf16*>(out), static_cast<const bf16*>(x), total, N, coef);
  return last_error();
}

int dor(int ev, const void* dz, const void* raw, void* out, long long total, int N,
        const float* coef, const float* sq, cudaStream_t s) {
  if (ev == 8)
    bneck_dor_kernel<8><<<grid_1d(total / 8), 256, 0, s>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(raw), static_cast<bf16*>(out),
        total, N, coef, sq);
  else
    bneck_dor_kernel<1><<<grid_1d(total), 256, 0, s>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(raw), static_cast<bf16*>(out),
        total, N, coef, sq);
  return last_error();
}

// --- the first port's path (off the vector width or unaligned) ---

int mblocks(int M) { return (M + BM - 1) / BM; }

int gemm(int epi, const GemmArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(mblocks(a.H * a.W)),
                  static_cast<unsigned>((a.N + BN - 1) / BN));
  switch (epi) {
    case kStore: bneck_gemm_kernel<1, kStore><<<grid, THREADS, 0, s>>>(a); break;
    case kDz3: bneck_gemm_kernel<1, kDz3><<<grid, THREADS, 0, s>>>(a); break;
    case kDzMask: bneck_gemm_kernel<1, kDzMask><<<grid, THREADS, 0, s>>>(a); break;
    default: bneck_gemm_kernel<1, kAddDx><<<grid, THREADS, 0, s>>>(a); break;
  }
  return last_error();
}

GemmArgs gemm_args(const void* a, const float* pa, const float* pc, const bf16* b, void* y,
                   float* part, int H, int W, int K, int N, int taps, int d) {
  GemmArgs g{};
  g.a = static_cast<const bf16*>(a);
  g.pa = pa;
  g.pc = pc;
  g.b = b;
  g.y = static_cast<bf16*>(y);
  g.part = part;
  g.H = H;
  g.W = W;
  g.K = K;
  g.N = N;
  g.taps = taps;
  g.d = d;
  return g;
}

// dw (OIHW float32, element strides sot/soc/soo) from A' (H*W, C) and G (H*W, O).
int wgrad(const void* a, const float* pa, const float* pc, const void* g, float* part,
          float* dw, int H, int W, int C, int O, int taps, int d, int splits, int per_split,
          long long sot, long long soc, long long soo, cudaStream_t s) {
  WgradArgs w{};
  w.a = static_cast<const bf16*>(a);
  w.pa = pa;
  w.pc = pc;
  w.g = static_cast<const bf16*>(g);
  w.part = part;
  w.H = H;
  w.W = W;
  w.C = C;
  w.O = O;
  w.taps = taps;
  w.d = d;
  w.per_split = per_split;
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(((C + G_BC - 1) / G_BC) * ((O + G_BO - 1) / G_BO)),
                  static_cast<unsigned>(taps));
  bneck_wgrad_kernel<1><<<grid, G_THREADS, 0, s>>>(w);
  CHECK(last_error());
  bneck_wgrad_reduce_kernel<<<grid_1d(static_cast<long long>(taps) * C * O), 256, 0, s>>>(
      part, dw, taps, C, O, splits, sot, soc, soo);
  return last_error();
}

// --- the wgmma path ---

template <int BN_, int EPI>
int launch_gemm(const void* a, const void* b, const HArgs& p, cudaStream_t s) {
  using Cfg = GemmCfg<BN_>;
  static const int attr = opt_in_smem(bneck_gemm_wgmma_kernel<BN_, EPI>, Cfg::SMEM);
  if (attr != 0) return attr;
  const int M = p.H * p.W;
  CUtensorMap amap, bmap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.taps),
                              static_cast<cuuint64_t>(p.N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.K) * 2,
                                 static_cast<cuuint64_t>(p.K) * p.taps * 2};
  const cuuint32_t box[3] = {H_BK, 1, BN_};
  int err = pixel_map(&amap, a, M, p.K, H_BM);
  if (err == 0) err = make_map(&bmap, b, 3, dims, strides, box);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((M + H_BM - 1) / H_BM),
                  static_cast<unsigned>((p.N + BN_ - 1) / BN_));
  bneck_gemm_wgmma_kernel<BN_, EPI><<<grid, H_THREADS, Cfg::SMEM, s>>>(amap, bmap, p);
  return last_error();
}

template <int EPI>
int gemm_bn(int bn, const void* a, const void* b, const HArgs& p, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_gemm<64, EPI>(a, b, p, s);
    case 128: return launch_gemm<128, EPI>(a, b, p, s);
    case 256: return launch_gemm<256, EPI>(a, b, p, s);
    default: return kInvalid;
  }
}

// Y (H*W, N) from A (H*W, K) and the packed B (N, taps, K); the HArgs fields as the
// epilogue needs them.
int hgemm(int epi, int bn, const void* a, const void* b, HArgs p, cudaStream_t s) {
  if (p.K % 8 != 0 || p.N % 8 != 0) return kInvalid;
  switch (epi) {
    case kStore: return gemm_bn<kStore>(bn, a, b, p, s);
    case kDz3: return gemm_bn<kDz3>(bn, a, b, p, s);
    case kDzMask: return gemm_bn<kDzMask>(bn, a, b, p, s);
    default: return gemm_bn<kAddDx>(bn, a, b, p, s);
  }
}

HArgs hargs(void* y, float* part, int* tickets, int H, int W, int K, int N, int taps, int d) {
  HArgs p{};
  p.y = static_cast<bf16*>(y);
  p.part = part;
  p.tickets = tickets;
  p.H = H;
  p.W = W;
  p.K = K;
  p.N = N;
  p.taps = taps;
  p.d = d;
  return p;
}

template <int BC, int BO>
int launch_hwgrad(const void* x, const void* g, float* part, int* tickets, float* dw, int H,
                  int W, int C, int O, int taps, int d, int splits, int span, cudaStream_t s) {
  using Cfg = GradCfg<BC, BO>;
  static const int attr = opt_in_smem(bneck_wgrad_wgmma_kernel<BC, BO>, Cfg::SMEM);
  if (attr != 0) return attr;
  const long long M = static_cast<long long>(H) * W;
  CUtensorMap xmap, gmap;
  int err = pixel_map(&xmap, x, M, C, G_PIX);
  if (err == 0) err = pixel_map(&gmap, g, M, O, G_PIX);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(((C + BC - 1) / BC) * ((O + BO - 1) / BO)),
                  static_cast<unsigned>(taps));
  bneck_wgrad_wgmma_kernel<BC, BO><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(
      xmap, gmap, part, tickets, dw, H, W, C, O, taps, d, span);
  return last_error();
}

// dw (OIHW float32: (O, C, taps)) from A' (H*W, C) and G (H*W, O); sched = {bc, bo,
// splits, span} (ops/kernels/conv3x3.py::wgrad_tiles).
int hwgrad(const int* sched, const void* x, const void* g, float* part, int* tickets,
           float* dw, int H, int W, int C, int O, int taps, int d, cudaStream_t s) {
  const int bc = sched[0], bo = sched[1], splits = sched[2], span = sched[3];
  if (C % 8 != 0 || O % 8 != 0 || splits < 1 || span % G_PIX != 0) return kInvalid;
  if (bc == 64 && bo == 64)
    return launch_hwgrad<64, 64>(x, g, part, tickets, dw, H, W, C, O, taps, d, splits, span,
                                 s);
  if (bc == 128 && bo == 128)
    return launch_hwgrad<128, 128>(x, g, part, tickets, dw, H, W, C, O, taps, d, splits,
                                   span, s);
  if (bc == 128 && bo == 256)
    return launch_hwgrad<128, 256>(x, g, part, tickets, dw, H, W, C, O, taps, d, splits,
                                   span, s);
  return kInvalid;
}

// h = bf16(relu(a*raw + c)) of one tensor, or of two when raw2 is not null.
int bn_relu_pass(const void* raw1, void* out1, const float* coef1, const void* raw2,
                 void* out2, const float* coef2, long long total, int N, cudaStream_t s) {
  NormArgs a{};
  a.job[0] = NormJob{static_cast<const bf16*>(raw1), static_cast<bf16*>(out1), coef1};
  a.job[1] = NormJob{static_cast<const bf16*>(raw2), static_cast<bf16*>(out2), coef2};
  a.total = total;
  a.N = N;
  const dim3 grid(static_cast<unsigned>(grid_1d(total / 8)), raw2 != nullptr ? 2u : 1u);
  bneck_bn_relu_kernel<<<grid, 256, 0, s>>>(a);
  return last_error();
}

}  // namespace

extern "C" {

// B6. x (H*W, Ct) bf16 NHWC; w1 (P, Ct), w2 (P, P, 3, 3), w3 (Ct, P) OIHW, float32
// (w_bf16 0) or bf16 (1); g*, b* float32. Writes out (H*W, Ct), h1raw, h2raw (H*W, P)
// bf16, stats_p (4, P) = m1 v1 m2 v2 and stats_t (2, Ct) = m3 v3. Scratch: wpack bf16,
// 2*Ct*P + 9*P*P elements; part float32, ceil(H*W/128) * 2 * max(P, Ct); coef float32,
// 4 * (2*P + Ct); tickets: zeroed int32, one per N tile of the widest GEMM, left zero;
// h bf16 H*W*P (h1, then h2). vec 1 (Ct and P multiples of 8, every pointer 16-byte
// aligned) takes the wgmma path, sched = {bn1, bn2, bn3} its GEMMs' tile widths
// (ops/kernels/conv3x3.py::fwd_tiles); vec 0 the first port's kernels (sched, tickets
// and h unread). Returns the first launch error (0 on success).
int simt_bneck_fwd(const void* x, const void* w1, const void* w2, const void* w3, int w_bf16,
                   const float* g1, const float* b1, const float* g2, const float* b2,
                   const float* g3, const float* b3, void* out, void* h1raw, void* h2raw,
                   float* stats_p, float* stats_t, void* wpack, float* part, float* coef,
                   int* tickets, void* h, int H, int W, int Ct, int P, int d, int vec,
                   const int* sched, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = H * W;
  if (M == 0 || Ct == 0 || P == 0) return 0;
  const long long MCt = static_cast<long long>(M) * Ct;
  bf16* pw1 = static_cast<bf16*>(wpack);
  bf16* pw2 = pw1 + static_cast<long long>(Ct) * P;
  bf16* pw3 = pw2 + 9LL * P * P;
  float* coef1 = coef;
  float* coef2 = coef1 + 4 * P;
  float* coef3 = coef2 + 4 * P;
  PrepArgs pa{};
  pa.src_bf16 = w_bf16;
  pa.packs = 3;
  if (vec) {
    // K-major (N, taps, K): conv1 (P, 1, Ct), conv2 (P, 9, P), conv3 (Ct, 1, P).
    pa.pack[0] = pack_job(w1, pw1, P, 1, Ct, 0, Ct, 0, 1);
    pa.pack[1] = pack_job(w2, pw2, P, 9, P, 0, 9LL * P, 1, 9);
    pa.pack[2] = pack_job(w3, pw3, Ct, 1, P, 0, P, 0, 1);
    CHECK(prep(pa, s));
    const long long MP = static_cast<long long>(M) * P;
    HArgs a1 = hargs(h1raw, part, tickets, H, W, Ct, P, 1, d);
    a1.g = g1, a1.b = b1, a1.out0 = stats_p, a1.out1 = stats_p + P, a1.out2 = coef1;
    CHECK(hgemm(kStore, sched[0], x, pw1, a1, s));
    CHECK(bn_relu_pass(h1raw, h, coef1, nullptr, nullptr, nullptr, MP, P, s));  // h1
    HArgs a2 = hargs(h2raw, part, tickets, H, W, P, P, 9, d);
    a2.g = g2, a2.b = b2, a2.out0 = stats_p + 2 * P, a2.out1 = stats_p + 3 * P,
    a2.out2 = coef2;
    CHECK(hgemm(kStore, sched[1], h, pw2, a2, s));
    CHECK(bn_relu_pass(h2raw, h, coef2, nullptr, nullptr, nullptr, MP, P, s));  // h2
    HArgs a3 = hargs(out, part, tickets, H, W, P, Ct, 1, d);
    a3.g = g3, a3.b = b3, a3.out0 = stats_t, a3.out1 = stats_t + Ct, a3.out2 = coef3;
    CHECK(hgemm(kStore, sched[2], h, pw3, a3, s));
    return residual(8, out, x, MCt, Ct, coef3, s);
  }

  // (taps, K, N): conv1 (1, Ct, P), conv2 (9, P, P), conv3 (1, P, Ct).
  pa.pack[0] = pack_job(w1, pw1, 1, Ct, P, 0, 0, 1, Ct);
  pa.pack[1] = pack_job(w2, pw2, 9, P, P, 0, 1, 9, 9LL * P);
  pa.pack[2] = pack_job(w3, pw3, 1, P, Ct, 0, 0, 1, P);
  CHECK(prep(pa, s));
  const float m = static_cast<float>(M);
  const int nb = mblocks(M);
  CHECK(gemm(kStore, gemm_args(x, nullptr, nullptr, pw1, h1raw, part, H, W, Ct, P, 1, d), s));
  bneck_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, g1, b1, stats_p,
                                                     stats_p + P, coef1);
  CHECK(last_error());
  CHECK(gemm(kStore, gemm_args(h1raw, coef1, coef1 + P, pw2, h2raw, part, H, W, P, P, 9, d), s));
  bneck_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, g2, b2,
                                                     stats_p + 2 * P, stats_p + 3 * P, coef2);
  CHECK(last_error());
  CHECK(gemm(kStore, gemm_args(h2raw, coef2, coef2 + P, pw3, out, part, H, W, P, Ct, 1, d), s));
  bneck_stats_kernel<<<(Ct + 255) / 256, 256, 0, s>>>(part, nb, Ct, m, g3, b3, stats_t,
                                                      stats_t + Ct, coef3);
  CHECK(last_error());
  return residual(1, out, x, MCt, Ct, coef3, s);
}

// B7. Inputs as simt_bneck_fwd, plus dy (H*W, Ct) bf16 and B6's h1raw, h2raw, stats_p,
// stats_t. Writes dx (H*W, Ct) bf16 (dz3 only, when need_dx is 0), dw1 (P, Ct, 1, 1),
// dw2 (P, P, 3, 3), dw3 (Ct, P, 1, 1) float32 (each skipped when its pointer is null),
// dgb_p (4, P) = dg1 db1 dg2 db2 and dgb_t (2, Ct) = dg3 db3. Scratch: wpack bf16,
// 3*Ct*P + 9*P*P; big bf16 H*W*Ct (outraw, then dor3); s2, s1 bf16 H*W*P each (dz2 then
// dor2; dz1 then dor1); part float32 as B6; wpart float32, the largest
// splits * taps * C * O of the weight gradients asked for (unread at one split on the
// wgmma path); coef float32, 6 * (2*P + Ct); tickets as B6, also one per weight-gradient
// tile; h1, h2 bf16 H*W*P each (the wgmma path's BatchNorm'd operands). sched: {bn of
// outraw, dh2, dh1, dx} then {bc, bo, splits, span} of dw1, dw2, dw3
// (ops/kernels/bottleneck.py::schedule); on the first port's path (vec 0) only the
// splits and spans are read, and h1, h2 are unread.
int simt_bneck_bwd(const void* x, const void* dy, const void* w1, const void* w2,
                   const void* w3, int w_bf16, const float* g1, const float* b1,
                   const float* g2, const float* b2, const float* g3, const float* b3,
                   const void* h1raw, const void* h2raw, const float* stats_p,
                   const float* stats_t, void* dx, float* dw1, float* dw2, float* dw3,
                   float* dgb_p, float* dgb_t, void* wpack, void* big, void* s2, void* s1,
                   float* part, float* wpart, float* coef, int* tickets, void* h1, void* h2,
                   int H, int W, int Ct, int P, int d, int need_dx, int vec,
                   const int* sched, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = H * W;
  if (M == 0 || Ct == 0 || P == 0) return 0;
  const float m = static_cast<float>(M);
  const long long MCt = static_cast<long long>(M) * Ct, MP = static_cast<long long>(M) * P;
  bf16* pw3 = static_cast<bf16*>(wpack);              // outraw = h2 w3^T
  bf16* pw3t = pw3 + static_cast<long long>(P) * Ct;  // dh2 = dor3 w3
  bf16* pw2f = pw3t + static_cast<long long>(Ct) * P;  // dh1: flipped, io-swapped
  bf16* pw1t = pw2f + 9LL * P * P;                    // dx += dor1 w1
  float* coef1 = coef;
  float* coef2 = coef1 + 4 * P;
  float* coef3 = coef2 + 4 * P;
  float* sq1 = coef3 + 4 * Ct;
  float* sq2 = sq1 + 2 * P;
  float* sq3 = sq2 + 2 * P;
  const int* ws1 = sched + 4;  // {bc, bo, splits, span} of dw1, dw2, dw3
  const int* ws2 = sched + 8;
  const int* ws3 = sched + 12;
  PrepArgs pa{};
  pa.src_bf16 = w_bf16;
  pa.packs = 4;
  pa.coefs = 3;
  pa.coef[0] = CoefJob{stats_p, stats_p + P, g1, b1, coef1, P};
  pa.coef[1] = CoefJob{stats_p + 2 * P, stats_p + 3 * P, g2, b2, coef2, P};
  pa.coef[2] = CoefJob{stats_t, stats_t + Ct, g3, b3, coef3, Ct};
  if (vec) {
    // K-major (N, taps, K): outraw (Ct, 1, P), dh2 (P, 1, Ct), dh1 (P, 9, P) with
    // B[c][t][o] = w2[o][c][8 - t], dx (Ct, 1, P).
    pa.pack[0] = pack_job(w3, pw3, Ct, 1, P, 0, P, 0, 1);
    pa.pack[1] = pack_job(w3, pw3t, P, 1, Ct, 0, 1, 0, P);
    pa.pack[2] = pack_job(w2, pw2f, P, 9, P, 8, 9, -1, 9LL * P);
    pa.pack[3] = pack_job(w1, pw1t, Ct, 1, P, 0, 1, 0, Ct);
    CHECK(prep(pa, s));
    CHECK(bn_relu_pass(h1raw, h1, coef1, h2raw, h2, coef2, MP, P, s));

    // Stage 3: outraw (recomputed) into big, dz3 into dx, dg3/db3; dor3 over outraw; dw3.
    HArgs a3 = hargs(big, part, tickets, H, W, P, Ct, 1, d);
    a3.ex = static_cast<const bf16*>(x);
    a3.edy = static_cast<const bf16*>(dy);
    a3.edz = static_cast<bf16*>(dx);
    a3.coef = coef3;
    a3.out0 = dgb_t, a3.out1 = dgb_t + Ct, a3.out2 = sq3;
    CHECK(hgemm(kDz3, sched[0], h2, pw3, a3, s));
    CHECK(dor(8, dx, big, big, MCt, Ct, coef3, sq3, s));
    if (dw3 != nullptr)
      CHECK(hwgrad(ws3, h2, big, wpart, tickets, dw3, H, W, P, Ct, 1, d, s));

    // Stage 2: dz2 = mask2 * dor3 w3, dg2/db2; dor2 in place; dw2.
    HArgs a2 = hargs(s2, part, tickets, H, W, Ct, P, 1, d);
    a2.ex = static_cast<const bf16*>(h2raw);
    a2.coef = coef2;
    a2.out0 = dgb_p + 2 * P, a2.out1 = dgb_p + 3 * P, a2.out2 = sq2;
    CHECK(hgemm(kDzMask, sched[1], big, pw3t, a2, s));
    CHECK(dor(8, s2, h2raw, s2, MP, P, coef2, sq2, s));
    if (dw2 != nullptr)
      CHECK(hwgrad(ws2, h1, s2, wpart, tickets, dw2, H, W, P, P, 9, d, s));

    // Stage 1: dz1 = mask1 * conv_T(dor2), dg1/db1; dor1 in place; dw1.
    HArgs a1 = hargs(s1, part, tickets, H, W, P, P, 9, d);
    a1.ex = static_cast<const bf16*>(h1raw);
    a1.coef = coef1;
    a1.out0 = dgb_p, a1.out1 = dgb_p + P, a1.out2 = sq1;
    CHECK(hgemm(kDzMask, sched[2], s2, pw2f, a1, s));
    CHECK(dor(8, s1, h1raw, s1, MP, P, coef1, sq1, s));
    if (dw1 != nullptr)
      CHECK(hwgrad(ws1, x, s1, wpart, tickets, dw1, H, W, Ct, P, 1, d, s));

    // dx = bf16(dz3 + dor1 w1^T), in place over dz3.
    if (need_dx)
      CHECK(hgemm(kAddDx, sched[3], s1, pw1t,
                  hargs(dx, nullptr, nullptr, H, W, P, Ct, 1, d), s));
    return 0;
  }

  // (taps, K, N): outraw (1, P, Ct), dh2 (1, Ct, P), dh1 (9, P, P) flipped, dx (1, P, Ct).
  pa.pack[0] = pack_job(w3, pw3, 1, P, Ct, 0, 0, 1, P);
  pa.pack[1] = pack_job(w3, pw3t, 1, Ct, P, 0, 0, P, 1);
  pa.pack[2] = pack_job(w2, pw2f, 9, P, P, 8, -1, 9LL * P, 9);
  pa.pack[3] = pack_job(w1, pw1t, 1, P, Ct, 0, 0, Ct, 1);
  CHECK(prep(pa, s));
  const int nb = mblocks(M);

  GemmArgs a3 = gemm_args(h2raw, coef2, coef2 + P, pw3, big, part, H, W, P, Ct, 1, d);
  a3.ex = static_cast<const bf16*>(x);
  a3.edy = static_cast<const bf16*>(dy);
  a3.edz = static_cast<bf16*>(dx);
  a3.coef = coef3;
  CHECK(gemm(kDz3, a3, s));
  bneck_grad_stats_kernel<<<(Ct + 255) / 256, 256, 0, s>>>(part, nb, Ct, m, dgb_t,
                                                           dgb_t + Ct, sq3);
  CHECK(last_error());
  CHECK(dor(1, dx, big, big, MCt, Ct, coef3, sq3, s));
  if (dw3 != nullptr)
    CHECK(wgrad(h2raw, coef2, coef2 + P, big, wpart, dw3, H, W, P, Ct, 1, d, ws3[2], ws3[3],
                0, 1, P, s));

  GemmArgs a2 = gemm_args(big, nullptr, nullptr, pw3t, s2, part, H, W, Ct, P, 1, d);
  a2.ex = static_cast<const bf16*>(h2raw);
  a2.coef = coef2;
  CHECK(gemm(kDzMask, a2, s));
  bneck_grad_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, dgb_p + 2 * P,
                                                          dgb_p + 3 * P, sq2);
  CHECK(last_error());
  CHECK(dor(1, s2, h2raw, s2, MP, P, coef2, sq2, s));
  if (dw2 != nullptr)
    CHECK(wgrad(h1raw, coef1, coef1 + P, s2, wpart, dw2, H, W, P, P, 9, d, ws2[2], ws2[3], 1,
                9, 9LL * P, s));

  GemmArgs a1 = gemm_args(s2, nullptr, nullptr, pw2f, s1, part, H, W, P, P, 9, d);
  a1.ex = static_cast<const bf16*>(h1raw);
  a1.coef = coef1;
  CHECK(gemm(kDzMask, a1, s));
  bneck_grad_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, dgb_p, dgb_p + P,
                                                          sq1);
  CHECK(last_error());
  CHECK(dor(1, s1, h1raw, s1, MP, P, coef1, sq1, s));
  if (dw1 != nullptr)
    CHECK(wgrad(x, nullptr, nullptr, s1, wpart, dw1, H, W, Ct, P, 1, d, ws1[2], ws1[3], 0, 1,
                Ct, s));

  if (need_dx)
    CHECK(gemm(kAddDx, gemm_args(s1, nullptr, nullptr, pw1t, dx, nullptr, H, W, P, Ct, 1, d),
               s));
  return 0;
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
