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
// intermediates, and the statistics go through fixed-order partials:
//   - bneck_gemm_kernel: an implicit GEMM, Y[m][n] = sum_tap sum_k A'(m shifted by
//     tap)[k] * B[tap][k][n], taps 1 (the 1x1 convs) or 9 (the dilated 3x3, zero
//     padding, which may be wider than the image). A' is the stored bf16 operand or,
//     with a prologue, bf16(relu(a*A + c)) applied as the tile is loaded (BN + ReLU of
//     the previous stage, never materialised); a tap that falls off the image loads 0,
//     the padding of the activation, not relu(c). 128x64 output tiles, 32-deep K
//     chunks in shared memory with a register prefetch, eight warps of 2x2
//     nvcuda::wmma 16x16x16 bf16 products, float32 accumulators (B4's tiling). The
//     epilogue rounds, stores and writes this tile's per-channel float32 column sums
//     (two statistics each: sum x and sum x^2 forward, sum dz and sum dz*xhat
//     backward) to a partials buffer, summed by rows in a fixed order;
//   - bneck_stats_kernel / bneck_grad_stats_kernel: add the partials in block order
//     (no float atomics: two runs give equal bits) and form the BatchNorm
//     coefficients (forward) or dg, db and the BN-backward terms (backward);
//   - bneck_wgrad_kernel + bneck_wgrad_reduce_kernel: the weight gradients contract
//     the pixels (dw1 = x^T dor1, dw3 = h2^T dor3, the nine taps of dw2 = h1_tap^T
//     dor2): B5's split-K over pixels into float32 partials, with the same BN + ReLU
//     prologue for h1/h2, then a second launch adds them in split order and writes
//     the OIHW gradient;
//   - bneck_residual_kernel (out = relu(a3*outraw + c3 + x), rounded once),
//     bneck_dor_kernel (dor = bf16(a*(dz - sum dz/m - xhat*sum(dz*xhat)/m))),
//     bneck_coef_kernel and bneck_pack_kernel (weights, float32 or bf16 in OIHW, to
//     the bf16 tap-major B layouts) are elementwise.
// Every product runs on the tensor cores inside these kernels; none goes to a library.
//
// Numerics follow the Pallas kernels: each conv output is rounded to bf16 before its
// statistics; mean = sum/m, var = sum x^2/m - mean^2 (biased); the affine
// a = g*rsqrt(var + 1e-5), c = b - mean*a is applied with separately rounded multiply
// and add (no FMA contraction), as the plain PyTorch version computes it. The backward
// recomputes h1, h2 and outraw = bf16(h2 w3) from the saved h1raw/h2raw (outraw is
// recomputed, not saved by B6: one GEMM of P x Ct per pixel instead of a 17.2 MB
// residual at layer3), takes the ReLU3 mask from z3 before rounding, stores dz3, dz2,
// dz1 and dor3, dor2, dor1 in bf16 at the Pallas kernel's points, and forms
// dx = bf16(dz3 + dor1 w1^T).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at layer3 (65x129,
// Ct 1024, P 256, d 2): forward 2*H*W*(2*Ct*P + 9*P^2) = 18.7 GFLOP, 19 us, against
// about 45 MB, 13 us, so the tensor cores bound it; backward about 41.8 GFLOP, 42 us.
// This first design keeps every product on the tensor cores but moves each
// intermediate through device memory (h1raw, h2raw, out, and in the backward outraw,
// dz/dor twice per stage) and stages tiles synchronously with 16x16x16 wmma, so it
// runs well above its bound; wgmma, TMA and fusing the elementwise passes into the
// GEMMs' prologues and epilogues are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------------
// The implicit GEMM with BN prologue and fused epilogues
// ---------------------------------------------------------------------------------

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = C_BYTES > A_BYTES + B_BYTES ? C_BYTES : A_BYTES + B_BYTES;

enum Epi {
  kStore = 0,   // y = bf16(acc); stats (sum y, sum y^2)
  kDz3 = 1,     // y = outraw = bf16(acc); z = a*outraw + c + x; dz = z > 0 ? dy : 0
  kDzMask = 2,  // dz = bf16(relu(a*raw + c)) > 0 ? acc : 0; y = bf16(dz)
  kAddDx = 3,   // y = bf16(y + acc) (dx = dz3 + dor1 w1^T), no statistics
};

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
// Statistics: partials summed in block order
// ---------------------------------------------------------------------------------

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

__global__ void bneck_coef_kernel(const float* __restrict__ mean, const float* __restrict__ var,
                                  const float* __restrict__ g, const float* __restrict__ b,
                                  float* __restrict__ coef, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) write_coef(coef, N, n, mean[n], var[n], g[n], b[n]);
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
// Elementwise passes
// ---------------------------------------------------------------------------------

// out = bf16(relu(a*out + c + x)); out holds outraw on entry.
__global__ void bneck_residual_kernel(bf16* out, const bf16* __restrict__ x, long long total,
                                      int N, const float* __restrict__ coef) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % N);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(f(out[i]), coef[n]), coef[N + n]),
                              f(x[i]));
    out[i] = b16(fmaxf(y, 0.0f));
  }
}

// out = bf16(a*(dz - sum dz/m - xhat*(sum dz*xhat/m))), xhat = (raw - mean)*inv; out
// may alias dz or raw.
__global__ void bneck_dor_kernel(const bf16* dz, const bf16* raw, bf16* out, long long total,
                                 int N, const float* __restrict__ coef,
                                 const float* __restrict__ sq) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % N);
    const float xhat = __fmul_rn(__fsub_rn(f(raw[i]), coef[2 * N + n]), coef[3 * N + n]);
    const float t = __fsub_rn(__fsub_rn(f(dz[i]), sq[n]), __fmul_rn(xhat, sq[N + n]));
    out[i] = b16(__fmul_rn(coef[n], t));
  }
}

// dst (T, K, N) bf16 = src[off + t*st + k*sk + n*sn], src float32 or bf16.
__global__ void bneck_pack_kernel(const void* __restrict__ src, int src_bf16,
                                  bf16* __restrict__ dst, int T, int K, int N, long long off,
                                  long long st, long long sk, long long sn) {
  const long long total = static_cast<long long>(T) * K * N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % N);
    const long long tk = i / N;
    const int k = static_cast<int>(tk % K);
    const int t = static_cast<int>(tk / K);
    const long long s = off + t * st + k * sk + n * sn;
    dst[i] = src_bf16 ? static_cast<const bf16*>(src)[s]
                      : b16(static_cast<const float*>(src)[s]);
  }
}

// ---------------------------------------------------------------------------------
// Weight gradients: part[s][tap][c][o] = sum over split s's pixels of
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
// Host side: one call per direction, every launch on the caller's stream
// ---------------------------------------------------------------------------------

int grid_1d(long long total) {
  const long long need = (total + 255) / 256;
  return static_cast<int>(need < 8192 ? need : 8192);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int mblocks(int M) { return (M + BM - 1) / BM; }

template <int EV>
int gemm(int epi, const GemmArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(mblocks(a.H * a.W)),
                  static_cast<unsigned>((a.N + BN - 1) / BN));
  switch (epi) {
    case kStore: bneck_gemm_kernel<EV, kStore><<<grid, THREADS, 0, s>>>(a); break;
    case kDz3: bneck_gemm_kernel<EV, kDz3><<<grid, THREADS, 0, s>>>(a); break;
    case kDzMask: bneck_gemm_kernel<EV, kDzMask><<<grid, THREADS, 0, s>>>(a); break;
    default: bneck_gemm_kernel<EV, kAddDx><<<grid, THREADS, 0, s>>>(a); break;
  }
  return last_error();
}

int run_gemm(int vec, int epi, const GemmArgs& a, cudaStream_t s) {
  return vec ? gemm<8>(epi, a, s) : gemm<1>(epi, a, s);
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

int pack(const void* src, int src_bf16, bf16* dst, int T, int K, int N, long long off,
         long long st, long long sk, long long sn, cudaStream_t s) {
  bneck_pack_kernel<<<grid_1d(static_cast<long long>(T) * K * N), 256, 0, s>>>(
      src, src_bf16, dst, T, K, N, off, st, sk, sn);
  return last_error();
}

// dw (OIHW float32, element strides sot/soc/soo) from A' (H*W, C) and G (H*W, O).
int wgrad(int vec, const void* a, const float* pa, const float* pc, const void* g,
          float* part, float* dw, int H, int W, int C, int O, int taps, int d, int splits,
          int per_split, long long sot, long long soc, long long soo, cudaStream_t s) {
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
  if (vec)
    bneck_wgrad_kernel<8><<<grid, G_THREADS, 0, s>>>(w);
  else
    bneck_wgrad_kernel<1><<<grid, G_THREADS, 0, s>>>(w);
  int err = last_error();
  if (err != 0) return err;
  bneck_wgrad_reduce_kernel<<<grid_1d(static_cast<long long>(taps) * C * O), 256, 0, s>>>(
      part, dw, taps, C, O, splits, sot, soc, soo);
  return last_error();
}

#define CHECK(call)            \
  do {                         \
    const int e_ = (call);     \
    if (e_ != 0) return e_;    \
  } while (0)

}  // namespace

extern "C" {

// B6. x (H*W, Ct) bf16 NHWC; w1 (P, Ct), w2 (P, P, 3, 3), w3 (Ct, P) OIHW, float32
// (w_bf16 0) or bf16 (1); g*, b* float32. Writes out (H*W, Ct), h1raw, h2raw (H*W, P)
// bf16, stats_p (4, P) = m1 v1 m2 v2 and stats_t (2, Ct) = m3 v3. Scratch: wpack bf16,
// 2*Ct*P + 9*P*P elements; part float32, ceil(H*W/128) * 2 * max(P, Ct); coef float32,
// 4 * (2*P + Ct). vec: 1 when Ct and P are multiples of 8 and every pointer is 16-byte
// aligned. Returns the first launch error (0 on success).
int simt_bneck_fwd(const void* x, const void* w1, const void* w2, const void* w3, int w_bf16,
                   const float* g1, const float* b1, const float* g2, const float* b2,
                   const float* g3, const float* b3, void* out, void* h1raw, void* h2raw,
                   float* stats_p, float* stats_t, void* wpack, float* part, float* coef,
                   int H, int W, int Ct, int P, int d, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = H * W;
  if (M == 0 || Ct == 0 || P == 0) return 0;
  const float m = static_cast<float>(M);
  bf16* pw1 = static_cast<bf16*>(wpack);  // (Ct, P)
  bf16* pw2 = pw1 + static_cast<long long>(Ct) * P;  // (9, P, P)
  bf16* pw3 = pw2 + 9LL * P * P;  // (P, Ct)
  float* coef1 = coef;
  float* coef2 = coef1 + 4 * P;
  float* coef3 = coef2 + 4 * P;
  CHECK(pack(w1, w_bf16, pw1, 1, Ct, P, 0, 0, 1, Ct, s));
  CHECK(pack(w2, w_bf16, pw2, 9, P, P, 0, 1, 9, 9LL * P, s));
  CHECK(pack(w3, w_bf16, pw3, 1, P, Ct, 0, 0, 1, P, s));
  const int nb = mblocks(M);

  CHECK(run_gemm(vec, kStore, gemm_args(x, nullptr, nullptr, pw1, h1raw, part, H, W, Ct, P, 1, d), s));
  bneck_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, g1, b1, stats_p,
                                                     stats_p + P, coef1);
  CHECK(last_error());
  CHECK(run_gemm(vec, kStore, gemm_args(h1raw, coef1, coef1 + P, pw2, h2raw, part, H, W, P, P, 9, d), s));
  bneck_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, g2, b2,
                                                     stats_p + 2 * P, stats_p + 3 * P, coef2);
  CHECK(last_error());
  CHECK(run_gemm(vec, kStore, gemm_args(h2raw, coef2, coef2 + P, pw3, out, part, H, W, P, Ct, 1, d), s));
  bneck_stats_kernel<<<(Ct + 255) / 256, 256, 0, s>>>(part, nb, Ct, m, g3, b3, stats_t,
                                                      stats_t + Ct, coef3);
  CHECK(last_error());
  bneck_residual_kernel<<<grid_1d(static_cast<long long>(M) * Ct), 256, 0, s>>>(
      static_cast<bf16*>(out), static_cast<const bf16*>(x), static_cast<long long>(M) * Ct,
      Ct, coef3);
  return last_error();
}

// B7. Inputs as simt_bneck_fwd, plus dy (H*W, Ct) bf16 and B6's h1raw, h2raw, stats_p,
// stats_t. Writes dx (H*W, Ct) bf16 (dz3 only, when need_dx is 0), dw1 (P, Ct, 1, 1),
// dw2 (P, P, 3, 3), dw3 (Ct, P, 1, 1) float32 (each skipped when its pointer is null),
// dgb_p (4, P) = dg1 db1 dg2 db2 and dgb_t (2, Ct) = dg3 db3. Scratch: wpack bf16,
// 3*Ct*P + 9*P*P; big bf16 H*W*Ct (outraw, then dor3); s2, s1 bf16 H*W*P each (dz2 then
// dor2; dz1 then dor1); part float32 as B6; wpart float32, the largest
// splits * taps * C * O of the weight gradients asked for; coef float32,
// 6 * (2*P + Ct). splitsK/perK: split count and pixels per split of dwK.
int simt_bneck_bwd(const void* x, const void* dy, const void* w1, const void* w2,
                   const void* w3, int w_bf16, const float* g1, const float* b1,
                   const float* g2, const float* b2, const float* g3, const float* b3,
                   const void* h1raw, const void* h2raw, const float* stats_p,
                   const float* stats_t, void* dx, float* dw1, float* dw2, float* dw3,
                   float* dgb_p, float* dgb_t, void* wpack, void* big, void* s2, void* s1,
                   float* part, float* wpart, float* coef, int H, int W, int Ct, int P,
                   int d, int splits1, int per1, int splits2, int per2, int splits3,
                   int per3, int need_dx, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = H * W;
  if (M == 0 || Ct == 0 || P == 0) return 0;
  const float m = static_cast<float>(M);
  const long long MCt = static_cast<long long>(M) * Ct, MP = static_cast<long long>(M) * P;
  bf16* pw3 = static_cast<bf16*>(wpack);            // (P, Ct): outraw = h2 w3^T
  bf16* pw3t = pw3 + static_cast<long long>(P) * Ct;  // (Ct, P): dh2 = dor3 w3
  bf16* pw2f = pw3t + static_cast<long long>(Ct) * P;  // (9, P, P): flipped, io-swapped
  bf16* pw1t = pw2f + 9LL * P * P;                   // (P, Ct): dor1 w1
  float* coef1 = coef;
  float* coef2 = coef1 + 4 * P;
  float* coef3 = coef2 + 4 * P;
  float* sq1 = coef3 + 4 * Ct;
  float* sq2 = sq1 + 2 * P;
  float* sq3 = sq2 + 2 * P;
  CHECK(pack(w3, w_bf16, pw3, 1, P, Ct, 0, 0, 1, P, s));
  CHECK(pack(w3, w_bf16, pw3t, 1, Ct, P, 0, 0, P, 1, s));
  CHECK(pack(w2, w_bf16, pw2f, 9, P, P, 8, -1, 9LL * P, 9, s));
  CHECK(pack(w1, w_bf16, pw1t, 1, P, Ct, 0, 0, Ct, 1, s));
  bneck_coef_kernel<<<(P + 255) / 256, 256, 0, s>>>(stats_p, stats_p + P, g1, b1, coef1, P);
  bneck_coef_kernel<<<(P + 255) / 256, 256, 0, s>>>(stats_p + 2 * P, stats_p + 3 * P, g2,
                                                    b2, coef2, P);
  bneck_coef_kernel<<<(Ct + 255) / 256, 256, 0, s>>>(stats_t, stats_t + Ct, g3, b3, coef3,
                                                     Ct);
  CHECK(last_error());
  const int nb = mblocks(M);

  // Stage 3: outraw (recomputed), dz3 into dx, dg3/db3, dor3 over outraw, dw3.
  GemmArgs a3 = gemm_args(h2raw, coef2, coef2 + P, pw3, big, part, H, W, P, Ct, 1, d);
  a3.ex = static_cast<const bf16*>(x);
  a3.edy = static_cast<const bf16*>(dy);
  a3.edz = static_cast<bf16*>(dx);
  a3.coef = coef3;
  CHECK(run_gemm(vec, kDz3, a3, s));
  bneck_grad_stats_kernel<<<(Ct + 255) / 256, 256, 0, s>>>(part, nb, Ct, m, dgb_t,
                                                           dgb_t + Ct, sq3);
  bneck_dor_kernel<<<grid_1d(MCt), 256, 0, s>>>(static_cast<const bf16*>(dx),
                                                static_cast<const bf16*>(big),
                                                static_cast<bf16*>(big), MCt, Ct, coef3, sq3);
  CHECK(last_error());
  if (dw3 != nullptr)
    CHECK(wgrad(vec, h2raw, coef2, coef2 + P, big, wpart, dw3, H, W, P, Ct, 1, d, splits3,
                per3, 0, 1, P, s));

  // Stage 2: dz2 = mask2 * dor3 w3, dg2/db2, dor2 in place, dw2.
  GemmArgs a2 = gemm_args(big, nullptr, nullptr, pw3t, s2, part, H, W, Ct, P, 1, d);
  a2.ex = static_cast<const bf16*>(h2raw);
  a2.coef = coef2;
  CHECK(run_gemm(vec, kDzMask, a2, s));
  bneck_grad_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, dgb_p + 2 * P,
                                                          dgb_p + 3 * P, sq2);
  bneck_dor_kernel<<<grid_1d(MP), 256, 0, s>>>(static_cast<const bf16*>(s2),
                                               static_cast<const bf16*>(h2raw),
                                               static_cast<bf16*>(s2), MP, P, coef2, sq2);
  CHECK(last_error());
  if (dw2 != nullptr)
    CHECK(wgrad(vec, h1raw, coef1, coef1 + P, s2, wpart, dw2, H, W, P, P, 9, d, splits2,
                per2, 1, 9, 9LL * P, s));

  // Stage 1: dz1 = mask1 * conv_T(dor2), dg1/db1, dor1 in place, dw1.
  GemmArgs a1 = gemm_args(s2, nullptr, nullptr, pw2f, s1, part, H, W, P, P, 9, d);
  a1.ex = static_cast<const bf16*>(h1raw);
  a1.coef = coef1;
  CHECK(run_gemm(vec, kDzMask, a1, s));
  bneck_grad_stats_kernel<<<(P + 255) / 256, 256, 0, s>>>(part, nb, P, m, dgb_p,
                                                          dgb_p + P, sq1);
  bneck_dor_kernel<<<grid_1d(MP), 256, 0, s>>>(static_cast<const bf16*>(s1),
                                               static_cast<const bf16*>(h1raw),
                                               static_cast<bf16*>(s1), MP, P, coef1, sq1);
  CHECK(last_error());
  if (dw1 != nullptr)
    CHECK(wgrad(vec, x, nullptr, nullptr, s1, wpart, dw1, H, W, Ct, P, 1, d, splits1, per1,
                0, 1, Ct, s));

  // dx = bf16(dz3 + dor1 w1^T), in place over dz3.
  if (need_dx)
    CHECK(run_gemm(vec, kAddDx,
                   gemm_args(s1, nullptr, nullptr, pw1t, dx, nullptr, H, W, P, Ct, 1, d), s));
  return 0;
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
