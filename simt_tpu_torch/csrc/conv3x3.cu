// Stride-1 SAME dilated 3x3 convolution for Hopper (sm_90a): the forward and input
// gradient (B4) and the weight gradient (B5) of every bottleneck's conv2.
//
// Replaces: experiments/pallas_alternates/conv3x3.py::_fwd_kernel (launched by
// _conv_fwd_2d, wrapped by dilated_conv3x3; its dx is the same kernel on the flipped,
// io-transposed weight) and ::_wgrad_kernel (launched by _conv_wgrad_2d). They are the
// Pallas form of simt_tpu/ops/conv.py::dilated_conv3x3_taps, the op
// simt_tpu/models/layers.py calls for every bottleneck's 3x3 conv. The Pallas kernels
// keep the whole padded image in VMEM; here a tap's shift is an address offset and the
// padding is the zeros a load produces where the shifted (h, w) leaves the image (d on
// each side, possibly wider than the image).
//
// Layout: activations NHWC (an NCHW tensor in channels_last memory). Operands bf16 or
// float32, products summed in float32, y and dx rounded once, dw float32.
//
// Bound on an H100 SXM in bf16 (989 TFLOP/s dense, 3.35 TB/s), per call at batch 1
// (ops = 2 * pixels * 9 * C * O): layer1 129x257, C = O = 64: 2.44 GFLOP, 8.6 MB,
// 2.6 us (bytes); layer2 65x129x128: 2.5 us; layer3 65x129x256 (d 2): 10.0 us; layer4
// 65x129x512 (d 4): 40.0 us (operations). So layers 2-4 are bound by the tensor cores,
// whose full rate only wgmma reaches, and only when shared memory is refilled as fast
// as it drains: the first port's synchronous staging and 16x16x16 wmma ran 4-12x off.
//
// bf16 with channel counts that are multiples of 8 and 16-byte-aligned tensors (every
// trunk geometry) takes the wgmma kernels. One producer thread keeps a ring of stages
// in flight with TMA (128-byte swizzle, mbarrier completion): the activation rows of
// the flat (B*H*W, C) tensor at the tap's offset dh*W + dw, and the unshifted operand.
// A flat offset wraps across image rows, so before a stage is used each consumer
// thread zeroes its half of a row wherever that pixel's shifted (h, w) leaves the
// image: the padding test is on (h, w), never on the flat index (TMA already gives
// zeros before the first and past the last pixel). Two consumer warpgroups (one for a
// 64-row B5 tile) then run wgmma k16 steps from shared memory and release the stage.
//   - B4 (conv3x3_fwd_wgmma_kernel): implicit GEMM, M = B*H*W pixels, N output
//     channels, K = 9 * Ck run taps outer and 64-channel chunks inner. Tiles of 128
//     pixels x BN, BN (64, 128 or 256) chosen by the wrapper from the shapes (at
//     512x1024, layers 2-4: 132 tiles, one wave). The weight is (N, 9, Ck), K-major,
//     one wrapper-side permute of the OIHW parameter; dx reads the io-transposed
//     weight's taps in reverse instead of a flipped copy. The epilogue rounds once to
//     bf16 through shared memory into 16-byte stores.
//   - B5 (conv3x3_wgrad_wgmma_kernel): per tap, dw[tap] (C x O) = x_shift^T g over the
//     pixels, both operands MN-major; grid split x (C tile x O tile) x tap, the tile and
//     split count chosen by the wrapper from the shapes alone. The last split of a
//     tile to finish (an integer ticket per tile) adds the splits' float32 partials in
//     split order through shared memory and writes OIHW: deterministic, no float
//     atomics, one launch.
// float32 (IEEE FMAs on the CUDA cores, no TF32) and bf16 off the vector width keep the
// first port's kernels (conv3x3_fwd_kernel, conv3x3_wgrad_kernel: 128x64 and 64x64
// tiles staged synchronously, nvcuda::wmma for bf16), with the same in-kernel split
// finish for B5. The Hopper building blocks (mbarriers, TMA, wgmma, the split finish and
// B5's pipeline, wgrad_wgmma) live in hopper.cuh, shared with bottleneck.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// A load unit: 16 bytes (EV elements) on the vector path, one element otherwise.
template <typename T, int EV>
struct Unit {
  using type = uint4;
  __device__ static type zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <typename T>
struct Unit<T, 1> {
  using type = T;
  __device__ static type zero() { return from_f<T>(0.0f); }
};

// ---------------------------------------------------------------------------------
// B4: y[m][n] = sum_tap sum_k x(m shifted by tap)[k] * wk[tap][k][n]
// ---------------------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 64, F_BK = 32, F_THREADS = 256;

template <typename T>
struct FwdSmem {
  static constexpr bool kBF16 = std::is_same<T, bf16>::value;
  static constexpr int A_LD = F_BK + (kBF16 ? 8 : 4);  // row pitch, elements
  static constexpr int B_LD = F_BN + (kBF16 ? 8 : 4);
  static constexpr int C_LD = F_BN + 4;  // float32 staging of the accumulators
  static constexpr int A_BYTES = F_BM * A_LD * static_cast<int>(sizeof(T));
  static constexpr int B_BYTES = F_BK * B_LD * static_cast<int>(sizeof(T));
  static constexpr int C_BYTES = kBF16 ? F_BM * C_LD * 4 : 0;
  static constexpr int BYTES = (A_BYTES + B_BYTES > C_BYTES) ? A_BYTES + B_BYTES : C_BYTES;
};

// EV: elements per load unit: 4 for float32 when Ck and N are multiples of 4 and the
// pointers are 16-byte aligned, else 1 (bf16 takes this kernel only off the vector
// width; on it, bf16 goes to conv3x3_fwd_wgmma_kernel).
template <typename T, int EV>
__global__ void __launch_bounds__(F_THREADS) conv3x3_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wk, T* __restrict__ y, int B, int H,
    int W, int Ck, int N, int d) {
  using S = FwdSmem<T>;
  using U = Unit<T, EV>;
  using UT = typename U::type;
  constexpr int UA = F_BK / EV / 2;  // A units per thread: one pixel, half a row
  constexpr int UB = F_BN / EV / 8;  // B units per thread: one k row, an eighth of it
  __shared__ __align__(128) unsigned char smem[S::BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + S::A_BYTES);

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * F_BM;
  const int n0 = blockIdx.y * F_BN;

  // This thread's A pixel (fixed for the whole block) and B row.
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long am = m0 + a_row;
  int a_b = -1, a_h = 0, a_w = 0;
  if (am < M) {
    a_w = static_cast<int>(am % W);
    const long long bh = am / W;
    a_h = static_cast<int>(bh % H);
    a_b = static_cast<int>(bh / H);
  }
  const int b_row = tid >> 3, b_part = tid & 7;

  const int kchunks = (Ck + F_BK - 1) / F_BK;
  const int n_it = 9 * kchunks;
  UT ra[UA], rb[UB];

  auto load = [&](int it) {
    const int tap = it / kchunks;
    const int c0 = (it - tap * kchunks) * F_BK;
    const int hs = a_h + (tap / 3 - 1) * d;
    const int ws = a_w + (tap % 3 - 1) * d;
    const bool pix = a_b >= 0 && hs >= 0 && hs < H && ws >= 0 && ws < W;
    const long long abase = ((static_cast<long long>(a_b) * H + hs) * W + ws) * Ck;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int k = c0 + (a_half * UA + u) * EV;
      ra[u] = (pix && k < Ck) ? *reinterpret_cast<const UT*>(x + abase + k) : U::zero();
    }
    const int k = c0 + b_row;
    const T* wrow = wk + (static_cast<long long>(tap) * Ck + k) * N;
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int n = n0 + (b_part * UB + u) * EV;
      rb[u] = (k < Ck && n < N) ? *reinterpret_cast<const UT*>(wrow + n) : U::zero();
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < UA; ++u)
      *reinterpret_cast<UT*>(As + a_row * S::A_LD + (a_half * UA + u) * EV) = ra[u];
#pragma unroll
    for (int u = 0; u < UB; ++u)
      *reinterpret_cast<UT*>(Bs + b_row * S::B_LD + (b_part * UB + u) * EV) = rb[u];
  };

  if constexpr (S::kBF16) {
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
      for (int kk = 0; kk < F_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * S::A_LD + kk, S::A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * S::B_LD + wn * 32 + j * 16, S::B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
      if (it + 1 < n_it) {
        store();
        __syncthreads();
      }
    }
    // Epilogue: accumulators -> shared float32 tile -> rounded, bounds-checked stores.
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * S::C_LD + wn * 32 + j * 16,
                                acc[i][j], S::C_LD, wmma::mem_row_major);
    __syncthreads();
    const int row = tid >> 1, col0 = (tid & 1) * 32;
    const long long m = m0 + row;
    if (m < M) {
      T* yrow = y + m * N;
      const float* crow = Cs + row * S::C_LD;
      for (int c = col0; c < col0 + 32; ++c)
        if (n0 + c < N) yrow[n0 + c] = from_f<T>(crow[c]);
    }
  } else {
    // float32: thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3.
    const int ty = tid >> 4, tx = tid & 15;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    load(0);
    store();
    __syncthreads();
    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) load(it + 1);
#pragma unroll 8
      for (int k = 0; k < F_BK; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + k * S::B_LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = As[(ty * 8 + i) * S::A_LD + k];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();
      if (it + 1 < n_it) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty * 8 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) y[m * N + n] = from_f<T>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------------
// B5: part[s][tap][c][o] = sum over split s's pixels p of x(p shifted by tap)[c] * g[p][o]
// ---------------------------------------------------------------------------------

constexpr int G_BC = 64, G_BO = 64, G_BP = 32, G_THREADS = 128;

template <typename T>
struct GradSmem {
  static constexpr bool kBF16 = std::is_same<T, bf16>::value;
  static constexpr int LD = 64 + (kBF16 ? 8 : 4);  // row pitch of both tiles
  static constexpr int C_LD = G_BO + 4;
  static constexpr int TILE_BYTES = G_BP * LD * static_cast<int>(sizeof(T));
  static constexpr int C_BYTES = kBF16 ? G_BC * C_LD * 4 : 0;
  static constexpr int BYTES = (2 * TILE_BYTES > C_BYTES) ? 2 * TILE_BYTES : C_BYTES;
  static_assert(BYTES >= G_BC * (G_BO + 1) * 4, "the split finish's tile fits");
};

template <typename T, int EV>
__global__ void __launch_bounds__(G_THREADS) conv3x3_wgrad_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
    int* __restrict__ tickets, float* __restrict__ dw, int B, int H, int W, int C, int O,
    int d, int pix_per_split) {
  using S = GradSmem<T>;
  using U = Unit<T, EV>;
  using UT = typename U::type;
  constexpr int UPT = 64 / EV / 4;  // units per thread per tile: a quarter row
  __shared__ __align__(128) unsigned char smem[S::BYTES];
  T* As = reinterpret_cast<T*>(smem);                   // [pixel][c]
  T* Bs = reinterpret_cast<T*>(smem + S::TILE_BYTES);   // [pixel][o]

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int c_tiles = (C + G_BC - 1) / G_BC;
  const int c0 = (blockIdx.y % c_tiles) * G_BC;
  const int o0 = (blockIdx.y / c_tiles) * G_BO;
  const int tap = blockIdx.z;
  const int sh = (tap / 3 - 1) * d, sw = (tap % 3 - 1) * d;
  const long long M = static_cast<long long>(B) * H * W;
  const long long p_begin = static_cast<long long>(split) * pix_per_split;
  const long long p_end = p_begin + pix_per_split < M ? p_begin + pix_per_split : M;
  const int n_it = p_end > p_begin
                       ? static_cast<int>((p_end - p_begin + G_BP - 1) / G_BP) : 0;

  const int row = tid >> 2, quarter = tid & 3;  // this thread's pixel row and columns
  UT ra[UPT], rb[UPT];

  auto load = [&](int it) {
    const long long p = p_begin + static_cast<long long>(it) * G_BP + row;
    bool ok = p < p_end;
    long long src = 0;
    if (ok) {
      const int w = static_cast<int>(p % W);
      const long long bh = p / W;
      const int h = static_cast<int>(bh % H);
      const int hs = h + sh, ws = w + sw;
      src = (bh - h + hs) * W + ws;  // (b*H + hs)*W + ws
      ok = hs >= 0 && hs < H && ws >= 0 && ws < W;
    }
    const bool in_img = p < p_end;
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int col = (quarter * UPT + u) * EV;
      ra[u] = (ok && c0 + col < C)
                  ? *reinterpret_cast<const UT*>(x + src * C + c0 + col) : U::zero();
      rb[u] = (in_img && o0 + col < O)
                  ? *reinterpret_cast<const UT*>(g + p * O + o0 + col) : U::zero();
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int col = (quarter * UPT + u) * EV;
      *reinterpret_cast<UT*>(As + row * S::LD + col) = ra[u];
      *reinterpret_cast<UT*>(Bs + row * S::LD + col) = rb[u];
    }
  };

  float* out = part + ((static_cast<long long>(split) * 9 + tap) * C) * O;
  if constexpr (S::kBF16) {
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
        // A = x_shift^T (c x pixel): column-major view of the [pixel][c] tile.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + kk * S::LD + wc * 32 + i * 16, S::LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * S::LD + wo * 32 + j * 16, S::LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
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
        wmma::store_matrix_sync(Cs + (wc * 32 + i * 16) * S::C_LD + wo * 32 + j * 16,
                                acc[i][j], S::C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < G_BC * G_BO; e += G_THREADS) {
      const int r = e / G_BO, q = e % G_BO;
      if (c0 + r < C && o0 + q < O)
        out[static_cast<long long>(c0 + r) * O + o0 + q] = Cs[r * S::C_LD + q];
    }
  } else {
    // float32: thread (ty, tx) owns c rows ty*8 .. ty*8+7 and o columns tx*4 .. tx*4+3.
    const int ty = tid >> 4, tx = tid & 15;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if (n_it > 0) {
      load(0);
      store();
    }
    __syncthreads();
    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) load(it + 1);
#pragma unroll 8
      for (int k = 0; k < G_BP; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + k * S::LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = As[k * S::LD + ty * 8 + i];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();
      if (it + 1 < n_it) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + ty * 8 + i;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + tx * 4 + j;
        if (o < O) out[static_cast<long long>(c) * O + o] = acc[i][j];
      }
    }
  }
  __shared__ int last;
  finish_split_tile<1>(part, dw, tickets + tap * gridDim.y + blockIdx.y, &last,
                       reinterpret_cast<float*>(smem), G_BO + 1, tid, G_THREADS,
                       [] { __syncthreads(); }, gridDim.x, 9, tap, C, O, c0, G_BC, o0,
                       G_BO);
}

// ---------------------------------------------------------------------------------
// B4 on wgmma (bf16, Ck and N multiples of 8): y[m][n] = sum over (tap, k) of
// x(m shifted by tap)[k] * wt[n][tap][k]
// ---------------------------------------------------------------------------------

template <int BN>
struct FwdCfg {
  static constexpr int A_BYTES = H_BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = BN == 256 ? 4 : (BN == 128 ? 6 : 8);  // stages: <= 192 KB
  static constexpr int SMEM = ST * STAGE + 2 * ST * 8 + 1024;
  static_assert((BN + 8) * 2 * 64 * 2 <= ST * STAGE, "epilogue tile fits the ring");
};

// One block: a 128-pixel x BN-channel output tile. The K loop runs the nine taps outer
// and Ck in chunks of 64 inner, through a ring of ST stages in shared memory:
//   - one producer thread has TMA load both operands of a stage: the 128 input rows
//     x[m0 + dh*W + dw ...][c0 .. c0+64) of the flat (B*H*W, Ck) tensor (zeros past
//     Ck and outside 0 .. M-1) and the weight slice wt[n0 .. n0+BN)[tap][c0 .. c0+64)
//     (zeros past N and Ck; for dx, whose weight is the io-transposed one unflipped,
//     the slice of tap 8 - tap), reporting both to the stage's `full` barrier;
//   - the flat shift wraps across image rows, so each consumer thread then zeroes its
//     half of one row wherever the output pixel's shifted (h, w) leaves the image: the
//     padding test is on (h, w), never on the flat index;
//   - consumer warpgroup w multiplies its 64 rows by the slice with four wgmma k16
//     steps, keeps one group in flight, and releases the previous stage on `empty`.
// Epilogue: the accumulators round once to bf16 into shared memory, then 16-byte stores
// with the ragged M edge masked.
template <int BN>
__global__ void __launch_bounds__(H_THREADS, 1) conv3x3_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    bf16* __restrict__ y, int B, int H, int W, int Ck, int N, int d, int flip) {
  using Cfg = FwdCfg<BN>;
  constexpr int ST = Cfg::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * Cfg::STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * H_BM;
  const int n0 = blockIdx.y * BN;
  const int kchunks = (Ck + H_BK - 1) / H_BK;
  const int n_it = 9 * kchunks;
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
      const long long shift = static_cast<long long>(tap / 3 - 1) * d * W + (tap % 3 - 1) * d;
      const uint32_t sa = sbase + s * Cfg::STAGE;
      mbar_arrive_expect_tx(&full[s], Cfg::STAGE);
      tma_load_2d(sa, &xmap, &full[s], c0, static_cast<int>(m0 + shift));
      tma_load_3d(sa + Cfg::A_BYTES, &wmap, &full[s], c0, flip ? 8 - tap : tap, n0);
    }
  } else {
    // Consumer warpgroup wg: output rows wg*64 .. wg*64+63 of the tile. This thread
    // clears half (eight 16-byte chunks' four) of row `row` where needed.
    const int wg = tid / 128, lt = tid % 128;
    const int row = wg * 64 + (lt >> 1), half = lt & 1;
    int rh = -1, rw = 0;  // the row's output pixel (h, w); rh -1 past M
    {
      const long long m = m0 + row;
      if (m < M) {
        const long long bh = m / W;
        rw = static_cast<int>(m - bh * W);
        rh = static_cast<int>(bh % H);
      }
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      const int tap = it / kchunks;
      mbar_wait(&full[s], (it / ST) & 1);
      const int hs = rh + (tap / 3 - 1) * d, ws = rw + (tap % 3 - 1) * d;
      if (rh >= 0 && (hs < 0 || hs >= H || ws < 0 || ws >= W)) {
        uint4* p = reinterpret_cast<uint4*>(smem + s * Cfg::STAGE + row * 128) + 4 * half;
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_sync(2 + wg, 128);
      const uint32_t sa = sbase + s * Cfg::STAGE + wg * 64 * 128;
      const uint32_t sb = sbase + s * Cfg::STAGE + Cfg::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma<BN, 0, 0>(acc, gmma_desc(sa + 32 * k, 16, 1024),
                        gmma_desc(sb + 32 * k, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(&empty[(it - 1) % ST]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Both consumer warpgroups are done with the ring; reuse it for the output tile.
    named_sync(1, H_CONSUMERS);
    constexpr int LD = BN + 8;  // row pitch in bf16: conflict-free fragment stores
    bf16* tile = reinterpret_cast<bf16*>(smem) + wg * 64 * LD;
    const int warp = lt / 32, lane = lt % 32;
    const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8 * i) * LD + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    named_sync(2 + wg, 128);
    for (int e = lt; e < 64 * (BN / 8); e += 128) {
      const int r = e / (BN / 8), q = e % (BN / 8);
      const long long m = m0 + wg * 64 + r;
      const int n = n0 + q * 8;
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(y + m * N + n) =
            *reinterpret_cast<const uint4*>(tile + r * LD + q * 8);
    }
  }
}

// ---------------------------------------------------------------------------------
// B5 on wgmma (bf16, C and O multiples of 8): for each tap, dw[tap] (C x O) =
// x_shift^T (C x pixels) * g (pixels x O), split over the pixels: hopper.cuh's
// wgrad_wgmma with nine taps
// ---------------------------------------------------------------------------------

template <int BC, int BO>
__global__ void __launch_bounds__(GradCfg<BC, BO>::THREADS, 1) conv3x3_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    float* __restrict__ part, int* __restrict__ tickets, float* __restrict__ dw, int B,
    int H, int W, int C, int O, int d, int pix_per_split) {
  wgrad_wgmma<BC, BO>(xmap, gmap, part, tickets, dw, B, H, W, C, O, 9, d, pix_per_split);
}

// ---------------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------------

template <typename T, int EV>
int launch_fwd(const void* x, const void* wk, void* y, int B, int H, int W, int Ck, int N,
               int d, cudaStream_t s) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + F_BM - 1) / F_BM),
                  static_cast<unsigned>((N + F_BN - 1) / F_BN));
  conv3x3_fwd_kernel<T, EV><<<grid, F_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<T*>(y), B, H, W,
      Ck, N, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EV>
int launch_wgrad(const void* x, const void* g, float* part, int* tickets, float* dw, int B,
                 int H, int W, int C, int O, int d, int splits, int pix_per_split,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(((C + G_BC - 1) / G_BC) * ((O + G_BO - 1) / G_BO)),
                  9);
  conv3x3_wgrad_kernel<T, EV><<<grid, G_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, tickets, dw, B, H, W, C, O,
      d, pix_per_split);
  return static_cast<int>(cudaGetLastError());
}


template <int BN>
int launch_fwd_wgmma(const void* x, const void* wt, void* y, int B, int H, int W, int Ck,
                     int N, int d, int flip, cudaStream_t s) {
  using Cfg = FwdCfg<BN>;
  static const int attr = opt_in_smem(conv3x3_fwd_wgmma_kernel<BN>, Cfg::SMEM);
  if (attr != 0) return attr;
  const long long M = static_cast<long long>(B) * H * W;
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Ck), 9, static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Ck) * 2,
                                 static_cast<cuuint64_t>(Ck) * 18};
  const cuuint32_t box[3] = {H_BK, 1, BN};
  int err = pixel_map(&xmap, x, M, Ck, H_BM);
  if (err == 0) err = make_map(&wmap, wt, 3, dims, strides, box);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((M + H_BM - 1) / H_BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  conv3x3_fwd_wgmma_kernel<BN><<<grid, H_THREADS, Cfg::SMEM, s>>>(
      xmap, wmap, static_cast<bf16*>(y), B, H, W, Ck, N, d, flip);
  return static_cast<int>(cudaGetLastError());
}

template <int BC, int BO>
int launch_wgrad_wgmma(const void* x, const void* g, float* part, int* tickets, float* dw,
                       int B, int H, int W, int C, int O, int d, int splits,
                       int pix_per_split, cudaStream_t s) {
  using Cfg = GradCfg<BC, BO>;
  static const int attr = opt_in_smem(conv3x3_wgrad_wgmma_kernel<BC, BO>, Cfg::SMEM);
  if (attr != 0) return attr;
  const long long M = static_cast<long long>(B) * H * W;
  CUtensorMap xmap, gmap;
  int err = pixel_map(&xmap, x, M, C, G_PIX);
  if (err == 0) err = pixel_map(&gmap, g, M, O, G_PIX);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(((C + BC - 1) / BC) * ((O + BO - 1) / BO)), 9);
  conv3x3_wgrad_wgmma_kernel<BC, BO><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(
      xmap, gmap, part, tickets, dw, B, H, W, C, O, d, pix_per_split);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// B4: y (B, H, W, N) = conv of x (B, H, W, Ck) with the weight wk, in one dtype
// (0 float32, 1 bfloat16). path 2, the wgmma kernel (bf16; Ck and N multiples of 8,
// 16-byte-aligned pointers): wk is (N, 9, Ck), each output channel's taps in a row,
// bn its tile width (64, 128 or 256), and flip 1 when wk is the io-transposed weight
// of dx, unflipped (tap t then reads wk's tap 8 - t). path 1 (float32, Ck and N
// multiples of 4, aligned) and path 0 (any): wk is the tap matrices (9, Ck, N), flip
// unread (already applied). Returns
// cudaGetLastError() after the launch (0 on success).
int simt_conv3x3_fwd(const void* x, const void* wk, void* y, int B, int H, int W, int Ck,
                     int N, int d, int dtype, int path, int bn, int flip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(B) * H * W == 0 || N == 0) return 0;
  if (path == 2) {
    if (dtype != 1 || Ck % 8 != 0 || N % 8 != 0) return kInvalid;
    switch (bn) {
      case 64: return launch_fwd_wgmma<64>(x, wk, y, B, H, W, Ck, N, d, flip, s);
      case 128: return launch_fwd_wgmma<128>(x, wk, y, B, H, W, Ck, N, d, flip, s);
      case 256: return launch_fwd_wgmma<256>(x, wk, y, B, H, W, Ck, N, d, flip, s);
      default: return kInvalid;
    }
  }
  if (dtype == 1 && path == 0) return launch_fwd<bf16, 1>(x, wk, y, B, H, W, Ck, N, d, s);
  if (dtype == 0) {
    return path == 1 ? launch_fwd<float, 4>(x, wk, y, B, H, W, Ck, N, d, s)
                     : launch_fwd<float, 1>(x, wk, y, B, H, W, Ck, N, d, s);
  }
  return kInvalid;
}

// B5: dw (O, C, 3, 3) float32 from x (B, H, W, C) and g (B, H, W, O) of one dtype.
// The pixel sum is cut into `splits` ranges of `span` pixels (the last fewer); part:
// splits * 9 * C * O floats of scratch (unread at one split on path 2); tickets: one
// int per (tap, C tile, O tile), zero on entry and left zero. path 2, the wgmma kernel
// (bf16, C and O multiples of 8, aligned): tiles bc x bo of 64x64, 128x128 or
// 128x256, span a multiple of 64. paths 1 / 0 as for B4, 64x64 tiles. Returns as
// simt_conv3x3_fwd.
int simt_conv3x3_wgrad(const void* x, const void* g, float* part, int* tickets, float* dw,
                       int B, int H, int W, int C, int O, int d, int splits, int span,
                       int dtype, int path, int bc, int bo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0 || O == 0) return 0;
  if (splits < 1 || span < 1) return kInvalid;
  if (path == 2) {
    if (dtype != 1 || C % 8 != 0 || O % 8 != 0 || span % G_PIX != 0) return kInvalid;
    if (bc == 64 && bo == 64)
      return launch_wgrad_wgmma<64, 64>(x, g, part, tickets, dw, B, H, W, C, O, d, splits,
                                        span, s);
    if (bc == 128 && bo == 128)
      return launch_wgrad_wgmma<128, 128>(x, g, part, tickets, dw, B, H, W, C, O, d, splits,
                                          span, s);
    if (bc == 128 && bo == 256)
      return launch_wgrad_wgmma<128, 256>(x, g, part, tickets, dw, B, H, W, C, O, d, splits,
                                          span, s);
    return kInvalid;
  }
  if (dtype == 1 && path == 0)
    return launch_wgrad<bf16, 1>(x, g, part, tickets, dw, B, H, W, C, O, d, splits, span, s);
  if (dtype == 0) {
    return path == 1
               ? launch_wgrad<float, 4>(x, g, part, tickets, dw, B, H, W, C, O, d, splits,
                                        span, s)
               : launch_wgrad<float, 1>(x, g, part, tickets, dw, B, H, W, C, O, d, splits,
                                        span, s);
  }
  return kInvalid;
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
