// Stride-1 SAME dilated 3x3 convolution for Hopper (sm_90a): the forward and input
// gradient (B4) and the weight gradient (B5) of every bottleneck's conv2.
//
// Replaces: experiments/pallas_alternates/conv3x3.py::_fwd_kernel (launched by
// _conv_fwd_2d, wrapped by dilated_conv3x3; its dx is the same kernel on the flipped,
// io-transposed weight) and ::_wgrad_kernel (launched by _conv_wgrad_2d). They are the
// Pallas form of simt_tpu/ops/conv.py::dilated_conv3x3_taps, the op
// simt_tpu/models/layers.py calls for every bottleneck's 3x3 conv.
//
// Layout: activations NHWC (an NCHW tensor in channels_last memory), weights as nine
// tap matrices wk[tap][k][n] (tap = kh*3 + kw), prepared by the wrapper with one small
// permute of the OIHW parameter (flipped and io-transposed for dx). Padding is d on each
// side and zeros; it may be wider than the image.
//
// B4 (conv3x3_fwd_kernel) is an implicit GEMM: M = B*H*W pixels, N output channels,
// K = 9 * Ck. A block owns a 128-pixel x 64-channel output tile and walks the nine taps
// and Ck in chunks of 32. Per step it stages the tap-shifted input rows (zero outside
// the image) and the weight slice in shared memory; the next step's tiles are loaded
// into registers while the tensor cores work on the current one. bf16: eight warps,
// each 32x32 of the tile as 2x2 nvcuda::wmma 16x16x16 bf16 products with float32
// accumulators. float32: the same tiles, each thread an 8x4 sub-tile of FMAs on the
// CUDA cores (no TF32). The result is rounded once to the output type.
//
// B5 (conv3x3_wgrad_kernel): dw[tap][c][o] = sum over pixels p of x(p shifted by tap)[c]
// * dy[p][o], a (C x O) product per tap with K = B*H*W. Grid: (split, C-tile x O-tile,
// tap); each block sums its split's pixels in chunks of 32 into a 64x64 float32 tile
// (four warps of 2x2 wmma tiles, or FMAs in float32) and writes it to a partials buffer.
// The split count is chosen by the wrapper so that even layer1 (C = O = 64: nine tiles)
// fills the 132 SMs. conv3x3_wgrad_reduce_kernel then adds the partials in split order
// and writes dw as OIHW float32: no float atomics, so the result is deterministic.
//
// Bound on an H100 SXM in bf16 (989 TFLOP/s dense, 3.35 TB/s), per launch at batch 1
// (ops = 2 * M * N * 9 * Ck): layer1 129x257, C = O = 64: 2.44 GFLOP, 8.6 MB, 2.6 us
// (bytes); layer2 65x129x128: 2.47 GFLOP, 2.5 us; layer3 65x129x256 (d 2): 9.89 GFLOP,
// 10.0 us; layer4 65x129x512 (d 4): 39.6 GFLOP, 40.0 us (operations). So all but
// layer1 are bound by the tensor cores: the design keeps every product on them, reads
// each input tile once per block from L2 and writes each output once. What it leaves
// for later: wgmma, TMA and a persistent schedule (the 128x64 tile and the synchronous
// shared-memory staging cap it well below the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

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

// EV: elements per load unit (16 bytes / sizeof(T) when Ck and N are multiples of it
// and the pointers are 16-byte aligned, else 1).
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
      if constexpr (EV > 1) {
#pragma unroll
        for (int c = col0; c < col0 + 32; c += 8) {
          const int n = n0 + c;
          if (n < N) {
            __align__(16) bf16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = from_f<bf16>(crow[c + e]);
            *reinterpret_cast<uint4*>(yrow + n) = *reinterpret_cast<const uint4*>(v);
          }
        }
      } else {
        for (int c = col0; c < col0 + 32; ++c)
          if (n0 + c < N) yrow[n0 + c] = from_f<T>(crow[c]);
      }
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
};

template <typename T, int EV>
__global__ void __launch_bounds__(G_THREADS) conv3x3_wgrad_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int B,
    int H, int W, int C, int O, int d, int pix_per_split) {
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
  const int dh = (tap / 3 - 1) * d, dw = (tap % 3 - 1) * d;
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
      const int hs = h + dh, ws = w + dw;
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
}

// dw[o][c][kh][kw] (OIHW float32) = sum over s in order of part[s][kh*3+kw][c][o].
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ dw, int C, int O,
                                            int splits) {
  const long long total = static_cast<long long>(O) * C * 9;
  const long long stride = static_cast<long long>(9) * C * O;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int tap = static_cast<int>(i % 9);
    const long long oc = i / 9;
    const int c = static_cast<int>(oc % C);
    const int o = static_cast<int>(oc / C);
    const float* src = part + (static_cast<long long>(tap) * C + c) * O + o;
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += src[k * stride];
    dw[i] = s;
  }
}

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
int launch_wgrad(const void* x, const void* g, float* part, float* dw, int B, int H,
                 int W, int C, int O, int d, int splits, int pix_per_split,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(((C + G_BC - 1) / G_BC) * ((O + G_BO - 1) / G_BO)),
                  9);
  conv3x3_wgrad_kernel<T, EV><<<grid, G_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, B, H, W, C, O, d,
      pix_per_split);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long total = static_cast<long long>(O) * C * 9;
  const long long need = (total + 255) / 256;
  const int blocks = static_cast<int>(need < 4096 ? need : 4096);
  conv3x3_wgrad_reduce_kernel<<<blocks, 256, 0, s>>>(part, dw, C, O, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B4: y (B, H, W, N) = conv of x (B, H, W, Ck) with the tap matrices wk (9, Ck, N).
// dtype: 0 float32, 1 bfloat16; vec: 1 when Ck and N are multiples of 16 bytes' worth
// of elements and the pointers are 16-byte aligned. Returns cudaGetLastError() after
// the launch (0 on success).
int simt_conv3x3_fwd(const void* x, const void* wk, void* y, int B, int H, int W, int Ck,
                     int N, int d, int dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(B) * H * W == 0 || N == 0) return 0;
  if (dtype == 1) {
    return vec ? launch_fwd<bf16, 8>(x, wk, y, B, H, W, Ck, N, d, s)
               : launch_fwd<bf16, 1>(x, wk, y, B, H, W, Ck, N, d, s);
  }
  if (dtype == 0) {
    return vec ? launch_fwd<float, 4>(x, wk, y, B, H, W, Ck, N, d, s)
               : launch_fwd<float, 1>(x, wk, y, B, H, W, Ck, N, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// B5: dw (O, C, 3, 3) float32 from x (B, H, W, C) and g (B, H, W, O) of one dtype.
// part: splits * 9 * C * O floats of scratch; each split covers pix_per_split pixels
// (the last one fewer). Returns as simt_conv3x3_fwd.
int simt_conv3x3_wgrad(const void* x, const void* g, float* part, float* dw, int B,
                       int H, int W, int C, int O, int d, int splits, int pix_per_split,
                       int dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0 || O == 0) return 0;
  if (splits < 1 || pix_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    return vec ? launch_wgrad<bf16, 8>(x, g, part, dw, B, H, W, C, O, d, splits,
                                       pix_per_split, s)
               : launch_wgrad<bf16, 1>(x, g, part, dw, B, H, W, C, O, d, splits,
                                       pix_per_split, s);
  }
  if (dtype == 0) {
    return vec ? launch_wgrad<float, 4>(x, g, part, dw, B, H, W, C, O, d, splits,
                                        pix_per_split, s)
               : launch_wgrad<float, 1>(x, g, part, dw, B, H, W, C, O, d, splits,
                                        pix_per_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* simt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
