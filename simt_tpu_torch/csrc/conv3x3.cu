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
// finish for B5.

#include <cuda.h>
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

// dw (OIHW float32) from one (tap, C tile, O tile) held in shared memory as
// tile[c][o] (row pitch ld): consecutive threads take consecutive c, so a warp's stores
// (9 floats apart) fall in few lines.
__device__ __forceinline__ void write_oihw(const float* tile, int ld, float* __restrict__ dw,
                                           int tid, int nthreads, int tap, int C, int O,
                                           int c0, int bc, int o0, int bo) {
  for (int e = tid; e < bc * bo; e += nthreads) {
    const int cl = e % bc, ol = e / bc;
    const int c = c0 + cl, o = o0 + ol;
    if (c < C && o < O) dw[(static_cast<long long>(o) * C + c) * 9 + tap] = tile[cl * ld + ol];
  }
}

// tile[r][c] (row pitch ld) = the sum, in order q = 0 .. n-1, of n float32 partial
// tiles, the q-th at src + q * stride with row pitch ld_src, of which rows x cols are
// valid (the rest of the bc x bo tile is left alone). V floats a load (4 needs cols and
// ld_src multiples of 4); G element groups a thread and up to four partials' loads of
// each in flight at once.
template <int V>
__device__ void sum_partials(const float* __restrict__ src, long long stride, int ld_src,
                             int n, float* tile, int ld, int rows, int cols, int bc, int bo,
                             int tid, int nthreads) {
  constexpr int G = 4;
  for (int e0 = tid * V; e0 < bc * bo; e0 += nthreads * V * G) {
    float acc[G][V];
    long long off[G];
    bool ok[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int e = e0 + g * nthreads * V;
      ok[g] = e < bc * bo && e / bo < rows && e % bo < cols;
      off[g] = static_cast<long long>(e / bo) * ld_src + e % bo;
#pragma unroll
      for (int q = 0; q < V; ++q) acc[g][q] = 0.0f;
    }
    for (int k0 = 0; k0 < n; k0 += 4) {
      float v[4][G][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (k0 + u >= n || !ok[g]) continue;
          const float* p = src + (k0 + u) * stride + off[g];
          if constexpr (V == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
            v[u][g][0] = f.x, v[u][g][1] = f.y, v[u][g][2] = f.z, v[u][g][3] = f.w;
          } else {
            v[u][g][0] = __ldcg(p);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (k0 + u < n && ok[g])
#pragma unroll
            for (int q = 0; q < V; ++q) acc[g][q] += v[u][g][q];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!ok[g]) continue;
      const int e = e0 + g * nthreads * V;
#pragma unroll
      for (int q = 0; q < V; ++q) tile[(e / bo) * ld + e % bo + q] = acc[g][q];
    }
  }
}

// The end of one (tap, C tile, O tile) work item of split `split`, after every calling
// thread has written its share of the item's partial tile to
// part[split][tap][c][o]. The group draws one ticket for the tile; the last split to
// finish adds the tile's partials in split order (a fixed order: reruns are bitwise
// equal) into the shared tile, writes dw (OIHW) from it and resets the ticket for the
// next launch. V as for sum_partials. `sync` synchronises exactly the nthreads calling
// threads; `flag` is a shared int. No float atomics, no second launch.
template <int V, typename Sync>
__device__ void finish_split_tile(const float* __restrict__ part, float* __restrict__ dw,
                                  int* ticket, int* flag, float* tile, int ld, int tid,
                                  int nthreads, Sync sync, int splits, int tap, int C, int O,
                                  int c0, int bc, int o0, int bo) {
  __threadfence();  // this thread's partials are visible before the ticket is drawn
  sync();
  if (tid == 0) {
    const int last = atomicAdd(ticket, 1) == splits - 1;
    if (last) *ticket = 0;
    *flag = last;
  }
  sync();
  if (!*flag) return;
  __threadfence();
  sum_partials<V>(part + (static_cast<long long>(tap) * C + c0) * O + o0, 9LL * C * O, O,
                  splits, tile, ld, C - c0, O - o0, bc, bo, tid, nthreads);
  sync();
  write_oihw(tile, ld, dw, tid, nthreads, tap, C, O, c0, bc, o0, bo);
}

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
                       [] { __syncthreads(); }, gridDim.x, tap, C, O, c0, G_BC, o0, G_BO);
}


// ---------------------------------------------------------------------------------
// Hopper building blocks (raw PTX): mbarriers, TMA tile loads, wgmma with
// 128-byte-swizzled shared-memory operands.
// ---------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's shared-memory writes through the generic proxy (the zeroed
// padding rows) before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units). K-major (rows of 64 bf16 along K, 8-row atoms of
// 1024 bytes): sbo 1024, lbo unused. MN-major (rows of 64 bf16 along M or N, one row per
// K): sbo 1024 between 8-row groups along K, lbo between 64-wide blocks along M or N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// D (64 x N, float32, in registers) += A (64 x 16) * B (16 x N), bf16 operands in shared
// memory; TA / TB: 0 K-major, 1 MN-major. Register d[4j + 2i + e] holds row
// 16 * warp + lane / 4 + 8i, column 8j + 2 * (lane % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_n64<TA, TB>(d, da, db);
  } else if constexpr (N == 128) {
    wgmma_n128<TA, TB>(d, da, db);
  } else {
    static_assert(N == 256, "wgmma width 64, 128 or 256");
    wgmma_n256<TA, TB>(d, da, db);
  }
}

// ---------------------------------------------------------------------------------
// B4 on wgmma (bf16, Ck and N multiples of 8): y[m][n] = sum over (tap, k) of
// x(m shifted by tap)[k] * wt[n][tap][k]
// ---------------------------------------------------------------------------------

constexpr int H_BM = 128;          // output pixels a block: two 64-row wgmma
constexpr int H_BK = 64;           // channels a pipeline stage: one 128-byte row
constexpr int H_THREADS = 288;     // consumer warpgroups 0-1, then one producer warp
constexpr int H_CONSUMERS = 256;

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
// x_shift^T (C x pixels) * g (pixels x O), split over the pixels
// ---------------------------------------------------------------------------------

constexpr int G_PIX = 64;  // pixels a pipeline stage: the K depth of four wgmma k16 steps

template <int BC, int BO>
struct GradCfg {
  static constexpr int NWG = BC / 64;  // consumer warpgroups, 64 rows of c each
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int A_BYTES = BC * 128;  // BC/64 blocks of [64 pixels][64 c]
  static constexpr int B_BYTES = BO * 128;  // BO/64 blocks of [64 pixels][64 o]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ST = STAGE >= 49152 ? 4 : (STAGE >= 32768 ? 6 : 8);
  static constexpr int SMEM = ST * STAGE + 2 * ST * 8 + 1024;
  static_assert(BC * (BO + 1) * 4 <= ST * STAGE, "the dw tile fits the ring");
};

// One block: one (split, C-tile x O-tile, tap) work item. Both operands are read
// MN-major (c, resp. o, contiguous in each pixel's row), as wgmma takes a transposed
// bf16 operand from shared memory:
//   - one producer thread has TMA load, per stage of 64 pixels p0 .., the tap-shifted
//     x rows (flat rows p0 + dh*W + dw .., one 64 x 64 box per c block) and g's 64 x BO
//     box (no shift), zeros past the last pixel, C and O;
//   - each consumer thread zeroes half of one x row wherever that pixel's shifted (h, w)
//     leaves the image (the flat shift wraps across rows) or the pixel is past the
//     split; consumer warpgroup w then accumulates c rows w*64 .. w*64+63.
// Epilogue: with one split the tile goes straight to dw (OIHW float32); otherwise to
// this split's partial tile, and the last split of the tile to finish sums them in
// split order (finish_split_tile). Splits cover whole 64-pixel stages.
template <int BC, int BO>
__global__ void __launch_bounds__(GradCfg<BC, BO>::THREADS, 1) conv3x3_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    float* __restrict__ part, int* __restrict__ tickets, float* __restrict__ dw, int B,
    int H, int W, int C, int O, int d, int pix_per_split) {
  using Cfg = GradCfg<BC, BO>;
  constexpr int ST = Cfg::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * Cfg::STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int splits = gridDim.x, split = blockIdx.x;
  const int c_tiles = (C + BC - 1) / BC;
  const int c0 = (blockIdx.y % c_tiles) * BC;
  const int o0 = (blockIdx.y / c_tiles) * BO;
  const int tap = blockIdx.z;
  const int sh = (tap / 3 - 1) * d, sw = (tap % 3 - 1) * d;
  const long long M = static_cast<long long>(B) * H * W;
  const long long p_begin = static_cast<long long>(split) * pix_per_split;
  const long long p_end = p_begin + pix_per_split < M ? p_begin + pix_per_split : M;
  const int n_it =
      p_end > p_begin ? static_cast<int>((p_end - p_begin + G_PIX - 1) / G_PIX) : 0;
  const uint32_t sbase = smem_u32(smem);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Cfg::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= Cfg::CONSUMERS) {
    if (tid != Cfg::CONSUMERS) return;
    const long long shift = static_cast<long long>(sh) * W + sw;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
      const long long p0 = p_begin + static_cast<long long>(it) * G_PIX;
      const uint32_t sa = sbase + s * Cfg::STAGE;
      mbar_arrive_expect_tx(&full[s], Cfg::STAGE);
#pragma unroll
      for (int blk = 0; blk < Cfg::NWG; ++blk)
        tma_load_2d(sa + blk * 8192, &xmap, &full[s], c0 + 64 * blk,
                    static_cast<int>(p0 + shift));
#pragma unroll
      for (int q = 0; q < BO / 64; ++q)
        tma_load_2d(sa + Cfg::A_BYTES + q * 8192, &gmap, &full[s], o0 + 64 * q,
                    static_cast<int>(p0));
    }
  } else {
    const int wg = tid / 128, lt = tid % 128;
    // This thread clears half of x row `row` of its c block where needed; the row's
    // pixel p0 + row is tracked as (h, w) and advanced G_PIX pixels a stage.
    const int row = lt >> 1, half = lt & 1;
    long long rp = p_begin + row;
    int rh = 0, rw = 0;
    if (rp < M) {
      const long long bh = rp / W;
      rw = static_cast<int>(rp - bh * W);
      rh = static_cast<int>(bh % H);
    }
    float acc[BO / 2];
#pragma unroll
    for (int i = 0; i < BO / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const int hs = rh + sh, ws = rw + sw;
      if (rp >= p_end || hs < 0 || hs >= H || ws < 0 || ws >= W) {
        uint4* p = reinterpret_cast<uint4*>(smem + s * Cfg::STAGE + wg * 8192 + row * 128) +
                   4 * half;
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      rp += G_PIX;
      rw += G_PIX;
      while (rw >= W) {
        rw -= W;
        if (++rh == H) rh = 0;
      }
      fence_proxy_async();
      named_sync(2 + wg, 128);
      const uint32_t sa = sbase + s * Cfg::STAGE + wg * 8192;
      const uint32_t sb = sbase + s * Cfg::STAGE + Cfg::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 16 pixels (two 8-row groups) a step
        wgmma<BO, 1, 1>(acc, gmma_desc(sa + 2048 * k, 8192, 1024),
                        gmma_desc(sb + 2048 * k, 8192, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(&empty[(it - 1) % ST]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // The ring is free once both consumer warpgroups are done: the dw tile is staged
    // there as tile[c][o] for coalesced OIHW stores.
    named_sync(1, Cfg::CONSUMERS);
    constexpr int LD = BO + 1;
    float* tile = reinterpret_cast<float*>(smem);
    const int warp = lt / 32, lane = lt % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4, cq = (lane % 4) * 2;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < BO / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tile[(r0 + 8 * i) * LD + 8 * j + cq] = acc[4 * j + 2 * i];
          tile[(r0 + 8 * i) * LD + 8 * j + cq + 1] = acc[4 * j + 2 * i + 1];
        }
      named_sync(1, Cfg::CONSUMERS);
      write_oihw(tile, LD, dw, tid, Cfg::CONSUMERS, tap, C, O, c0, BC, o0, BO);
      return;
    }
    float* out = part + ((static_cast<long long>(split) * 9 + tap) * C) * O;
#pragma unroll
    for (int j = 0; j < BO / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = c0 + r0 + 8 * i, o = o0 + 8 * j + cq;
        if (c < C && o < O)  // O is even: o + 1 < O too
          *reinterpret_cast<float2*>(out + static_cast<long long>(c) * O + o) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    finish_split_tile<4>(part, dw, tickets + tap * gridDim.y + blockIdx.y, &last, tile, LD,
                         tid, Cfg::CONSUMERS, [] { named_sync(1, Cfg::CONSUMERS); }, splits,
                         tap, C, O, c0, BC, o0, BO);
  }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with 128-byte swizzle and zero fill out of bounds. dims and box
// innermost first; strides: bytes between consecutive indices of dims 1 .. rank-1.
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory above 48 KB must be opted into, once per kernel.
template <typename K>
int opt_in_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The activation (B*H*W, C) as a flat 2-D map, box `rows` pixels x 64 channels.
int pixel_map(CUtensorMap* map, const void* x, long long M, int C, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(rows)};
  return make_map(map, x, 2, dims, strides, box);
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
