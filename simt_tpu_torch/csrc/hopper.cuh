// Hopper building blocks shared by the package's wgmma kernels (conv3x3.cu: B4/B5;
// bottleneck.cu: B6/B7), sm_90a, raw PTX (no CUTLASS):
//   - mbarriers, TMA tile loads, named barriers and wgmma with 128-byte-swizzled
//     shared-memory operands;
//   - the split finish of a pixel-split weight gradient: the last split of a tile, by
//     an integer ticket, adds the partials in split order and writes OIHW;
//   - the weight-gradient pipeline of B5 (dw[tap] = x_shift^T g over the pixels), for
//     taps 1 or 9 and C != O (the fused bottleneck's dw1-3 too);
//   - the host side: TMA descriptors from the driver's cuTensorMapEncodeTiled, found
//     through the runtime (no -lcuda), and the shared-memory opt-in.
// Everything is in an anonymous namespace: each source that includes it gets its own
// copy, and the kernels keep their names (conv3x3_*, bneck_*).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// The implicit-GEMM pipeline of B4 and of the fused bottleneck's GEMMs: a block's tile
// of output pixels, the channels a stage holds, and its warps.
constexpr int H_BM = 128;          // output pixels a block: two 64-row wgmma
constexpr int H_BK = 64;           // channels a pipeline stage: one 128-byte row
constexpr int H_THREADS = 288;     // consumer warpgroups 0-1, then one producer warp
constexpr int H_CONSUMERS = 256;

// ---------------------------------------------------------------------------------
// The split finish of a weight gradient: part[split][tap][c][o] summed in split order
// ---------------------------------------------------------------------------------

// dw (OIHW float32, taps 1 or 9 a (o, c)) from one (tap, C tile, O tile) held in shared
// memory as tile[c][o] (row pitch ld): consecutive threads take consecutive c, so a
// warp's stores (`taps` floats apart) fall in few lines.
__device__ __forceinline__ void write_oihw(const float* tile, int ld, float* __restrict__ dw,
                                           int tid, int nthreads, int taps, int tap, int C,
                                           int O, int c0, int bc, int o0, int bo) {
  for (int e = tid; e < bc * bo; e += nthreads) {
    const int cl = e % bc, ol = e / bc;
    const int c = c0 + cl, o = o0 + ol;
    if (c < C && o < O) dw[(static_cast<long long>(o) * C + c) * taps + tap] = tile[cl * ld + ol];
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
// part[split][tap][c][o] (taps 1 or 9). The group draws one ticket for the tile; the last split to
// finish adds the tile's partials in split order (a fixed order: reruns are bitwise
// equal) into the shared tile, writes dw (OIHW) from it and resets the ticket for the
// next launch. V as for sum_partials. `sync` synchronises exactly the nthreads calling
// threads; `flag` is a shared int. No float atomics, no second launch.
template <int V, typename Sync>
__device__ void finish_split_tile(const float* __restrict__ part, float* __restrict__ dw,
                                  int* ticket, int* flag, float* tile, int ld, int tid,
                                  int nthreads, Sync sync, int splits, int taps, int tap, int C,
                                  int O, int c0, int bc, int o0, int bo) {
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
  sum_partials<V>(part + (static_cast<long long>(tap) * C + c0) * O + o0,
                  static_cast<long long>(taps) * C * O, O, splits, tile, ld, C - c0, O - o0, bc,
                  bo, tid, nthreads);
  sync();
  write_oihw(tile, ld, dw, tid, nthreads, taps, tap, C, O, c0, bc, o0, bo);
}

// ---------------------------------------------------------------------------------
// Weight gradient on wgmma (bf16, C and O multiples of 8): for each tap, dw[tap]
// (C x O) = x_shift^T (C x pixels) * g (pixels x O), split over the pixels
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

// One block: one (split, C-tile x O-tile, tap) work item (tap = blockIdx.z, taps 1 or
// 9; with 1 there is no shift). Both operands are read MN-major (c, resp. o, contiguous
// in each pixel's row), as wgmma takes a transposed bf16 operand from shared memory:
//   - one producer thread has TMA load, per stage of 64 pixels p0 .., the tap-shifted
//     x rows (flat rows p0 + dh*W + dw .., one 64 x 64 box per c block) and g's 64 x BO
//     box (no shift), zeros past the last pixel, C and O;
//   - each consumer thread zeroes half of one x row of its c block wherever that
//     pixel's shifted (h, w) leaves the image (the flat shift wraps across rows) or the
//     pixel is past the split; consumer warpgroup w then accumulates c rows
//     w*64 .. w*64+63.
// Epilogue: with one split the tile goes straight to dw (OIHW float32); otherwise to
// this split's partial tile, and the last split of the tile to finish sums them in
// split order (finish_split_tile). Splits cover whole 64-pixel stages.
template <int BC, int BO>
__device__ __forceinline__ void wgrad_wgmma(const CUtensorMap& xmap, const CUtensorMap& gmap,
                                            float* __restrict__ part, int* __restrict__ tickets,
                                            float* __restrict__ dw, int B, int H, int W, int C,
                                            int O, int taps, int d, int pix_per_split) {
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
  const int sh = taps == 9 ? (tap / 3 - 1) * d : 0, sw = taps == 9 ? (tap % 3 - 1) * d : 0;
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
      write_oihw(tile, LD, dw, tid, Cfg::CONSUMERS, taps, tap, C, O, c0, BC, o0, BO);
      return;
    }
    float* out = part + ((static_cast<long long>(split) * taps + tap) * C) * O;
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
                         taps, tap, C, O, c0, BC, o0, BO);
  }
}

// ---------------------------------------------------------------------------------
// Host side: TMA descriptors, shared-memory opt-in
// ---------------------------------------------------------------------------------

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

}  // namespace
