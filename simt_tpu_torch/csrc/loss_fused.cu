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
//  - One launch each. The grid is the schedule of loss_fused.py::schedule, a pure
//    function of the shapes: blocks of contiguous output rows (a band) of one image,
//    each band split across the width into segments of at most 128 columns: one wave
//    of 132 SMs at two blocks an SM at the main path's shapes; a larger batch runs more
//    waves of bands short enough that B3's block still fits two to an SM (one where a
//    row of dxcat alone is too wide). A block walks its band row by row: the H step of
//    the row's source columns into shared memory, then one pass of 128 pixels.
//  - A lane pair per pixel: the even lane computes head 1, the odd lane head 2, so a
//    thread keeps one head's 34 logits and exponentials in registers. Head 2's argmax
//    refines the teacher label of both heads; the odd lane hands it over by shuffle.
//  - Upsample by taps: every row of the align-corners matrices has two non-zeros, and
//    each value is w0*x0 + w1*x1 as two rounded products and one rounded add (no FMA
//    contraction); the plain version computes the same bits.
//  - One reciprocal per softmax: rcp = __frcp_rn(den) (the bits of 1/den, which decides
//    the placeholder's known label) and sm = e * rcp, as the plain version computes it.
//    Only one column of q = T^T softmax is needed: the picked posterior is
//    sum_k T[k, y] * sm[k] in ascending k; in the backward dq is one-hot, so
//    dT[:, y] += sm * dq and dsm = T[:, y] * dq.
//  - No carry across blocks and no float atomics: each block writes its partials, takes
//    an integer ticket, and the block that arrives last sums the partials in a fixed
//    order and resets its ticket (the tickets, anchor keys and presence words live in a
//    per-(device, stream) buffer that is zero between calls). Reruns are bitwise equal.
//    The anchor is a 64-bit atomicMax of (order-preserving float bits << 32 | ~global
//    index): the largest value, and for equal values the smallest global batch-major
//    index, whatever the order. Presence is an atomicOr.
//  - dT without contended atomics: the lanes of a warp that share (head, label) are
//    grouped with __match_any_sync. When every lane of a head shares one label (a
//    region of a real pseudo-label) a reduce-scatter of shuffles sums each channel's
//    sm * dq and one lane a channel adds it into the warp's own dT in shared memory;
//    else the members of each group add their own terms in lane order, one rank a
//    round, the lanes of a round in distinct groups. The warps, then the blocks (in
//    groups of kDtGroup, then the groups) are summed in order.
//  - dxcat: per row, the pass's cotangents go to a shared tile; each (source column,
//    channel) gathers its output columns (the transposed W taps) and adds the sum,
//    weighted by the row's two H taps, into the band's accumulator of the source rows
//    it touches. The band writes one partial for each of those rows; the last band to
//    arrive at a source row sums the row's partials in ascending block order and
//    writes it.
//  - All argmaxes take the first index (strict '>', ascending channel order); the
//    placeholder zeroes the argmax channel and takes its open-class argmax over a row
//    whose known channels are 0; a pixel is valid when its label is >= 0 and not the
//    ignore label. NaN logits are not given torch's NaN-wins argmax semantics.
//
// A band: the schedule may cover only the output rows [r_base, r_base + HB) of the image
// (one rank's share on the spatial axis); label and conf then hold just those rows, the
// taps and xcat stay the whole image's, and anchor indices stay full-image indices. The
// whole image is the band [0, H).
//
// The per-pixel logits of a head live in registers, so C+O is a template parameter
// (instantiated for 6, 8 and 34; the wrapper rejects others).
//
// Bound on an H100 SXM at the main path's shapes (xcat 1x65x129x68 f32, label
// 1x512x1024 int32, conf uint8, T 34x19; loss_fused.py::work, bound): both move 5-7 MB
// (2 us at 3.35 TB/s); the forward does about 0.62 G float32 operations (9.2 us at
// 67 TFLOP/s) and up to 75 M special-function operations (expf, logf, reciprocals; 18 us
// at 16 a clock on each of 132 SMs at 1.98 GHz) when every pixel has a label and a
// placeholder label, about 38 M (9.3 us) where few have the latter; the backward about
// 1.3 G (19.6 us) and up to 74 M (17.8 us). Occupancy: 256 threads, 128 registers, two
// blocks an SM (B3: 104 KB of shared memory each, most of it the warps' dT and the
// cotangent tile). Times: PERF.md section 6.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = kThreads / 2;  // pixels a pass: one lane pair each
constexpr int kBlkFields = 10;      // loss_fused.py::BLOCK_FIELDS
constexpr int kDtGroup = 16;        // loss_fused.py::DT_GROUP
constexpr int kFinishV = 5;         // elements of a partial a thread loads at once
constexpr int kFinishQ = 4;         // partials whose loads are in flight at once
constexpr unsigned kFull = 0xffffffffu;

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

// The wrapper's tap tables (loss_fused.py::device_tables).
struct Tables {
  const int* lo_h;
  const int* hi_h;
  const int* lo_w;
  const int* hi_w;
  const int* lo_begin;  // per source column: the output columns whose lo tap is it
  const int* lo_end;
  const int* hi_begin;  // ... whose hi tap is it
  const int* hi_end;
  const float* w0_h;
  const float* w1_h;
  const float* w0_w;
  const float* w1_w;
};

__device__ __forceinline__ Tables make_tables(const int* ti, const float* tf, int w8, int H,
                                              int W) {
  Tables t;
  t.lo_h = ti;
  t.hi_h = ti + H;
  t.lo_w = ti + 2 * H;
  t.hi_w = ti + 2 * H + W;
  t.lo_begin = ti + 2 * H + 2 * W;
  t.lo_end = t.lo_begin + w8;
  t.hi_begin = t.lo_end + w8;
  t.hi_end = t.hi_begin + w8;
  t.w0_h = tf;
  t.w1_h = tf + H;
  t.w0_w = tf + 2 * H;
  t.w1_w = tf + 2 * H + W;
  return t;
}

// One block of the schedule (loss_fused.py::schedule): image, output rows [r0, r1),
// output columns [c0, c1), their source columns [jlo, jhi] and source rows [i0, i1],
// and the offset of its dxcat partial.
struct Block {
  int b, r0, r1, c0, c1, jlo, jhi, i0, i1, part;
};

__device__ __forceinline__ Block load_block(const int* sched, int id) {
  const int* f = sched + static_cast<size_t>(id) * kBlkFields;
  return Block{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
}

// H step of output row r over the block's source columns: zs[(j - jlo) * CAT + ch].
template <int CAT>
__device__ __forceinline__ void h_step(const float* __restrict__ xb, const Tables& t,
                                       int r, int w8, int jlo, int nj, float* zs) {
  const float* x0 = xb + (static_cast<size_t>(t.lo_h[r]) * w8 + jlo) * CAT;
  const float* x1 = xb + (static_cast<size_t>(t.hi_h[r]) * w8 + jlo) * CAT;
  const float w0 = t.w0_h[r], w1 = t.w1_h[r];
  for (int i = threadIdx.x; i < nj * CAT; i += kThreads) zs[i] = two_tap(w0, x0[i], w1, x1[i]);
}

// The first index of the maximum and the maximum, as a strict '>' scan in ascending
// order finds them, by a tree: each pair keeps its left (lower) half unless the right
// half's maximum is strictly greater. Depth log2(TOT) instead of TOT.
template <int TOT>
__device__ __forceinline__ int argmax_first(const float (&p)[TOT], float& mx) {
  float v[TOT];
  int a[TOT];
#pragma unroll
  for (int k = 0; k < TOT; ++k) {
    v[k] = p[k];
    a[k] = k;
  }
#pragma unroll
  for (int s = 1; s < TOT; s *= 2) {
#pragma unroll
    for (int i = 0; i + s < TOT; i += 2 * s) {
      if (v[i + s] > v[i]) {
        v[i] = v[i + s];
        a[i] = a[i + s];
      }
    }
  }
  mx = v[0];
  return a[0];
}

// What both directions need of one head at one pixel.
template <int TOT>
struct Head {
  float p[TOT];  // the logits (the backward replaces them by the suppressed exponentials)
  float e[TOT];  // exp(p - max)
  float mx, den, rcp, mxu;
  int pseudo, known, place;
};

// The W step of head `off / TOT` at one output column, then its softmax, labels and
// the suppressed logits' maximum.
template <int TOT>
__device__ __forceinline__ void head_pixel(const float* zs, int lo, int hi, float u0,
                                           float u1, int off, int C, float th, int ignore,
                                           Head<TOT>& h) {
  constexpr int CAT = 2 * TOT;
#pragma unroll
  for (int k = 0; k < TOT; ++k)
    h.p[k] = two_tap(u0, zs[lo * CAT + off + k], u1, zs[hi * CAT + off + k]);
  h.pseudo = argmax_first(h.p, h.mx);
#pragma unroll
  for (int k = 0; k < TOT; ++k) h.e[k] = expf(__fsub_rn(h.p[k], h.mx));
  float den = h.e[0];
#pragma unroll
  for (int k = 1; k < TOT; ++k) den = __fadd_rn(den, h.e[k]);
  h.den = den;
  h.rcp = __frcp_rn(den);  // the bits of 1/den
  h.known = (h.pseudo < C && h.rcp > th) ? h.pseudo : ignore;

  // Suppressed logits: the argmax channel set to 0 (trainV2_simt.py:205-209).
  float q[TOT];
#pragma unroll
  for (int k = 0; k < TOT; ++k) q[k] = (k == h.pseudo) ? 0.f : h.p[k];
  argmax_first(q, h.mxu);
  // Open-class argmax over a row whose known channels are 0 (:219-223): the first
  // open channel holding the maximum when it is above 0, else channel 0.
#pragma unroll
  for (int k = 0; k < TOT; ++k)
    if (k < C) q[k] = -INFINITY;
  float best;
  const int arg = argmax_first(q, best);
  h.place = (h.known == ignore) ? ignore : (best > 0.f ? arg : 0);
}

// sum_k T[k, y] * (e[k] * rcp) in ascending k (the picked noisy posterior).
template <int TOT>
__device__ __forceinline__ float picked_posterior(const Head<TOT>& h, const float* T, int C,
                                                  int y) {
  float acc = __fmul_rn(T[y], __fmul_rn(h.e[0], h.rcp));
#pragma unroll
  for (int k = 1; k < TOT; ++k)
    acc = __fadd_rn(acc, __fmul_rn(T[k * C + y], __fmul_rn(h.e[k], h.rcp)));
  return acc;
}

// The lane pair's pixel: the lane's own column (clamped into the block when the lane
// has none) and its two W taps relative to the block's first source column.
struct Column {
  int c, lo, hi;
  float u0, u1;
  bool active;
};

__device__ __forceinline__ Column column(const Tables& t, const Block& bk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Column col;
  col.c = bk.c0 + warp * 16 + (lane >> 1);
  col.active = col.c < bk.c1;
  if (!col.active) col.c = bk.c0;
  col.lo = t.lo_w[col.c] - bk.jlo;
  col.hi = t.hi_w[col.c] - bk.jlo;
  col.u0 = t.w0_w[col.c];
  col.u1 = t.w1_w[col.c];
  return col;
}

// Both heads' T into shared memory: Ts[head * TOT * C + k * C + y].
__device__ __forceinline__ void load_t(const float* t1, const float* t2, int n, float* Ts) {
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) Ts[i] = i < n ? t1[i] : t2[i - n];
}

// One thread of the block reports whether it drew the last of `n` tickets (and then
// resets the ticket for the next launch); the block learns it through `flag`.
__device__ __forceinline__ bool last_arrival(int* ticket, int n, int* flag) {
  __threadfence();  // this block's results are visible before the ticket is drawn
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(ticket, 1) == n - 1;
    if (last) *ticket = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  __syncthreads();  // `flag` may be reused
  if (last) __threadfence();
  return last;
}

// ------------------------------------------------------------------------------------
// Forward (B2)
// ------------------------------------------------------------------------------------

template <int TOT>
__global__ void __launch_bounds__(kThreads, 2) loss_fwd_kernel(
    const float* __restrict__ xcat, const int* __restrict__ label,
    const unsigned char* __restrict__ conf, const float* __restrict__ t1,
    const float* __restrict__ t2, const int* __restrict__ taps_i,
    const float* __restrict__ taps_f, const int* __restrict__ sched,
    float* __restrict__ partials, unsigned long long* __restrict__ keys,
    int* __restrict__ presence, int* __restrict__ ticket, float* __restrict__ sums,
    float* __restrict__ amax, int* __restrict__ aidx, float* __restrict__ pres, int h8,
    int w8, int H, int W, int r_base, int HB, int C, float th, int ignore) {
  constexpr int CAT = 2 * TOT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* sh_keys = reinterpret_cast<unsigned long long*>(smem_raw);  // CAT
  int* sh_pres = reinterpret_cast<int*>(sh_keys + CAT);                            // CAT
  int* flag = sh_pres + CAT;                                                       // 4
  double* slices = reinterpret_cast<double*>(flag + 4);                            // 256
  float* sh_red = reinterpret_cast<float*>(slices + kThreads);                     // 16*warps
  float* Ts = sh_red + 16 * kWarps;                                                // CAT*C
  float* zs = Ts + CAT * C;                                                        // nj*CAT

  const Tables tb = make_tables(taps_i, taps_f, w8, H, W);
  const Block bk = load_block(sched, blockIdx.x);
  const int nj = bk.jhi - bk.jlo + 1;
  const float* xb = xcat + static_cast<size_t>(bk.b) * h8 * w8 * CAT;
  for (int i = threadIdx.x; i < CAT; i += kThreads) {
    sh_keys[i] = 0ull;
    sh_pres[i] = 0;
  }
  load_t(t1, t2, TOT * C, Ts);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, head = lane & 1;
  const Column col = column(tb, bk);
  const float* T = Ts + head * TOT * C;
  unsigned long long* my_keys = sh_keys + head * TOT;
  int* my_pres = sh_pres + head * TOT;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // A logit of this lane's head read again from zs: the bits head_pixel computed.
  const float* z_lo = zs + col.lo * CAT + head * TOT;
  const float* z_hi = zs + col.hi * CAT + head * TOT;
  const auto logit = [&](int k) {
    return (k >= 0 && k < TOT) ? two_tap(col.u0, z_lo[k], col.u1, z_hi[k]) : 0.f;
  };

  for (int r = bk.r0; r < bk.r1; ++r) {
    __syncthreads();  // the previous row's readers of zs are done
    h_step<CAT>(xb, tb, r, w8, bk.jlo, nj, zs);
    __syncthreads();
    // The full image's flat index (the anchor's) and the band's (label, conf).
    const size_t at = (static_cast<size_t>(bk.b) * H + r) * W + col.c;
    const size_t in_band = (static_cast<size_t>(bk.b) * HB + (r - r_base)) * W + col.c;
    const int y = label[in_band];
    const int cf = conf[in_band];
    Head<TOT> h;
    head_pixel(zs, col.lo, col.hi, col.u0, col.u1, head * TOT, C, th, ignore, h);
    const int pseudo2 = __shfl_sync(kFull, h.pseudo, lane | 1);
    if (!col.active) continue;
    const int refined = (cf == C) ? (pseudo2 >= C ? pseudo2 : ignore) : cf;
    const float lz = __fadd_rn(h.mx, logf(h.den));
    if (is_valid(refined, ignore)) {
      acc[0] += __fsub_rn(lz, logit(refined));
      acc[1] += 1.f;
    }
    if (is_valid(h.known, ignore)) {
      acc[2] += __fsub_rn(lz, logit(h.known));
      acc[3] += 1.f;
    }
    if (is_valid(h.place, ignore)) {
      float denu = expf(__fsub_rn((h.pseudo == 0) ? 0.f : h.p[0], h.mxu));
#pragma unroll
      for (int k = 1; k < TOT; ++k)
        denu = __fadd_rn(denu, expf(__fsub_rn((k == h.pseudo) ? 0.f : h.p[k], h.mxu)));
      const float lzu = __fadd_rn(h.mxu, logf(denu));
      const float v = (h.place == h.pseudo) ? 0.f : logit(h.place);
      acc[4] += __fsub_rn(lzu, v);
      acc[5] += 1.f;
    }
    if (is_valid(y, ignore)) {
      const float picked = (y < C) ? picked_posterior(h, T, C, y) : 0.f;
      acc[6] += -logf(picked);
      acc[7] += 1.f;
    }
    // Anchor: the running maximum per channel, first global index on a tie. A logit
    // whose ordered bits are below its channel's key's high word cannot move it.
    volatile unsigned* seen_hi = reinterpret_cast<volatile unsigned*>(my_keys) + 1;
    volatile unsigned long long* seen = my_keys;
    const unsigned long long low = static_cast<unsigned long long>(
        0xffffffffu - static_cast<unsigned int>(at));
#pragma unroll
    for (int k = 0; k < TOT; ++k) {
      const unsigned ob = ordered_bits(h.p[k]);
      if (ob >= seen_hi[2 * k]) {
        const unsigned long long key = (static_cast<unsigned long long>(ob) << 32) | low;
        if (key > seen[k]) atomicMax(&my_keys[k], key);
      }
    }
    if (!my_pres[h.pseudo]) my_pres[h.pseudo] = 1;
  }

  // The block's 16 sums in a fixed order: a butterfly over the lanes of each head, then
  // the warps in order.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane < 2) sh_red[warp * 16 + head * 8 + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh_red[w * 16 + threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * 16 + threadIdx.x] = s;
  }
  for (int i = threadIdx.x; i < CAT; i += kThreads) {
    if (sh_keys[i]) atomicMax(&keys[i], sh_keys[i]);
    if (sh_pres[i]) atomicOr(&presence[i], 1);
  }
  if (!last_arrival(ticket, gridDim.x, flag)) return;

  // The last block: thread (i, s) sums partials s, s + 16, ... of sum i in double, then
  // thread i adds the 16 slices in order; the keys and presence words become the
  // outputs and are zeroed for the next launch.
  const int i = threadIdx.x & 15, s = threadIdx.x >> 4;
  double v = 0.0;
  for (int p = s; p < static_cast<int>(gridDim.x); p += 16)
    v += __ldcg(&partials[static_cast<size_t>(p) * 16 + i]);
  slices[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < 16) {
    double t = 0.0;
    for (int k = 0; k < 16; ++k) t += slices[k * 16 + threadIdx.x];
    sums[threadIdx.x] = static_cast<float>(t);
  }
  for (int k = threadIdx.x; k < CAT; k += kThreads) {
    const unsigned long long key = atomicExch(&keys[k], 0ull);
    amax[k] = key ? from_ordered_bits(static_cast<unsigned int>(key >> 32)) : -INFINITY;
    aidx[k] = key ? static_cast<int>(0xffffffffu - static_cast<unsigned int>(key)) : 0;
    pres[k] = atomicExch(&presence[k], 0) ? 1.f : 0.f;
  }
}

// ------------------------------------------------------------------------------------
// Backward (B3)
// ------------------------------------------------------------------------------------

// Halves x over the lane pair `mask` apart: the lane whose `mask` bit is clear keeps
// the first half (n values, the rest padded with 0), the other the second, each adding
// its partner's copy of the half it keeps.
template <int N, int M>
__device__ __forceinline__ void halve(const float (&x)[M], float (&out)[N], int lane,
                                      int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float lo = x[j], hi = (j + N < M) ? x[j + N] : 0.f;
    const float send = upper ? lo : hi;
    out[j] = (upper ? hi : lo) + __shfl_xor_sync(kFull, send, mask);
  }
}

// Adds the sum of x[TOT] over the 16 lanes of this lane's parity into dt[k * C + y] (one
// label for all of them): four halvings (lane bits 4, 3, 2, 1) leave each lane the sums
// of at most N4 channels, each channel's in exactly one lane, in a fixed order.
template <int TOT>
__device__ __forceinline__ void reduce_scatter_add(const float (&x)[TOT], int lane,
                                                   float* dt, int C, int y) {
  constexpr int N1 = (TOT + 1) / 2, N2 = (N1 + 1) / 2, N3 = (N2 + 1) / 2, N4 = (N3 + 1) / 2;
  float a1[N1], a2[N2], a3[N3], a4[N4];
  halve(x, a1, lane, 16);
  halve(a1, a2, lane, 8);
  halve(a2, a3, lane, 4);
  halve(a3, a4, lane, 2);
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1,
            b1 = (lane >> 1) & 1;
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const int i3 = b1 * N4 + i, i2 = b2 * N3 + i3, i1 = b3 * N2 + i2, k = b4 * N1 + i1;
    if (i3 < N3 && i2 < N2 && i1 < N1 && k < TOT) dt[k * C + y] += a4[i];
  }
}

template <int TOT>
__global__ void __launch_bounds__(kThreads, 2) loss_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ xcat,
    const int* __restrict__ label, const unsigned char* __restrict__ conf,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const int* __restrict__ taps_i, const float* __restrict__ taps_f,
    const int* __restrict__ sched, const int* __restrict__ row_off,
    const int* __restrict__ row_blk, float* __restrict__ part,
    float* __restrict__ dt_part, float* __restrict__ dt_grp, int* __restrict__ tickets,
    float* __restrict__ dx, float* __restrict__ dt, int batch, int h8, int w8, int H,
    int W, int r_base, int HB, int C, float th, int ignore, int jmax, int kmax, int maxc) {
  constexpr int CAT = 2 * TOT;
  constexpr int DP = CAT + 1;  // odd row stride of the cotangent tile: no bank conflicts
  const int TC = CAT * C;      // both heads' dT
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kmax4 = (kmax + 3) & ~3, maxc4 = (maxc + 3) & ~3;
  int* flag = reinterpret_cast<int*>(smem_raw);  // 4
  int* last_row = flag + 4;                       // kmax4
  int* q_base = last_row + kmax4;                 // maxc4 each: a finished row's blocks
  int* q_lo = q_base + maxc4;
  int* q_len = q_lo + maxc4;
  int* seg_rng = q_len + maxc4;                          // 4 * jmax
  float* seg_w0 = reinterpret_cast<float*>(seg_rng + 4 * jmax);  // kPix each
  float* seg_w1 = seg_w0 + kPix;
  float* Ts = seg_w1 + kPix;                             // TC
  float* dtw = Ts + TC;                                  // kWarps * TC
  float* zs = dtw + kWarps * TC;                         // jmax * CAT (and the finish's row)
  float* dp = zs + jmax * CAT;                           // kPix * DP
  float* acc = dp + kPix * DP;                           // kmax*jmax*CAT

  const Tables tb = make_tables(taps_i, taps_f, w8, H, W);
  const Block bk = load_block(sched, blockIdx.x);
  const int nj = bk.jhi - bk.jlo + 1, nk = bk.i1 - bk.i0 + 1;
  const float* xb = xcat + static_cast<size_t>(bk.b) * h8 * w8 * CAT;
  const size_t row_len = static_cast<size_t>(w8) * CAT;
  if (blockIdx.x == 0) {  // source rows no output row reads: their dxcat is 0
    for (int i = 0; i < batch * h8; ++i)
      if (row_off[i + 1] == row_off[i])
        for (size_t e = threadIdx.x; e < row_len; e += kThreads) dx[i * row_len + e] = 0.f;
  }
  load_t(t1, t2, TOT * C, Ts);
  for (int i = threadIdx.x; i < kWarps * TC; i += kThreads) dtw[i] = 0.f;
  for (int i = threadIdx.x; i < kmax * jmax * CAT; i += kThreads) acc[i] = 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, head = lane & 1;
  const int px = warp * 16 + (lane >> 1);
  const Column col = column(tb, bk);
  const float* __restrict__ T = Ts + head * TOT * C;
  float* __restrict__ my_dt = dtw + warp * TC + head * TOT * C;
  float gh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) gh[i] = g[head * 8 + i];
  // This thread's (source column, channel) items of the transposed W taps: the same
  // every row, so each accumulator element has one writer. The segment's W weights and
  // each source column's output columns (relative to c0) in shared memory.
  const int n_items = nj * CAT;
  for (int c = threadIdx.x; c < bk.c1 - bk.c0; c += kThreads) {
    seg_w0[c] = tb.w0_w[bk.c0 + c];
    seg_w1[c] = tb.w1_w[bk.c0 + c];
  }
  for (int jj = threadIdx.x; jj < nj; jj += kThreads) {
    const int j = bk.jlo + jj;
    seg_rng[4 * jj] = max(tb.lo_begin[j], bk.c0) - bk.c0;
    seg_rng[4 * jj + 1] = min(tb.lo_end[j], bk.c1) - bk.c0;
    seg_rng[4 * jj + 2] = max(tb.hi_begin[j], bk.c0) - bk.c0;
    seg_rng[4 * jj + 3] = min(tb.hi_end[j], bk.c1) - bk.c0;
  }

  for (int r = bk.r0; r < bk.r1; ++r) {
    __syncthreads();  // the previous row's readers of zs and dp are done
    h_step<CAT>(xb, tb, r, w8, bk.jlo, nj, zs);
    __syncthreads();
    const size_t in_band = (static_cast<size_t>(bk.b) * HB + (r - r_base)) * W + col.c;
    const int y = label[in_band];
    const int cf = conf[in_band];
    Head<TOT> h;
    head_pixel(zs, col.lo, col.hi, col.u0, col.u1, head * TOT, C, th, ignore, h);
    const int pseudo2 = __shfl_sync(kFull, h.pseudo, lane | 1);
    const int refined = (cf == C) ? (pseudo2 >= C ? pseudo2 : ignore) : cf;
    const float v_ce = (col.active && is_valid(refined, ignore)) ? 1.f : 0.f;
    const float v_kn = (col.active && is_valid(h.known, ignore)) ? 1.f : 0.f;
    const float v_un = (col.active && is_valid(h.place, ignore)) ? 1.f : 0.f;
    // The suppressed softmax, where a lane of the warp has a placeholder label: its
    // exponentials replace the logits.
    float rcpu = 0.f;
    if (__any_sync(kFull, v_un != 0.f)) {
#pragma unroll
      for (int k = 0; k < TOT; ++k)
        h.p[k] = expf(__fsub_rn((k == h.pseudo) ? 0.f : h.p[k], h.mxu));
      float denu = h.p[0];
#pragma unroll
      for (int k = 1; k < TOT; ++k) denu = __fadd_rn(denu, h.p[k]);
      rcpu = __frcp_rn(denu);
    }
    const bool has_y = col.active && is_valid(y, ignore) && y < C;
    float dq = 0.f, s = 0.f;
    if (has_y) {
      dq = -gh[6] * __frcp_rn(picked_posterior(h, T, C, y));
#pragma unroll
      for (int k = 0; k < TOT; ++k) s += T[k * C + y] * dq * __fmul_rn(h.e[k], h.rcp);
    }
    // Lanes that share (head, label): one group; a lane without a label is alone.
    const unsigned group = __match_any_sync(kFull, has_y ? 2 * y + head : -1 - lane);
    const bool uniform = __all_sync(kFull, __popc(group) == 16);
    const bool any_y = __any_sync(kFull, has_y);
    float* __restrict__ mine = dp + px * DP + head * TOT;
#pragma unroll
    for (int k = 0; k < TOT; ++k) {
      const float sm = __fmul_rn(h.e[k], h.rcp);
      float d = gh[0] * (sm - (k == refined ? 1.f : 0.f)) * v_ce +
                gh[2] * (sm - (k == h.known ? 1.f : 0.f)) * v_kn;
      if (k != h.pseudo && v_un != 0.f)
        d += gh[4] * (__fmul_rn(h.p[k], rcpu) - (k == h.place ? 1.f : 0.f));
      if (has_y) d += sm * (T[k * C + y] * dq - s);
      mine[k] = d;
    }
    if (uniform) {
      // Every lane of a head shares one label: a reduce-scatter over the 16 lanes of
      // one parity leaves each lane the sums of a few channels, which it adds in.
#pragma unroll
      for (int k = 0; k < TOT; ++k) h.e[k] = __fmul_rn(__fmul_rn(h.e[k], h.rcp), dq);
      reduce_scatter_add<TOT>(h.e, lane, my_dt, C, y);
    } else if (any_y) {
      // Else the members of each group add their own sm * dq in lane order, one rank a
      // round: the lanes of one round belong to distinct groups, so distinct columns.
      const int rank = __popc(group & ((1u << lane) - 1));
      const int rounds = static_cast<int>(__reduce_max_sync(kFull, has_y ? __popc(group) : 0));
      for (int t = 0; t < rounds; ++t) {
        if (has_y && rank == t) {
#pragma unroll
          for (int k = 0; k < TOT; ++k)
            my_dt[k * C + y] += __fmul_rn(__fmul_rn(h.e[k], h.rcp), dq);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // Transposed W taps of the pass, weighted by the row's H taps, into the band's
    // source rows.
    const int klo = tb.lo_h[r] - bk.i0, khi = tb.hi_h[r] - bk.i0;
    const float wa = tb.w0_h[r], wb = tb.w1_h[r];
    for (int it = threadIdx.x; it < n_items; it += kThreads) {
      const int jj = it / CAT, ch = it % CAT;
      // The lo and hi taps' columns as two independent sums.
      const int a0 = seg_rng[4 * jj], n0 = seg_rng[4 * jj + 1] - a0;
      const int a1 = seg_rng[4 * jj + 2], n1 = seg_rng[4 * jj + 3] - a1;
      float v0 = 0.f, v1 = 0.f;
      for (int u = 0; u < max(n0, n1); ++u) {
        if (u < n0) v0 += seg_w0[a0 + u] * dp[(a0 + u) * DP + ch];
        if (u < n1) v1 += seg_w1[a1 + u] * dp[(a1 + u) * DP + ch];
      }
      const float v = v0 + v1;
      float* a = acc + jj * CAT + ch;
      a[klo * jmax * CAT] += wa * v;
      a[khi * jmax * CAT] += wb * v;
    }
  }
  __syncthreads();

  // This block's partials: dxcat of its source rows over its source columns, and dT
  // (the warps in order).
  float* mypart = part + bk.part;
  for (int e = threadIdx.x; e < nk * nj * CAT; e += kThreads) {
    const int k = e / (nj * CAT), rem = e % (nj * CAT);
    mypart[e] = acc[k * jmax * CAT + rem];
  }
  for (int e = threadIdx.x; e < TC; e += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += dtw[w * TC + e];
    dt_part[static_cast<size_t>(blockIdx.x) * TC + e] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < nk; ++k) {
      const int row = bk.b * h8 + bk.i0 + k;
      const int n = row_off[row + 1] - row_off[row];
      last_row[k] = atomicAdd(&tickets[row], 1) == n - 1;
      if (last_row[k]) tickets[row] = 0;
    }
  }
  __syncthreads();
  __threadfence();
  // Each source row this block arrived at last: its contributing blocks' partials in
  // ascending block order, each added over its source columns into the row in shared
  // memory (the next blocks' loads in flight while these are added), then written.
  float* rowbuf = zs;  // w8 * CAT
  for (int k = 0; k < nk; ++k) {
    if (!last_row[k]) continue;
    const int row = bk.b * h8 + bk.i0 + k, i = bk.i0 + k;
    const int q0 = row_off[row], n = row_off[row + 1] - q0;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const Block o = load_block(sched, row_blk[q0 + q]);
      const int onj = o.jhi - o.jlo + 1;
      q_base[q] = o.part + (i - o.i0) * onj * CAT;
      q_lo[q] = o.jlo * CAT;
      q_len[q] = onj * CAT;
    }
    for (size_t e = threadIdx.x; e < row_len; e += kThreads) rowbuf[e] = 0.f;
    __syncthreads();
    // kFinishQ blocks' loads in flight while the kFinishQ before them are added.
    float nxt[kFinishQ][kFinishV];
    const auto fetch = [&](int qa, float (&buf)[kFinishQ][kFinishV]) {
#pragma unroll
      for (int u = 0; u < kFinishQ; ++u) {
#pragma unroll
        for (int v = 0; v < kFinishV; ++v) {
          const int q = qa + u, t = threadIdx.x + v * kThreads;
          buf[u][v] = (q < n && t < q_len[q]) ? __ldcg(&part[q_base[q] + t]) : 0.f;
        }
      }
    };
    fetch(0, nxt);
    for (int qa = 0; qa < n; qa += kFinishQ) {
      float cur[kFinishQ][kFinishV];
#pragma unroll
      for (int u = 0; u < kFinishQ; ++u)
#pragma unroll
        for (int v = 0; v < kFinishV; ++v) cur[u][v] = nxt[u][v];
      fetch(qa + kFinishQ, nxt);
#pragma unroll
      for (int u = 0; u < kFinishQ; ++u) {
        const int q = qa + u;
        if (q >= n) break;
        const int len = q_len[q];
        float* dst = rowbuf + q_lo[q];
#pragma unroll
        for (int v = 0; v < kFinishV; ++v) {
          const int t = threadIdx.x + v * kThreads;
          if (t < len) dst[t] += cur[u][v];
        }
        for (int t = threadIdx.x + kFinishV * kThreads; t < len; t += kThreads)
          dst[t] += __ldcg(&part[q_base[q] + t]);
        __syncthreads();
      }
    }
    for (size_t e = threadIdx.x; e < row_len; e += kThreads) dx[row * row_len + e] = rowbuf[e];
    __syncthreads();  // rowbuf and the q_* arrays are reused
  }
  // dT: the last block of each group of kDtGroup blocks sums the group's partials in
  // block order; the last group to finish sums the groups in order.
  const int n_groups = (gridDim.x + kDtGroup - 1) / kDtGroup, grp = blockIdx.x / kDtGroup;
  const int g0 = grp * kDtGroup, g1 = min(g0 + kDtGroup, static_cast<int>(gridDim.x));
  int* dt_tickets = tickets + batch * h8;
  if (!last_arrival(dt_tickets + grp, g1 - g0, flag)) return;
  for (int e = threadIdx.x; e < TC; e += kThreads) {
    float x[kDtGroup];
#pragma unroll
    for (int u = 0; u < kDtGroup; ++u)
      x[u] = g0 + u < g1 ? __ldcg(&dt_part[static_cast<size_t>(g0 + u) * TC + e]) : 0.f;
    float v = x[0];
#pragma unroll
    for (int u = 1; u < kDtGroup; ++u) v += x[u];
    dt_grp[static_cast<size_t>(grp) * TC + e] = v;
  }
  if (!last_arrival(dt_tickets + n_groups, n_groups, flag)) return;
  for (int e = threadIdx.x; e < TC; e += kThreads) {
    float v = 0.f;
    for (int q0 = 0; q0 < n_groups; q0 += kDtGroup) {
      float x[kDtGroup];
#pragma unroll
      for (int u = 0; u < kDtGroup; ++u)
        x[u] = q0 + u < n_groups ? __ldcg(&dt_grp[static_cast<size_t>(q0 + u) * TC + e]) : 0.f;
#pragma unroll
      for (int u = 0; u < kDtGroup; ++u) v += x[u];
    }
    dt[e] = v;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TOT>
size_t fwd_smem(int C, int jmax) {
  constexpr int CAT = 2 * TOT;
  return CAT * (sizeof(unsigned long long) + sizeof(int)) + 4 * sizeof(int) +
         kThreads * sizeof(double) +
         (16 * kWarps + static_cast<size_t>(CAT) * C + static_cast<size_t>(jmax) * CAT) *
             sizeof(float);
}

template <int TOT>
size_t bwd_smem(int C, int w8, int jmax, int kmax, int maxc) {
  constexpr int CAT = 2 * TOT;
  const size_t loop = static_cast<size_t>(jmax) * CAT + kPix * (CAT + 1) +
                      static_cast<size_t>(kmax) * jmax * CAT;
  const size_t row = static_cast<size_t>(w8) * CAT;
  return (4 + ((kmax + 3) & ~3) + 3 * ((maxc + 3) & ~3) + 4 * jmax) * sizeof(int) +
         (2 * kPix + static_cast<size_t>(1 + kWarps) * CAT * C + (loop > row ? loop : row)) *
             sizeof(float);
}

template <int TOT>
int launch_fwd(const float* xcat, const int* label, const unsigned char* conf,
               const float* t1, const float* t2, const int* taps_i, const float* taps_f,
               const int* sched, int n_blocks, int jmax, float* partials,
               unsigned long long* keys, int* presence, int* ticket, float* sums,
               float* amax, int* aidx, float* pres, int h8, int w8, int H, int W,
               int r_base, int HB, int C, float th, int ignore, cudaStream_t stream) {
  const size_t smem = fwd_smem<TOT>(C, jmax);
  cudaError_t e = allow_smem(loss_fwd_kernel<TOT>, smem);
  if (e != cudaSuccess) return e;
  loss_fwd_kernel<TOT><<<n_blocks, kThreads, smem, stream>>>(
      xcat, label, conf, t1, t2, taps_i, taps_f, sched, partials, keys, presence, ticket,
      sums, amax, aidx, pres, h8, w8, H, W, r_base, HB, C, th, ignore);
  return cudaGetLastError();
}

template <int TOT>
int launch_bwd(const float* g, const float* xcat, const int* label,
               const unsigned char* conf, const float* t1, const float* t2,
               const int* taps_i, const float* taps_f, const int* sched, int n_blocks,
               const int* row_off, const int* row_blk, int jmax, int kmax, int maxc,
               float* part, float* dt_part, float* dt_grp, int* tickets, float* dx,
               float* dt, int batch, int h8, int w8, int H, int W, int r_base, int HB,
               int C, float th, int ignore, cudaStream_t stream) {
  const size_t smem = bwd_smem<TOT>(C, w8, jmax, kmax, maxc);
  cudaError_t e = allow_smem(loss_bwd_kernel<TOT>, smem);
  if (e != cudaSuccess) return e;
  loss_bwd_kernel<TOT><<<n_blocks, kThreads, smem, stream>>>(
      g, xcat, label, conf, t1, t2, taps_i, taps_f, sched, row_off, row_blk, part, dt_part,
      dt_grp, tickets, dx, dt, batch, h8, w8, H, W, r_base, HB, C, th, ignore, jmax, kmax,
      maxc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward of the loss core: one launch of n_blocks blocks of the schedule `sched`
// (n_blocks x 10 int32) over the output rows [r_base, r_base + HB) of an H x W image:
// label and conf hold those HB rows (B, HB, W); anchor indices are the full image's.
// partials: n_blocks*16 floats of scratch; keys (2*TOT uint64), presence (2*TOT int32)
// and ticket (1 int32) zero, and left zero. Outputs: sums (2, 8), amax / aidx / pres
// (2, TOT). Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a C+O it is not compiled for.
int simt_loss_core_fwd(const float* xcat, const int* label, const unsigned char* conf,
                       const float* t1, const float* t2, const int* taps_i,
                       const float* taps_f, const int* sched, int n_blocks, int jmax,
                       float* partials, unsigned long long* keys, int* presence,
                       int* ticket, float* sums, float* amax, int* aidx, float* pres,
                       int h8, int w8, int H, int W, int r_base, int HB, int C, int TOT,
                       float th, int ignore, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMT_FWD(N)                                                                    \
  case N:                                                                              \
    return launch_fwd<N>(xcat, label, conf, t1, t2, taps_i, taps_f, sched, n_blocks,   \
                         jmax, partials, keys, presence, ticket, sums, amax, aidx, pres, \
                         h8, w8, H, W, r_base, HB, C, th, ignore, s);
  switch (TOT) {
    SIMT_FWD(6)
    SIMT_FWD(8)
    SIMT_FWD(34)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIMT_FWD
}

// Backward of the loss core for the cotangent g (2, 8) of the sums over the band of
// output rows [r_base, r_base + HB) (as the forward): one launch of the
// schedule's n_blocks blocks; row_off (batch*h8 + 1) / row_blk list each source row's
// contributing blocks in ascending order (at most maxc a row). part (the schedule's
// partial floats),
// dt_part (n_blocks*2*TOT*C) and dt_grp (ceil(n_blocks/16)*2*TOT*C floats) are scratch;
// tickets (batch*h8 + ceil(n_blocks/16) + 1 int32) zero, and left zero. Outputs: dx
// (batch, h8, w8, 2*TOT), dt (2, TOT, C). Returns as simt_loss_core_fwd.
int simt_loss_core_bwd(const float* g, const float* xcat, const int* label,
                       const unsigned char* conf, const float* t1, const float* t2,
                       const int* taps_i, const float* taps_f, const int* sched,
                       int n_blocks, const int* row_off, const int* row_blk, int jmax,
                       int kmax, int maxc, float* part, float* dt_part, float* dt_grp,
                       int* tickets,
                       float* dx, float* dt, int batch, int h8, int w8, int H, int W,
                       int r_base, int HB, int C, int TOT, float th, int ignore,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMT_BWD(N)                                                                     \
  case N:                                                                               \
    return launch_bwd<N>(g, xcat, label, conf, t1, t2, taps_i, taps_f, sched, n_blocks, \
                         row_off, row_blk, jmax, kmax, maxc, part, dt_part, dt_grp,     \
                         tickets,                                                       \
                         dx, dt, batch, h8, w8, H, W, r_base, HB, C, th, ignore, s);
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
