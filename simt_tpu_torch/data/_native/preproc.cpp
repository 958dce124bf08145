// Native image preprocessing for the simt_tpu_torch input pipeline.
//
// Pillow-exact resampling (the reference pipeline is PIL resize -> numpy,
// dataset/cityscapes_dataset.py:105-106, so PIL's fixed-point u8 rounding is part of
// the data semantics):
//   - bicubic (a = -0.5) with support scaling on downscale, horizontal-then-vertical
//     passes, fixed-point coefficients with PRECISION_BITS = 22 and u8 clipping between
//     passes — bit-identical to Pillow's ImagingResample u8 path;
//   - nearest: src = floor((dst + 0.5) * scale) (verified against Pillow);
// plus a fused RGB->BGR + mean-subtract + optional mirror epilogue producing the float32
// HWC tensor the model consumes (cityscapes_dataset.py:111-118).
//
// Built with g++ at first use as a plain shared library and bound via ctypes
// (simt_tpu_torch/data/_native_preproc.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Pillow precompute_coeffs: for each output index, the source window [bound0, bound1)
// and normalised filter weights.
struct Coeffs {
  std::vector<int> bounds;      // 2 * out_size (start, size)
  std::vector<double> weights;  // out_size * ksize
  int ksize;
};

Coeffs precompute_coeffs(int in_size, int out_size, double support_base) {
  Coeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds.resize(2 * out_size);
  c.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &c.weights[static_cast<size_t>(xx) * ksize];
    int x = 0;
    for (; x < xmax; ++x) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    c.bounds[xx * 2 + 0] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

std::vector<int> normalize_coeffs_8bpc(const Coeffs& c, int out_size) {
  std::vector<int> kk(c.weights.size());
  for (size_t i = 0; i < c.weights.size(); ++i) {
    double w = c.weights[i];
    kk[i] = static_cast<int>(w < 0 ? -0.5 + w * (1 << kPrecisionBits)
                                   : 0.5 + w * (1 << kPrecisionBits));
  }
  (void)out_size;
  return kk;
}

// One horizontal pass on interleaved u8 HWC.
void resample_horiz_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst, int dw,
                       const Coeffs& c, const std::vector<int>& kk) {
  for (int yy = 0; yy < sh; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * sw * ch;
    uint8_t* orow = dst + static_cast<size_t>(yy) * dw * ch;
    for (int xx = 0; xx < dw; ++xx) {
      int xmin = c.bounds[xx * 2 + 0];
      int xmax = c.bounds[xx * 2 + 1];
      const int* k = &kk[static_cast<size_t>(xx) * c.ksize];
      for (int b = 0; b < ch; ++b) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x)
          ss += row[(x + xmin) * ch + b] * k[x];
        orow[xx * ch + b] = clip8(ss);
      }
    }
  }
}

// One vertical pass on interleaved u8 HWC.
void resample_vert_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst, int dh,
                      const Coeffs& c, const std::vector<int>& kk) {
  for (int yy = 0; yy < dh; ++yy) {
    int ymin = c.bounds[yy * 2 + 0];
    int ymax = c.bounds[yy * 2 + 1];
    const int* k = &kk[static_cast<size_t>(yy) * c.ksize];
    uint8_t* orow = dst + static_cast<size_t>(yy) * sw * ch;
    for (int xx = 0; xx < sw * ch; ++xx) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += src[static_cast<size_t>(y + ymin) * sw * ch + xx] * k[y];
      orow[xx] = clip8(ss);
    }
  }
}

}  // namespace

extern "C" {

// Bicubic u8 HWC resize, Pillow-exact. dst must hold dh*dw*ch bytes.
int simt_resize_bicubic_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst,
                           int dh, int dw) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ch <= 0) return -1;
  Coeffs ch_coeffs = precompute_coeffs(sw, dw, 2.0);
  std::vector<int> kk_h = normalize_coeffs_8bpc(ch_coeffs, dw);
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * ch);
  resample_horiz_u8(src, sh, sw, ch, tmp.data(), dw, ch_coeffs, kk_h);
  Coeffs cv = precompute_coeffs(sh, dh, 2.0);
  std::vector<int> kk_v = normalize_coeffs_8bpc(cv, dh);
  resample_vert_u8(tmp.data(), sh, dw, ch, dst, dh, cv, kk_v);
  return 0;
}

// Nearest u8 resize (any channel count): src = floor((dst + 0.5) * scale).
int simt_resize_nearest_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst,
                           int dh, int dw) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ch <= 0) return -1;
  double sy = static_cast<double>(sh) / dh;
  double sx = static_cast<double>(sw) / dw;
  std::vector<int> xmap(dw);
  for (int x = 0; x < dw; ++x)
    xmap[x] = std::min(static_cast<int>((x + 0.5) * sx), sw - 1);
  for (int y = 0; y < dh; ++y) {
    int ys = std::min(static_cast<int>((y + 0.5) * sy), sh - 1);
    const uint8_t* row = src + static_cast<size_t>(ys) * sw * ch;
    uint8_t* orow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x)
      std::memcpy(orow + static_cast<size_t>(x) * ch, row + static_cast<size_t>(xmap[x]) * ch, ch);
  }
  return 0;
}

// Fused epilogue: u8 RGB HWC -> float32 BGR mean-subtracted HWC, optional mirror.
// (cityscapes_dataset.py:111-118: mirror flips width, RGB->BGR, subtract mean.)
int simt_bgr_meansub_f32(const uint8_t* src, int h, int w, float* dst, const float* mean_bgr,
                         int mirror) {
  if (!src || !dst || !mean_bgr) return -1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    float* orow = dst + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      int xs = mirror ? (w - 1 - x) : x;
      const uint8_t* p = row + static_cast<size_t>(xs) * 3;
      float* o = orow + static_cast<size_t>(x) * 3;
      o[0] = static_cast<float>(p[2]) - mean_bgr[0];  // B
      o[1] = static_cast<float>(p[1]) - mean_bgr[1];  // G
      o[2] = static_cast<float>(p[0]) - mean_bgr[2];  // R
    }
  }
  return 0;
}

// Full fused path: u8 RGB HWC -> bicubic resize -> BGR/mean-sub/mirror float32 HWC.
int simt_preprocess_image(const uint8_t* src, int sh, int sw, float* dst, int dh, int dw,
                          const float* mean_bgr, int mirror) {
  std::vector<uint8_t> resized(static_cast<size_t>(dh) * dw * 3);
  int rc = simt_resize_bicubic_u8(src, sh, sw, 3, resized.data(), dh, dw);
  if (rc != 0) return rc;
  return simt_bgr_meansub_f32(resized.data(), dh, dw, dst, mean_bgr, mirror);
}

}  // extern "C"
