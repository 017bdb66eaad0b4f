// Native image-decode + resample runtime for the data pipeline (a copy of
// the JAX package's native/src/affdata.cpp; the code below this comment is
// unchanged, so both libraries give the same bytes).
//
// Replaces the hot part of the host input pipeline (JPEG decode + crop +
// resize; reference data/build.py:86-95 does this via PIL inside 32 torch
// worker processes). Three tricks keep it fast:
//   1. libjpeg-turbo scaled decode (scale_num/8): DCT-domain downscale to
//      the smallest resolution that still covers the requested output, so
//      a 500x375 source for a 224 crop is decoded at ~1/2 scale.
//   2. jpeg_crop_scanline + jpeg_skip_scanlines: only the crop region's
//      scanlines are decoded (RandomResizedCrop averages ~55% of the area).
//   3. A PIL-equivalent separable resampler (Keys bicubic a=-0.5 /
//      triangle bilinear, antialias taps widened by the scale factor) so
//      train/eval numerics match the PIL fallback path to ~1 LSB.
//
// Pure C ABI; consumed via ctypes from
// ml_autofocusformermod_torch/data/native_jpeg.py, which builds it with g++
// and -ljpeg at first use.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void output_message(j_common_ptr) {}  // silence libjpeg warnings

// --- PIL-equivalent separable resampling -------------------------------
// Matches PIL's ImagingResample: tap centers at (i + 0.5) * scale + box0,
// kernel support widened by the scale factor when downscaling, weights
// normalized per output pixel.

double filter_bilinear(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

double filter_bicubic(double x) {  // Keys kernel, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Taps {
  std::vector<int> bounds;     // (first, count) per output pixel
  std::vector<double> coeffs;  // ksize weights per output pixel
  int ksize = 0;
};

Taps precompute_taps(double box0, double box1, int out_size, int in_size,
                     int filter) {
  double support = filter == 1 ? 2.0 : 1.0;
  double (*kernel)(double) = filter == 1 ? filter_bicubic : filter_bilinear;
  double scale = (box1 - box0) / out_size;
  double filterscale = std::max(scale, 1.0);
  support *= filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Taps t;
  t.ksize = ksize;
  t.bounds.resize(out_size * 2);
  t.coeffs.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int i = 0; i < out_size; i++) {
    double center = box0 + (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    xmin = std::max(xmin, 0);
    int xmax = static_cast<int>(center + support + 0.5);
    xmax = std::min(xmax, in_size);
    double* k = &t.coeffs[static_cast<size_t>(i) * ksize];
    double ww = 0.0;
    for (int x = xmin; x < xmax; x++) {
      double w = kernel((x + 0.5 - center) / filterscale);
      k[x - xmin] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax - xmin; x++) k[x] /= ww;
    t.bounds[i * 2] = xmin;
    t.bounds[i * 2 + 1] = std::max(xmax - xmin, 0);
  }
  return t;
}

inline uint8_t clip8(double v) {
  return static_cast<uint8_t>(std::min(std::max(v + 0.5, 0.0), 255.0));
}

// Resample (in_h, in_w, 3) uint8 -> (out_h, out_w, 3) uint8 over float box.
void resample(const uint8_t* in, int in_w, int in_h, double bx, double by,
              double bw, double bh, uint8_t* out, int out_w, int out_h,
              int filter, int flip) {
  Taps tx = precompute_taps(bx, bx + bw, out_w, in_w, filter);
  Taps ty = precompute_taps(by, by + bh, out_h, in_h, filter);

  // horizontal pass (full input height band is needed by the vertical pass)
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; y++) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    float* trow = &tmp[static_cast<size_t>(y) * out_w * 3];
    for (int i = 0; i < out_w; i++) {
      int x0 = tx.bounds[i * 2], cnt = tx.bounds[i * 2 + 1];
      const double* k = &tx.coeffs[static_cast<size_t>(i) * tx.ksize];
      double r = 0, g = 0, b = 0;
      for (int x = 0; x < cnt; x++) {
        const uint8_t* p = row + static_cast<size_t>(x0 + x) * 3;
        r += p[0] * k[x];
        g += p[1] * k[x];
        b += p[2] * k[x];
      }
      trow[i * 3] = static_cast<float>(r);
      trow[i * 3 + 1] = static_cast<float>(g);
      trow[i * 3 + 2] = static_cast<float>(b);
    }
  }
  // vertical pass + optional horizontal flip
  for (int j = 0; j < out_h; j++) {
    int y0 = ty.bounds[j * 2], cnt = ty.bounds[j * 2 + 1];
    const double* k = &ty.coeffs[static_cast<size_t>(j) * ty.ksize];
    uint8_t* orow = out + static_cast<size_t>(j) * out_w * 3;
    for (int i = 0; i < out_w; i++) {
      double r = 0, g = 0, b = 0;
      for (int y = 0; y < cnt; y++) {
        const float* p = &tmp[(static_cast<size_t>(y0 + y) * out_w + i) * 3];
        r += p[0] * k[y];
        g += p[1] * k[y];
        b += p[2] * k[y];
      }
      int oi = flip ? out_w - 1 - i : i;
      orow[oi * 3] = clip8(r);
      orow[oi * 3 + 1] = clip8(g);
      orow[oi * 3 + 2] = clip8(b);
    }
  }
}

// --- RandAugment op executors (PIL-parity) ------------------------------
// Python samples the plan (op ids + signed params, owning the rng); this
// side only executes. Numerics follow PIL's implementations: ITU-R 601-2
// integer luma, enhance = blend against a degenerate image, histogram ops
// per PIL's exact LUT construction, affine ops = inverse-map bilinear with
// black fill and half-pixel centers.

inline int pil_luma(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16;
}

void blend_inplace(uint8_t* img, const uint8_t* degenerate, size_t n,
                   double factor) {
  for (size_t i = 0; i < n; i++) {
    // PIL's ImagingBlend truncates (no +0.5 rounding)
    int v = static_cast<int>(degenerate[i] + factor * (img[i] - degenerate[i]));
    img[i] = static_cast<uint8_t>(std::min(std::max(v, 0), 255));
  }
}

void op_lut(uint8_t* img, size_t npx, const uint8_t lut[3][256]) {
  for (size_t i = 0; i < npx; i++) {
    img[i * 3] = lut[0][img[i * 3]];
    img[i * 3 + 1] = lut[1][img[i * 3 + 1]];
    img[i * 3 + 2] = lut[2][img[i * 3 + 2]];
  }
}

void op_autocontrast(uint8_t* img, int w, int h) {
  size_t npx = static_cast<size_t>(w) * h;
  uint8_t lut[3][256];
  for (int c = 0; c < 3; c++) {
    int hist[256] = {0};
    for (size_t i = 0; i < npx; i++) hist[img[i * 3 + c]]++;
    int lo = 0, hi = 255;
    while (lo < 256 && hist[lo] == 0) lo++;
    while (hi >= 0 && hist[hi] == 0) hi--;
    if (hi <= lo) {
      for (int i = 0; i < 256; i++) lut[c][i] = static_cast<uint8_t>(i);
    } else {
      double scale = 255.0 / (hi - lo);
      double offset = -lo * scale;
      for (int i = 0; i < 256; i++) {
        int ix = static_cast<int>(i * scale + offset);
        lut[c][i] = static_cast<uint8_t>(std::min(std::max(ix, 0), 255));
      }
    }
  }
  op_lut(img, npx, lut);
}

void op_equalize(uint8_t* img, int w, int h) {
  size_t npx = static_cast<size_t>(w) * h;
  uint8_t lut[3][256];
  for (int c = 0; c < 3; c++) {
    int hist[256] = {0};
    for (size_t i = 0; i < npx; i++) hist[img[i * 3 + c]]++;
    // PIL ImageOps.equalize LUT
    long total = 0;
    int nonzero = 0, last_nz = 0;
    for (int i = 0; i < 256; i++)
      if (hist[i]) { total += hist[i]; nonzero++; last_nz = i; }
    long step = nonzero <= 1 ? 0 : (total - hist[last_nz]) / 255;
    if (step == 0) {
      for (int i = 0; i < 256; i++) lut[c][i] = static_cast<uint8_t>(i);
    } else {
      long n = step / 2;
      for (int i = 0; i < 256; i++) {
        long v = n / step;
        lut[c][i] = static_cast<uint8_t>(std::min(v, 255L));
        n += hist[i];
      }
    }
  }
  op_lut(img, npx, lut);
}

void op_affine_bilinear(uint8_t* img, int w, int h, double a, double b,
                        double c, double d, double e, double f) {
  // out(x, y) = in(a*(x+.5)+b*(y+.5)+c-.5, d*(x+.5)+e*(y+.5)+f-.5),
  // black fill outside (PIL transform AFFINE + BILINEAR semantics)
  std::vector<uint8_t> src(img, img + static_cast<size_t>(w) * h * 3);
  for (int y = 0; y < h; y++) {
    uint8_t* orow = img + static_cast<size_t>(y) * w * 3;
    double xs0 = a * 0.5 + b * (y + 0.5) + c - 0.5;
    double ys0 = d * 0.5 + e * (y + 0.5) + f - 0.5;
    for (int x = 0; x < w; x++) {
      double xs = xs0 + a * x;
      double ys = ys0 + d * x;
      // PIL fills when the pre-shift source coord leaves [0, size)
      if (xs < -0.5 || xs >= w - 0.5 || ys < -0.5 || ys >= h - 0.5) {
        orow[x * 3] = orow[x * 3 + 1] = orow[x * 3 + 2] = 0;
        continue;
      }
      int x0 = static_cast<int>(std::floor(xs));
      int y0 = static_cast<int>(std::floor(ys));
      double fx = xs - x0, fy = ys - y0;
      int x1 = x0 + 1, y1 = y0 + 1;
      double w00 = (1 - fx) * (1 - fy), w10 = fx * (1 - fy);
      double w01 = (1 - fx) * fy, w11 = fx * fy;
      // PIL's bilinear filter clamps edge taps to the border pixel
      auto tap = [&](int xx, int yy) -> const uint8_t* {
        xx = std::min(std::max(xx, 0), w - 1);
        yy = std::min(std::max(yy, 0), h - 1);
        return &src[(static_cast<size_t>(yy) * w + xx) * 3];
      };
      const uint8_t* p00 = tap(x0, y0);
      const uint8_t* p10 = tap(x1, y0);
      const uint8_t* p01 = tap(x0, y1);
      const uint8_t* p11 = tap(x1, y1);
      for (int ch = 0; ch < 3; ch++) {
        double v = w00 * p00[ch] + w10 * p10[ch] + w01 * p01[ch] +
                   w11 * p11[ch];
        orow[x * 3 + ch] = clip8(v);
      }
    }
  }
}

void op_smooth(const uint8_t* src, uint8_t* dst, int w, int h) {
  // PIL ImageFilter.SMOOTH: 3x3 [1 1 1; 1 5 1; 1 1 1] / 13, border copied
  std::memcpy(dst, src, static_cast<size_t>(w) * h * 3);
  for (int y = 1; y < h - 1; y++) {
    for (int x = 1; x < w - 1; x++) {
      for (int c = 0; c < 3; c++) {
        int s = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int wgt = (dx == 0 && dy == 0) ? 5 : 1;
            s += wgt * src[(static_cast<size_t>(y + dy) * w + x + dx) * 3 + c];
          }
        dst[(static_cast<size_t>(y) * w + x) * 3 + c] =
            clip8(s / 13.0);
      }
    }
  }
}

}  // namespace

extern "C" {

// Execute a pre-drawn RandAugment plan in place on (h, w, 3) uint8 RGB.
// Op ids follow transforms.RA_OP_IDS; params carry the already-signed
// magnitudes. Returns 0 on success.
int aff_randaugment(uint8_t* img, int w, int h, const int* op_ids,
                    const double* params, int n_ops) {
  size_t npx = static_cast<size_t>(w) * h;
  size_t nb = npx * 3;
  std::vector<uint8_t> scratch;
  for (int oi = 0; oi < n_ops; oi++) {
    double p = params[oi];
    switch (op_ids[oi]) {
      case 0:  // auto_contrast
        op_autocontrast(img, w, h);
        break;
      case 1:  // equalize
        op_equalize(img, w, h);
        break;
      case 2:  // invert
        for (size_t i = 0; i < nb; i++) img[i] = 255 - img[i];
        break;
      case 3: {  // rotate(deg CCW) about center — PIL negates the angle
        double ang = -p * M_PI / 180.0;
        double co = std::cos(ang), si = std::sin(ang);
        double cx = w / 2.0, cy = h / 2.0;
        op_affine_bilinear(img, w, h, co, si, cx - co * cx - si * cy,
                           -si, co, cy + si * cx - co * cy);
        break;
      }
      case 4: {  // posterize(bits)
        int bits = static_cast<int>(p);
        uint8_t mask = static_cast<uint8_t>(255 << (8 - bits));
        for (size_t i = 0; i < nb; i++) img[i] &= mask;
        break;
      }
      case 5: {  // solarize(threshold)
        int t = static_cast<int>(p);
        for (size_t i = 0; i < nb; i++)
          if (img[i] >= t) img[i] = 255 - img[i];
        break;
      }
      case 6: {  // solarize_add
        int add = static_cast<int>(p);
        for (size_t i = 0; i < nb; i++)
          if (img[i] < 128)
            img[i] = static_cast<uint8_t>(
                std::min(std::max(img[i] + add, 0), 255));
        break;
      }
      case 7: {  // color (saturation): degenerate = grayscale
        scratch.resize(nb);
        for (size_t i = 0; i < npx; i++) {
          uint8_t l = static_cast<uint8_t>(
              pil_luma(img[i * 3], img[i * 3 + 1], img[i * 3 + 2]));
          scratch[i * 3] = scratch[i * 3 + 1] = scratch[i * 3 + 2] = l;
        }
        blend_inplace(img, scratch.data(), nb, p);
        break;
      }
      case 8: {  // contrast: degenerate = solid mean-luma gray
        long sum = 0;
        for (size_t i = 0; i < npx; i++)
          sum += pil_luma(img[i * 3], img[i * 3 + 1], img[i * 3 + 2]);
        uint8_t mean = static_cast<uint8_t>(
            std::min<long>(std::max<long>(
                static_cast<long>(sum / static_cast<double>(npx) + 0.5), 0),
                255));
        scratch.assign(nb, mean);
        blend_inplace(img, scratch.data(), nb, p);
        break;
      }
      case 9: {  // brightness: degenerate = black
        scratch.assign(nb, 0);
        blend_inplace(img, scratch.data(), nb, p);
        break;
      }
      case 10: {  // sharpness: degenerate = SMOOTH-filtered
        scratch.resize(nb);
        op_smooth(img, scratch.data(), w, h);
        blend_inplace(img, scratch.data(), nb, p);
        break;
      }
      case 11:  // shear_x
        op_affine_bilinear(img, w, h, 1, p, 0, 0, 1, 0);
        break;
      case 12:  // shear_y
        op_affine_bilinear(img, w, h, 1, 0, 0, p, 1, 0);
        break;
      case 13:  // translate_x (pixels)
        op_affine_bilinear(img, w, h, 1, 0, p, 0, 1, 0);
        break;
      case 14:  // translate_y
        op_affine_bilinear(img, w, h, 1, 0, 0, 0, 1, p);
        break;
      default:
        return 1;
    }
  }
  return 0;
}

int aff_version() { return 1; }

// Parse header only; returns 0 on success.
int aff_jpeg_dims(const uint8_t* buf, long n, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode `buf`, crop float box (bx, by, bw, bh) in ORIGINAL image coords,
// resample to (out_w, out_h) RGB uint8 into `out`. filter: 0 bilinear,
// 1 bicubic. flip: mirror horizontally. fast_scale enables DCT-domain
// downscale (training; ~1 LSB different from full decode on photos) —
// eval passes 0 for exact-parity full-resolution decode.
// Returns 0 on success.
int aff_jpeg_decode_resample(const uint8_t* buf, long n, double bx, double by,
                             double bw, double bh, int out_w, int out_h,
                             int flip, int filter, int fast_scale,
                             uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain downscale: smallest num/8 whose scaled crop still covers
  // the output (never decode-upscale; resampler handles the rest)
  double need = std::max(out_w / std::max(bw, 1.0),
                         out_h / std::max(bh, 1.0));
  int num = 8;
  if (fast_scale && need < 1.0)
    num = std::min(8, std::max(1, static_cast<int>(std::ceil(8.0 * need))));
  cinfo.scale_num = static_cast<unsigned int>(num);
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);

  const double sx = static_cast<double>(cinfo.output_width) /
                    static_cast<double>(cinfo.image_width);
  const double sy = static_cast<double>(cinfo.output_height) /
                    static_cast<double>(cinfo.image_height);
  const int sw = static_cast<int>(cinfo.output_width);
  const int sh = static_cast<int>(cinfo.output_height);
  // crop box in scaled coords, clamped
  double cbx = std::min(std::max(bx * sx, 0.0), static_cast<double>(sw));
  double cby = std::min(std::max(by * sy, 0.0), static_cast<double>(sh));
  double cbw = std::min(bw * sx, sw - cbx);
  double cbh = std::min(bh * sy, sh - cby);
  if (cbw <= 0 || cbh <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }

  // decode only the needed scanline band and horizontal strip, widened by
  // the resampler's tap support so border taps read the same pixels PIL's
  // whole-image resize would (taps extend beyond the crop box)
  const int mgx = static_cast<int>(
      std::ceil(2.0 * std::max(cbw / out_w, 1.0))) + 1;
  const int mgy = static_cast<int>(
      std::ceil(2.0 * std::max(cbh / out_h, 1.0))) + 1;
  JDIMENSION xoff = static_cast<JDIMENSION>(
      std::max(static_cast<int>(std::floor(cbx)) - mgx, 0));
  JDIMENSION xw = std::min<JDIMENSION>(
      static_cast<JDIMENSION>(std::ceil(cbx + cbw)) + mgx, sw) - xoff;
  xw = std::min<JDIMENSION>(std::max<JDIMENSION>(xw, 1), sw - xoff);
  jpeg_crop_scanline(&cinfo, &xoff, &xw);  // may widen to iMCU bounds
  int y0 = std::max(static_cast<int>(std::floor(cby)) - mgy, 0);
  int y1 = std::min(static_cast<int>(std::ceil(cby + cbh)) + mgy, sh);
  if (y0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(y0));

  const int band_h = y1 - y0;
  std::vector<uint8_t> band(static_cast<size_t>(band_h) * xw * 3);
  while (static_cast<int>(cinfo.output_scanline) < y1) {
    int row = static_cast<int>(cinfo.output_scanline) - y0;
    JSAMPROW rp = band.data() + static_cast<size_t>(row) * xw * 3;
    if (jpeg_read_scanlines(&cinfo, &rp, 1) != 1) break;
  }
  jpeg_abort_decompress(&cinfo);  // skip remaining scanlines cleanly
  jpeg_destroy_decompress(&cinfo);

  resample(band.data(), static_cast<int>(xw), band_h, cbx - xoff, cby - y0,
           cbw, cbh, out, out_w, out_h, filter, flip);
  return 0;
}

// Plain RGB-buffer resample (used for parity tests and non-JPEG sources).
int aff_resample_rgb(const uint8_t* in, int in_w, int in_h, double bx,
                     double by, double bw, double bh, int out_w, int out_h,
                     int flip, int filter, uint8_t* out) {
  if (bw <= 0 || bh <= 0 || in_w <= 0 || in_h <= 0) return 1;
  resample(in, in_w, in_h, bx, by, bw, bh, out, out_w, out_h, filter, flip);
  return 0;
}

}  // extern "C"
