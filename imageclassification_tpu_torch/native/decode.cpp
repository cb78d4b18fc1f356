// Native host-side image decode + resize for the feed path (the port's copy
// of imageclassification_tpu/native/decode.cpp; the code is the same, so the
// two packages decode a JPEG to the same pixels).
//
// The reference leans on torchvision/PIL inside DataLoader worker PROCESSES
// (train.py:152-159, num_workers=32) because Python threads can't decode in
// parallel. Here decode is a C function called through ctypes — ctypes drops
// the GIL for the call, so a plain ThreadPoolExecutor saturates all cores with
// no fork/pickle overhead and no worker processes.
//
// Resize implements PIL's convolution resampling exactly (separable Keys
// bicubic a=-0.5 / triangle bilinear, kernel support scaled by the downscale
// factor) so pixels match the PIL path the augmentation golden tests pin.
// JPEG decode goes through libjpeg with DCT prescaling (scale_denom) so a
// 4000px photo headed for a 224px crop never materializes at full size.
//
// Build: g++ -O3 -march=native -shared -fPIC decode.cpp -o <lib>.so -ljpeg
// (imageclassification_tpu_torch/data/native_decode.py builds it lazily into
// build/native/ and falls back to PIL when the toolchain or libjpeg is
// missing.)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
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

// ---- PIL-style separable resampling -------------------------------------

inline double cubic_keys(double x) {  // Keys bicubic, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline double triangle(double x) {  // PIL BILINEAR
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Weights {
  std::vector<int> bounds;   // [out_size * 2]: first index, count
  std::vector<double> coef;  // [out_size * ksize]
  int ksize;
};

// Precompute per-output-pixel kernels over an input span [in0, in1)
// (PIL _precompute_coeffs semantics, including support widening when
// downscaling and weight normalization).
Weights precompute(int in0, int in1, int out_size, int filter) {
  double support = filter == 1 ? 1.0 : 2.0;
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = std::max(scale, 1.0);
  support *= filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Weights w;
  w.ksize = ksize;
  w.bounds.resize(out_size * 2);
  w.coef.assign(static_cast<size_t>(out_size) * ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = std::max(static_cast<int>(center - support + 0.5), in0);
    int xmax = std::min(static_cast<int>(center + support + 0.5), in1);
    double ss = 0.0;
    double* k = &w.coef[static_cast<size_t>(xx) * ksize];
    for (int x = xmin; x < xmax; ++x) {
      double weight = filter == 1
                          ? triangle((x - center + 0.5) / filterscale)
                          : cubic_keys((x - center + 0.5) / filterscale);
      k[x - xmin] = weight;
      ss += weight;
    }
    if (ss != 0.0)
      for (int i = 0; i < xmax - xmin; ++i) k[i] /= ss;
    w.bounds[xx * 2] = xmin;
    w.bounds[xx * 2 + 1] = xmax - xmin;
  }
  return w;
}

inline uint8_t clip8(double v) {
  return static_cast<uint8_t>(std::min(std::max(v + 0.5, 0.0), 255.0));
}

// Resize the crop box [cx, cy, cw, ch] of src (h×w×3) to (out×out×3).
void resize_box(const uint8_t* src, int w, int h, int cx, int cy, int cw,
                int ch, uint8_t* dst, int out, int filter) {
  Weights wx = precompute(cx, cx + cw, out, filter);
  Weights wy = precompute(cy, cy + ch, out, filter);

  // horizontal pass over the rows the vertical pass will touch
  std::vector<double> tmp(static_cast<size_t>(h) * out * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    double* trow = &tmp[static_cast<size_t>(y) * out * 3];
    for (int xx = 0; xx < out; ++xx) {
      int xmin = wx.bounds[xx * 2];
      int cnt = wx.bounds[xx * 2 + 1];
      const double* k = &wx.coef[static_cast<size_t>(xx) * wx.ksize];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < cnt; ++i) {
        const uint8_t* p = row + static_cast<size_t>(xmin + i) * 3;
        r += p[0] * k[i];
        g += p[1] * k[i];
        b += p[2] * k[i];
      }
      trow[xx * 3] = r;
      trow[xx * 3 + 1] = g;
      trow[xx * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int yy = 0; yy < out; ++yy) {
    int ymin = wy.bounds[yy * 2];
    int cnt = wy.bounds[yy * 2 + 1];
    const double* k = &wy.coef[static_cast<size_t>(yy) * wy.ksize];
    uint8_t* drow = dst + static_cast<size_t>(yy) * out * 3;
    for (int xx = 0; xx < out; ++xx) {
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < cnt; ++i) {
        const double* p = &tmp[(static_cast<size_t>(ymin + i) * out + xx) * 3];
        r += p[0] * k[i];
        g += p[1] * k[i];
        b += p[2] * k[i];
      }
      drow[xx * 3] = clip8(r);
      drow[xx * 3 + 1] = clip8(g);
      drow[xx * 3 + 2] = clip8(b);
    }
  }
}

}  // namespace

extern "C" {

// Decode JPEG header only → writes width/height. Returns 0 on success.
int jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + crop [cx,cy,cw,ch] (in ORIGINAL image coordinates) + resize to
// out_size². filter: 1=bilinear, 2=bicubic. Returns 0 on success.
// cw/ch == -1 means full image.
int decode_crop_resize(const uint8_t* data, size_t len, int cx, int cy, int cw,
                       int ch, int out_size, int filter, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);

  int W = cinfo.image_width, H = cinfo.image_height;
  if (cw < 0) cw = W;
  if (ch < 0) ch = H;
  cx = std::max(0, std::min(cx, W - 1));
  cy = std::max(0, std::min(cy, H - 1));
  cw = std::min(cw, W - cx);
  ch = std::min(ch, H - cy);

  // DCT prescale: decode at 1/d so the crop still covers >= 2*out pixels
  // (keeps the resample a downscale, preserving quality).
  int denom = 1;
  while (denom < 8 && cw / (denom * 2) >= 2 * out_size &&
         ch / (denom * 2) >= 2 * out_size)
    denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  int dw = cinfo.output_width, dh = cinfo.output_height;
  std::vector<uint8_t> buf(static_cast<size_t>(dw) * dh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = &buf[static_cast<size_t>(cinfo.output_scanline) * dw * 3];
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // crop box in decoded coordinates
  double sx = static_cast<double>(dw) / W, sy = static_cast<double>(dh) / H;
  int dcx = static_cast<int>(cx * sx), dcy = static_cast<int>(cy * sy);
  int dcw = std::max(1, static_cast<int>(cw * sx));
  int dch = std::max(1, static_cast<int>(ch * sy));
  dcw = std::min(dcw, dw - dcx);
  dch = std::min(dch, dh - dcy);

  resize_box(buf.data(), dw, dh, dcx, dcy, dcw, dch, out, out_size, filter);
  return 0;
}

}  // extern "C"
