// hairci native image loader — C++ decode + resample + crop, the native
// equivalent of the reference's data-loading machinery (torch DataLoader
// worker processes decoding via PIL, /root/reference/HairPretraining/
// utils/dataloader.py:13-41). Python threads + PIL are GIL-bound on the
// numpy conversion and per-image Python overhead; this library decodes a
// whole batch with an internal std::thread pool and writes straight into
// the caller's uint8 NHWC buffer.
//
// Modes (match hairci/data/loader.py decode_image):
//   0 raw_resize   : stretch-resize to (size, size)
//   1 center_crop  : decode only, zero-pad if small, center crop
//
// Resampling is a separable triangle (bilinear) filter with support
// scaling — the same convolution-based algorithm Pillow uses for
// Image.resize(..., BILINEAR), computed in float (Pillow uses 8-bit
// fixed-point coefficients, so outputs may differ by ±1-2 LSB).
//
// JPEG decode uses libjpeg with DCT scaling (scale_denom) when the target
// is much smaller than the source; PNG uses libpng's simplified API.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // (h, w, 3)
};

// ---------------------------------------------------------------- jpeg --

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, int target, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT downscale: keep the shorter decoded side >= 2x the target (quality
  // headroom for the triangle filter), or full size when target == 0
  if (target > 0) {
    int shorter = std::min<int>(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && shorter / (denom * 2) >= 2 * target) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- png --

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  img.format = PNG_FORMAT_RGB;
  out->w = img.width;
  out->h = img.height;
  out->rgb.resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

// ------------------------------------------------------------- resample --

// Pillow-style separable triangle filter: support 1.0, scaled by the
// downscale factor (antialias). Weights are renormalized per output pixel.
struct FilterTable {
  int kmax;
  std::vector<int> starts, counts;
  std::vector<float> weights;  // (n_out, kmax)
};

FilterTable make_triangle(int n_in, int n_out) {
  FilterTable t;
  double scale = double(n_in) / n_out;
  double support = std::max(scale, 1.0);  // triangle support * filterscale
  t.kmax = int(std::ceil(support)) * 2 + 1;
  t.starts.resize(n_out);
  t.counts.resize(n_out);
  t.weights.assign(size_t(n_out) * t.kmax, 0.f);
  for (int i = 0; i < n_out; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(n_in, int(center + support + 0.5));
    t.starts[i] = lo;
    t.counts[i] = hi - lo;
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double x = (j + 0.5 - center) / (support > 1.0 ? scale : 1.0);
      double wgt = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (wgt < 0) wgt = 0;
      t.weights[size_t(i) * t.kmax + (j - lo)] = float(wgt);
      total += wgt;
    }
    if (total > 0)
      for (int j = 0; j < hi - lo; ++j)
        t.weights[size_t(i) * t.kmax + j] /= float(total);
  }
  return t;
}

void resize_bilinear(const Image& in, int out_w, int out_h,
                     uint8_t* out /* (out_h, out_w, 3) */) {
  FilterTable fx = make_triangle(in.w, out_w);
  FilterTable fy = make_triangle(in.h, out_h);
  // horizontal pass: (in.h, in.w, 3) u8 → (in.h, out_w, 3) f32
  std::vector<float> tmp(size_t(in.h) * out_w * 3);
  for (int r = 0; r < in.h; ++r) {
    const uint8_t* srow = in.rgb.data() + size_t(r) * in.w * 3;
    float* drow = tmp.data() + size_t(r) * out_w * 3;
    for (int i = 0; i < out_w; ++i) {
      const float* w = &fx.weights[size_t(i) * fx.kmax];
      const uint8_t* s = srow + size_t(fx.starts[i]) * 3;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int j = 0; j < fx.counts[i]; ++j) {
        float wj = w[j];
        a0 += wj * s[j * 3 + 0];
        a1 += wj * s[j * 3 + 1];
        a2 += wj * s[j * 3 + 2];
      }
      drow[i * 3 + 0] = a0;
      drow[i * 3 + 1] = a1;
      drow[i * 3 + 2] = a2;
    }
  }
  // vertical pass: row-streaming SAXPY over whole rows (cache-friendly)
  int rw = out_w * 3;
  std::vector<float> acc(rw);
  for (int i = 0; i < out_h; ++i) {
    const float* w = &fy.weights[size_t(i) * fy.kmax];
    std::fill(acc.begin(), acc.end(), 0.f);
    for (int j = 0; j < fy.counts[i]; ++j) {
      const float* srow = tmp.data() + size_t(fy.starts[i] + j) * rw;
      float wj = w[j];
      for (int x = 0; x < rw; ++x) acc[x] += wj * srow[x];
    }
    uint8_t* drow = out + size_t(i) * rw;
    for (int x = 0; x < rw; ++x) {
      float v = acc[x];
      drow[x] = uint8_t(v < 0.f ? 0 : v > 255.f ? 255 : int(v + 0.5f));
    }
  }
}

void center_crop_pad(const Image& in, int size, uint8_t* out) {
  std::memset(out, 0, size_t(size) * size * 3);
  int ph = std::max(size - in.h, 0), pw = std::max(size - in.w, 0);
  int vh = std::min(in.h, size), vw = std::min(in.w, size);
  // source offsets (round like torchvision CenterCrop)
  int top = in.h > size ? int(std::lround((in.h - size) / 2.0)) : 0;
  int left = in.w > size ? int(std::lround((in.w - size) / 2.0)) : 0;
  int oy = ph / 2, ox = pw / 2;
  for (int r = 0; r < vh; ++r)
    std::memcpy(out + (size_t(oy + r) * size + ox) * 3,
                in.rgb.data() + (size_t(top + r) * in.w + left) * 3,
                size_t(vw) * 3);
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  if (len <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(len);
  bool ok = std::fread(buf->data(), 1, len, f) == size_t(len);
  std::fclose(f);
  return ok;
}

bool decode_one(const char* path, int size, int mode, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 8) return false;
  Image img;
  bool ok = false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg(buf.data(), buf.size(), mode == 0 ? size : 0, &img);
  } else if (buf[0] == 0x89 && buf[1] == 'P') {
    ok = decode_png(buf.data(), buf.size(), &img);
  } else {
    // try both (extension lies happen)
    ok = decode_jpeg(buf.data(), buf.size(), mode == 0 ? size : 0, &img) ||
         decode_png(buf.data(), buf.size(), &img);
  }
  if (!ok || img.w <= 0 || img.h <= 0) return false;
  if (mode == 0) {
    resize_bilinear(img, size, size, out);
  } else {
    center_crop_pad(img, size, out);
  }
  return true;
}

}  // namespace

extern "C" {

// Decodes n images into out (n, size, size, 3) uint8; ok[i] = 1 on success.
// Returns the number of successfully decoded images.
int64_t hairci_decode_batch(const char** paths, int64_t n, int size,
                            int mode, int n_threads, uint8_t* out,
                            uint8_t* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0), good(0);
  size_t stride = size_t(size) * size * 3;
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      bool res = decode_one(paths[i], size, mode, out + size_t(i) * stride);
      ok[i] = res ? 1 : 0;
      if (res) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = int(std::min<int64_t>(n_threads, n));
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return good.load();
}

}  // extern "C"
