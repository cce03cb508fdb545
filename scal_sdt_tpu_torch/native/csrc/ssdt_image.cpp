// Native image pipeline: decode + Lanczos resize + crop + normalize.
//
// The hot host-side path of the input pipeline (the reference delegates this
// to torch DataLoader workers running PIL; SURVEY.md §7.3 flags host-side
// decode/resize as the throughput bottleneck at multi-chip scale). This
// library does the whole per-image transform in one C call:
//
//   JPEG/PNG bytes -> (DCT-scaled) decode -> separable Lanczos-3 resize
//   covering the target -> center/offset crop -> float32 [-1, 1] HWC
//
// JPEG decode uses libjpeg's scale_num/scale_denom to decode directly at
// 1/2, 1/4, 1/8 scale when the target is much smaller than the source --
// the classic trick that cuts decode time by the square of the factor.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Python falls back to PIL when the library is absent.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kLanczosA = 3;

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const uint8_t* bytes, size_t len, int target_w, int target_h,
                 Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  // DCT-domain downscale: pick the largest 1/N (N in 1,2,4,8) that still
  // leaves both dims >= the Lanczos target (plus a quality margin).
  if (target_w > 0 && target_h > 0) {
    int denom = 1;
    while (denom < 8 &&
           (int)cinfo.image_width / (denom * 2) >= target_w * 2 &&
           (int)cinfo.image_height / (denom * 2) >= target_h * 2) {
      denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize((size_t)out->w * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* bytes;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "short read");
  }
  std::memcpy(out, st->bytes + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* bytes, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(bytes, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{bytes, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->c = 3;
  out->data.resize((size_t)out->w * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) {
    rows[y] = out->data.data() + (size_t)y * out->w * 3;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// Separable Lanczos-3 resize (uint8 in, float accumulate)
// ---------------------------------------------------------------------------

float lanczos(float x) {
  if (x == 0.0f) return 1.0f;
  if (x <= -kLanczosA || x >= kLanczosA) return 0.0f;
  float pix = 3.14159265358979323846f * x;
  return kLanczosA * std::sin(pix) * std::sin(pix / kLanczosA) / (pix * pix);
}

struct FilterBank {
  int taps;                    // taps per output pixel
  std::vector<int> start;      // first source index per output pixel
  std::vector<float> weights;  // taps weights per output pixel
};

FilterBank build_filter(int src, int dst) {
  FilterBank fb;
  float scale = (float)src / dst;
  float support = std::max(scale, 1.0f) * kLanczosA;
  fb.taps = (int)std::ceil(support) * 2 + 1;
  fb.start.resize(dst);
  fb.weights.resize((size_t)dst * fb.taps);
  for (int i = 0; i < dst; ++i) {
    float center = (i + 0.5f) * scale;
    int lo = (int)std::floor(center - support);
    fb.start[i] = lo;
    float sum = 0.0f;
    for (int t = 0; t < fb.taps; ++t) {
      float x = (lo + t + 0.5f - center) / std::max(scale, 1.0f);
      float w = lanczos(x);
      fb.weights[(size_t)i * fb.taps + t] = w;
      sum += w;
    }
    if (sum != 0.0f) {
      for (int t = 0; t < fb.taps; ++t) fb.weights[(size_t)i * fb.taps + t] /= sum;
    }
  }
  return fb;
}

// horizontal pass: (h, src_w, 3) u8 -> (h, dst_w, 3) float
void resize_pass_h(const uint8_t* src, int h, int src_w, int dst_w,
                   const FilterBank& fb, std::vector<float>* out) {
  out->assign((size_t)h * dst_w * 3, 0.0f);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + (size_t)y * src_w * 3;
    float* orow = out->data() + (size_t)y * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      const float* w = fb.weights.data() + (size_t)x * fb.taps;
      int lo = fb.start[x];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int t = 0; t < fb.taps; ++t) {
        int sx = std::clamp(lo + t, 0, src_w - 1);
        const uint8_t* p = row + (size_t)sx * 3;
        acc0 += w[t] * p[0];
        acc1 += w[t] * p[1];
        acc2 += w[t] * p[2];
      }
      orow[(size_t)x * 3 + 0] = acc0;
      orow[(size_t)x * 3 + 1] = acc1;
      orow[(size_t)x * 3 + 2] = acc2;
    }
  }
}

// vertical pass: (src_h, w, 3) float -> (dst_h, w, 3) float
void resize_pass_v(const std::vector<float>& src, int src_h, int w, int dst_h,
                   const FilterBank& fb, std::vector<float>* out) {
  out->assign((size_t)dst_h * w * 3, 0.0f);
  for (int y = 0; y < dst_h; ++y) {
    const float* wts = fb.weights.data() + (size_t)y * fb.taps;
    int lo = fb.start[y];
    float* orow = out->data() + (size_t)y * w * 3;
    for (int t = 0; t < fb.taps; ++t) {
      int sy = std::clamp(lo + t, 0, src_h - 1);
      const float* irow = src.data() + (size_t)sy * w * 3;
      float wt = wts[t];
      for (int i = 0; i < w * 3; ++i) orow[i] += wt * irow[i];
    }
  }
}

}  // namespace

extern "C" {

// Decode `bytes`, resize preserving aspect ratio to cover (target_w,
// target_h), crop at (crop_x_frac, crop_y_frac) in [0,1] (0.5 = center),
// write float32 HWC in [-1, 1] to `out` (target_h*target_w*3 floats).
// Returns 0 on success.
int ssdt_decode_resize_crop(const uint8_t* bytes, long len,
                            int target_w, int target_h,
                            float crop_x_frac, float crop_y_frac,
                            float* out) {
  Image img;
  if (!decode_jpeg(bytes, (size_t)len, target_w, target_h, &img) &&
      !decode_png(bytes, (size_t)len, &img)) {
    return 1;
  }
  if (img.w <= 0 || img.h <= 0) return 2;

  // cover-resize dims
  float scale = std::max((float)target_w / img.w, (float)target_h / img.h);
  int rw = std::max((int)std::lround(img.w * scale), target_w);
  int rh = std::max((int)std::lround(img.h * scale), target_h);

  FilterBank fh = build_filter(img.w, rw);
  FilterBank fv = build_filter(img.h, rh);
  std::vector<float> tmp, resized;
  resize_pass_h(img.data.data(), img.h, img.w, rw, fh, &tmp);
  resize_pass_v(tmp, img.h, rw, rh, fv, &resized);

  int x0 = (int)std::lround((rw - target_w) * std::clamp(crop_x_frac, 0.0f, 1.0f));
  int y0 = (int)std::lround((rh - target_h) * std::clamp(crop_y_frac, 0.0f, 1.0f));

  for (int y = 0; y < target_h; ++y) {
    const float* irow = resized.data() + ((size_t)(y + y0) * rw + x0) * 3;
    float* orow = out + (size_t)y * target_w * 3;
    for (int i = 0; i < target_w * 3; ++i) {
      float v = std::clamp(irow[i], 0.0f, 255.0f);
      orow[i] = v * (2.0f / 255.0f) - 1.0f;
    }
  }
  return 0;
}

// Header-only probe: returns 0 and fills (w, h) without full decode (JPEG) or
// with minimal read (PNG).
int ssdt_image_size(const uint8_t* bytes, long len, int* w, int* h) {
  // JPEG header
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (!setjmp(jerr.setjmp_buffer)) {
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes, (size_t)len);
    if (jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK) {
      *w = cinfo.image_width;
      *h = cinfo.image_height;
      jpeg_destroy_decompress(&cinfo);
      return 0;
    }
  }
  jpeg_destroy_decompress(&cinfo);

  if (len >= 24 && !png_sig_cmp(bytes, 0, 8)) {
    // IHDR is the first chunk: width/height big-endian at offsets 16/20
    auto be32 = [&](int off) {
      return ((uint32_t)bytes[off] << 24) | ((uint32_t)bytes[off + 1] << 16) |
             ((uint32_t)bytes[off + 2] << 8) | (uint32_t)bytes[off + 3];
    };
    *w = (int)be32(16);
    *h = (int)be32(20);
    return 0;
  }
  return 1;
}

}  // extern "C"
