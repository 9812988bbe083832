// Native data-loading runtime for the ADMM deconvolution framework.
//
// The reference's data path runs on Images.jl's native codecs; here the
// equivalent is a first-party C++ pipeline: libpng decode -> float32 HWC in
// [0,1] -> aligned random crop of an (x, y) image pair -> batch assembly,
// with one worker thread per pair (batch sizes are small; decode dominates).
// Exposed as a C ABI consumed from Python via ctypes
// (admm_deconv/data/native.py).  Crop offsets are drawn per-pair from a
// splitmix64 PRNG seeded with (seed, index), so results are deterministic
// and independent of thread scheduling.
//
// Build: `make -C native` -> native/build/libimagefeeder.so

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kChannels = 3;

// Error codes surfaced to Python (keep in sync with native.py).
enum ErrorCode {
  kOk = 0,
  kOpenFailed = 1,
  kDecodeFailed = 2,
  kCropTooLarge = 3,
  kNotPng = 4,
};

struct Image {
  int h = 0;
  int w = 0;
  std::vector<float> data;  // HWC, RGB, [0,1]
};

// Deterministic per-item PRNG (splitmix64).
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // Uniform integer in [0, bound) without modulo bias concerns at our sizes.
  uint64_t below(uint64_t bound) { return bound ? next() % bound : 0; }
};

int DecodePng(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return kOpenFailed;

  unsigned char header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return kNotPng;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return kDecodeFailed;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return kDecodeFailed;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return kDecodeFailed;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // Normalize every input to 8-bit RGB.
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  const size_t rowbytes = png_get_rowbytes(png, info);

  std::vector<unsigned char> raw(static_cast<size_t>(h) * rowbytes);
  std::vector<png_bytep> rows(h);
  for (int r = 0; r < h; ++r) rows[r] = raw.data() + r * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out->h = h;
  out->w = w;
  out->data.resize(static_cast<size_t>(h) * w * kChannels);
  const float scale = 1.0f / 255.0f;
  for (size_t i = 0; i < out->data.size(); ++i) {
    out->data[i] = raw[i] * scale;
  }
  return kOk;
}

void CropInto(const Image& img, int r0, int c0, int ch, int cw, float* dst) {
  for (int r = 0; r < ch; ++r) {
    const float* src = img.data.data() +
                       (static_cast<size_t>(r0 + r) * img.w + c0) * kChannels;
    std::memcpy(dst + static_cast<size_t>(r) * cw * kChannels, src,
                sizeof(float) * cw * kChannels);
  }
}

}  // namespace

extern "C" {

// Decoded image header query (h, w); channels are always normalized to 3.
int adtpu_image_size(const char* path, int* h, int* w) {
  Image img;
  int err = DecodePng(path, &img);
  if (err != kOk) return err;
  *h = img.h;
  *w = img.w;
  return kOk;
}

// Load one image whole into a caller-allocated float32 HWC buffer of
// capacity cap_h * cap_w * 3; writes actual size to (h, w).
int adtpu_load_image(const char* path, float* out, int cap_h, int cap_w,
                     int* h, int* w) {
  Image img;
  int err = DecodePng(path, &img);
  if (err != kOk) return err;
  if (img.h > cap_h || img.w > cap_w) return kCropTooLarge;
  std::memcpy(out, img.data.data(), sizeof(float) * img.data.size());
  *h = img.h;
  *w = img.w;
  return kOk;
}

// Load n (x, y) image pairs, crop both at one random offset per pair
// (reference datafeeder.jl:42-45 semantics), and assemble NHWC float32
// batches.  Offsets come from splitmix64(seed, i): deterministic under
// threading.  Returns 0 on success; per-item error codes land in errs[n].
int adtpu_load_pair_batch(const char** x_paths, const char** y_paths, int n,
                          int crop_h, int crop_w, uint64_t seed, float* out_x,
                          float* out_y, int* errs) {
  std::vector<std::thread> workers;
  workers.reserve(n);
  for (int i = 0; i < n; ++i) {
    workers.emplace_back([=]() {
      Image xi, yi;
      int err = DecodePng(x_paths[i], &xi);
      if (err == kOk) err = DecodePng(y_paths[i], &yi);
      if (err == kOk && (crop_h > yi.h || crop_w > yi.w ||
                         crop_h > xi.h || crop_w > xi.w)) {
        err = kCropTooLarge;
      }
      if (err != kOk) {
        errs[i] = err;
        return;
      }
      SplitMix64 prng(seed ^ (0xD1B54A32D192ED03ull * (i + 1)));
      const int r0 = static_cast<int>(prng.below(yi.h - crop_h + 1));
      const int c0 = static_cast<int>(prng.below(yi.w - crop_w + 1));
      const size_t plane = static_cast<size_t>(crop_h) * crop_w * kChannels;
      CropInto(xi, r0, c0, crop_h, crop_w, out_x + i * plane);
      CropInto(yi, r0, c0, crop_h, crop_w, out_y + i * plane);
      errs[i] = kOk;
    });
  }
  for (auto& t : workers) t.join();
  for (int i = 0; i < n; ++i) {
    if (errs[i] != kOk) return errs[i];
  }
  return kOk;
}

}  // extern "C"
