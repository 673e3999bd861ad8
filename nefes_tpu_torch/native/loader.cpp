// Native multithreaded image loader for nefes_tpu_torch (a copy of the
// JAX package's nefes_tpu/native/loader.cpp; the code below is the same).
//
// Role: the reference feeds images through torch DataLoader worker
// processes (C++ under the hood); this framework preloads whole scenes,
// so decode throughput is the wall. This library decodes PNG/JPEG files
// on a std::thread pool and box-downsamples to the target size
// (cv2.INTER_AREA-equivalent for integer ratios — the only ratios the
// 7-Scenes/Cambridge configs use), writing float32 RGB in [0,1].
//
// Exposed via ctypes (see nefes_tpu_torch/native/__init__.py); no pybind11.

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

namespace {

struct Decoded {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0, w = 0;
  bool ok = false;
};

bool has_suffix(const char* s, const char* suf) {
  size_t n = std::strlen(s), m = std::strlen(suf);
  if (m > n) return false;
  for (size_t i = 0; i < m; ++i) {
    char a = s[n - m + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

Decoded decode_png(const char* path) {
  Decoded out;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return out;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  // row-pointer buffer is malloc'd (NOT a std::vector): libpng reports
  // errors via longjmp, which must not skip C++ destructors
  png_bytep* rows = nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    std::free(rows);
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    out.ok = false;
    return out;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out.h = (int)h;
  out.w = (int)w;
  out.rgb.resize((size_t)h * w * 3);
  rows = (png_bytep*)std::malloc(sizeof(png_bytep) * h);
  if (!rows) longjmp(png_jmpbuf(png), 1);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out.rgb.data() + (size_t)y * w * 3;
  png_read_image(png, rows);
  std::free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out.ok = true;
  return out;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

Decoded decode_jpeg(const char* path) {
  Decoded out;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.rgb.resize((size_t)out.h * out.w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out.rgb.data() + (size_t)cinfo.output_scanline * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  out.ok = true;
  return out;
}

// Box-filter downsample (exact cv2.INTER_AREA for integer ratios) or
// bilinear resize otherwise; writes float32 [0,1] HWC.
void resample(const Decoded& img, int oh, int ow, float* dst) {
  const int h = img.h, w = img.w;
  if (h == oh && w == ow) {
    const size_t n = (size_t)h * w * 3;
    for (size_t i = 0; i < n; ++i) dst[i] = img.rgb[i] / 255.0f;
    return;
  }
  if (h % oh == 0 && w % ow == 0) {  // integer box average
    const int ry = h / oh, rx = w / ow;
    const float inv = 1.0f / (255.0f * ry * rx);
    for (int y = 0; y < oh; ++y) {
      for (int x = 0; x < ow; ++x) {
        float acc[3] = {0, 0, 0};
        for (int dy = 0; dy < ry; ++dy) {
          const uint8_t* row =
              img.rgb.data() + ((size_t)(y * ry + dy) * w + x * rx) * 3;
          for (int dx = 0; dx < rx; ++dx) {
            acc[0] += row[dx * 3 + 0];
            acc[1] += row[dx * 3 + 1];
            acc[2] += row[dx * 3 + 2];
          }
        }
        float* o = dst + ((size_t)y * ow + x) * 3;
        o[0] = acc[0] * inv;
        o[1] = acc[1] * inv;
        o[2] = acc[2] * inv;
      }
    }
    return;
  }
  // fallback: bilinear (half-pixel centers)
  for (int y = 0; y < oh; ++y) {
    float fy = ((y + 0.5f) * h) / oh - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = ((x + 0.5f) * w) / ow - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = img.rgb[((size_t)y0 * w + x0) * 3 + c];
        float v01 = img.rgb[((size_t)y0 * w + x1) * 3 + c];
        float v10 = img.rgb[((size_t)y1 * w + x0) * 3 + c];
        float v11 = img.rgb[((size_t)y1 * w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[((size_t)y * ow + x) * 3 + c] = v / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n images into out[n, out_h, out_w, 3] float32. Returns the
// number of failures (0 == all good); failed slots are zero-filled.
int nefes_load_images(const char** paths, int n, int out_h, int out_w,
                      float* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int> next(0), failures(0);
  const size_t stride = (size_t)out_h * out_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      Decoded d = has_suffix(paths[i], ".jpg") || has_suffix(paths[i], ".jpeg")
                      ? decode_jpeg(paths[i])
                      : decode_png(paths[i]);
      float* dst = out + stride * i;
      if (!d.ok) {
        std::memset(dst, 0, stride * sizeof(float));
        failures.fetch_add(1);
        continue;
      }
      resample(d, out_h, out_w, dst);
    }
  };

  std::vector<std::thread> pool;
  int k = n_threads < n ? n_threads : n;
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
