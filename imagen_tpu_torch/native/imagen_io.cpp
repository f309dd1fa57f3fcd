// imagen_io: host-side image decoding for the training data pipeline
// (JPEG decode + resize + crop + normalize); the port's copy of
// imagen_tpu/native/imagen_io.cpp.
//
// One C pass per image:
//   JPEG bytes -> libjpeg DCT-scaled decode -> bilinear shortest-side resize
//   -> center crop -> optional horizontal flip -> float32 [0,1] HWC
// with a std::thread pool for batch decode. Exposed through ctypes (no pybind11).
//
// Build (imagen_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC imagen_io.cpp -o libimagen_io.so -ljpeg -lpthread
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG with DCT scaling to the smallest size >= target on the short side.
// Returns decoded RGB8 buffer + dims, or false on failure.
bool decode_jpeg(const uint8_t* data, size_t len, int target,
                 std::vector<uint8_t>* out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  cinfo.out_color_space = JCS_RGB;

  // DCT scale: pick denom in {1,2,4,8} keeping short side >= target
  int short_side = std::min(cinfo.image_width, cinfo.image_height);
  int denom = 1;
  while (denom < 8 && short_side / (denom * 2) >= target) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = cinfo.output_width * cinfo.output_components;
  out->resize(static_cast<size_t>(stride) * cinfo.output_height);

  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return cinfo.output_components == 3;
}

// Bilinear resize RGB8 (h, w) -> (oh, ow) into float32 [0,1].
void resize_bilinear_to_f32(const uint8_t* src, int w, int h, float* dst,
                            int ow, int oh) {
  const float sx = static_cast<float>(w) / ow;
  const float sy = static_cast<float>(h) / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, static_cast<int>(std::floor(fy)));
    int y1 = std::min(h - 1, y0 + 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, static_cast<int>(std::floor(fx)));
      int x1 = std::min(w - 1, x0 + 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * w + x0) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0) * w + x1) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1) * w + x0) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1) * w + x1) * 3 + c];
        float v0 = v00 + (v01 - v00) * wx;
        float v1 = v10 + (v11 - v10) * wx;
        dst[(static_cast<size_t>(y) * ow + x) * 3 + c] =
            (v0 + (v1 - v0) * wy) * (1.0f / 255.0f);
      }
    }
  }
}

// Full pipeline for one image into out (size*size*3 float32).
bool process_one(const uint8_t* data, size_t len, int size, int hflip,
                 float* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(data, len, size, &rgb, &w, &h)) return false;

  // resize shortest side to `size`, then center crop size x size
  int rw, rh;
  if (w < h) {
    rw = size;
    rh = std::max(size, static_cast<int>(std::lround(
        static_cast<double>(h) * size / w)));
  } else {
    rh = size;
    rw = std::max(size, static_cast<int>(std::lround(
        static_cast<double>(w) * size / h)));
  }

  std::vector<float> resized(static_cast<size_t>(rw) * rh * 3);
  resize_bilinear_to_f32(rgb.data(), w, h, resized.data(), rw, rh);

  const int left = (rw - size) / 2;
  const int top = (rh - size) / 2;
  for (int y = 0; y < size; ++y) {
    const float* src_row = resized.data() + (static_cast<size_t>(top + y) * rw + left) * 3;
    float* dst_row = out + static_cast<size_t>(y) * size * 3;
    if (!hflip) {
      std::memcpy(dst_row, src_row, static_cast<size_t>(size) * 3 * sizeof(float));
    } else {
      for (int x = 0; x < size; ++x) {
        const float* s = src_row + static_cast<size_t>(size - 1 - x) * 3;
        float* d = dst_row + static_cast<size_t>(x) * 3;
        d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode one JPEG into out (size*size*3 f32, HWC, [0,1]). Returns 1 on success.
int imagen_io_decode_one(const uint8_t* data, int64_t len, int size, int hflip,
                         float* out) {
  return process_one(data, static_cast<size_t>(len), size, hflip, out) ? 1 : 0;
}

// Batch decode with a thread pool. datas/lens describe n JPEG buffers; out is
// (n, size, size, 3) f32; ok is n int32 success flags. Returns count of successes.
int imagen_io_decode_batch(const uint8_t** datas, const int64_t* lens, int n,
                           int size, const int32_t* hflips, int num_threads,
                           float* out, int32_t* ok) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> successes(0);
  const size_t stride = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int good = process_one(datas[i], static_cast<size_t>(lens[i]), size,
                             hflips ? hflips[i] : 0, out + stride * i)
                     ? 1 : 0;
      ok[i] = good;
      if (good) successes.fetch_add(1);
    }
  };

  if (num_threads == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    int t = std::min(num_threads, n);
    pool.reserve(t);
    for (int i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return successes.load();
}

}  // extern "C"
