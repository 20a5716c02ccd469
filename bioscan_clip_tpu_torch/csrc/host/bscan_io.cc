// bscan_io: the host's JPEG decode pool for the PyTorch port's loader.
//
// A copy of native/bscan_io.cc, built with g++ by
// bioscan_clip_tpu_torch/data/native_io.py into build/host/ and loaded with
// ctypes. A pthread pool decodes a batch of JPEG byte buffers (the HDF5
// `image`/`image_mask` rows) straight into a caller-provided contiguous
// uint8 array: libjpeg's DCT scaling (scale_num/scale_denom) to near the
// target shorter side, a bilinear finish, then a center crop or edge pad
// into the fixed slot, with no Python and no per-image allocation on the
// way.
//
// Exposed C ABI (ctypes):
//   int bscan_decode_batch(const uint8_t** bufs, const int64_t* lens,
//                          int n, int target_short, uint8_t* out,
//                          int out_h, int out_w, int threads);
// Every decoded image is resized (aspect-preserving shorter-side ==
// target_short via libjpeg DCT scaling + bilinear) then center-cropped or
// edge-padded into the fixed (out_h, out_w, 3) slot of the batch. Returns 0
// on success, else the index of the first failed image + 1.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG with libjpeg DCT scaling to get close to target_short on
// the shorter side, returning an RGB buffer + dims. Returns false on error.
bool decode_one(const uint8_t* buf, int64_t len, int target_short,
                std::vector<uint8_t>* pixels, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (target_short > 0) {
    // pick the smallest DCT scale (M/8, M=1..8) whose shorter side is still
    // >= target_short, so the bilinear finish only ever downsamples a
    // little (quality) instead of upsampling (blur).
    int short_side = cinfo.image_height < cinfo.image_width
                         ? cinfo.image_height
                         : cinfo.image_width;
    int m = 8;
    while (m > 1 && (short_side * (m - 1)) / 8 >= target_short) m--;
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  const int stride = w * cinfo.output_components;
  pixels->resize(static_cast<size_t>(h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return true;
}

// Bilinear resize RGB u8 (h, w) -> (nh, nw).
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int nh,
                     int nw) {
  const float sy = static_cast<float>(h) / nh;
  const float sx = static_cast<float>(w) / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * w + x0) * 3 + c];
        float v01 = src[(y0 * w + x1) * 3 + c];
        float v10 = src[(y1 * w + x0) * 3 + c];
        float v11 = src[(y1 * w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * nw + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Place (h, w) into the fixed (out_h, out_w) slot: center crop if larger,
// edge-pad if smaller.
void place_center(const uint8_t* src, int h, int w, uint8_t* dst, int out_h,
                  int out_w) {
  for (int y = 0; y < out_h; ++y) {
    int sy_ = y - (out_h - h) / 2;
    if (sy_ < 0) sy_ = 0;
    if (sy_ > h - 1) sy_ = h - 1;
    for (int x = 0; x < out_w; ++x) {
      int sx_ = x - (out_w - w) / 2;
      if (sx_ < 0) sx_ = 0;
      if (sx_ > w - 1) sx_ = w - 1;
      std::memcpy(dst + (static_cast<size_t>(y) * out_w + x) * 3,
                  src + (static_cast<size_t>(sy_) * w + sx_) * 3, 3);
    }
  }
}

}  // namespace

extern "C" int bscan_decode_batch(const uint8_t** bufs, const int64_t* lens,
                                  int n, int target_short, uint8_t* out,
                                  int out_h, int out_w, int threads) {
  if (threads <= 0) threads = std::thread::hardware_concurrency();
  std::atomic<int> next(0);
  std::atomic<int> failure(0);  // 0 = ok, else first failed index + 1

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    std::vector<uint8_t> resized;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failure.load() != 0) break;
      int h = 0, w = 0;
      if (!decode_one(bufs[i], lens[i], target_short, &pixels, &h, &w)) {
        int expected = 0;
        failure.compare_exchange_strong(expected, i + 1);
        break;
      }
      const uint8_t* img = pixels.data();
      int ih = h, iw = w;
      if (target_short > 0 &&
          (h < w ? h : w) != target_short) {
        int nh, nw;
        if (h <= w) {
          nh = target_short;
          nw = static_cast<int>(
              static_cast<float>(target_short) * w / h + 0.5f);
        } else {
          nw = target_short;
          nh = static_cast<int>(
              static_cast<float>(target_short) * h / w + 0.5f);
        }
        resized.resize(static_cast<size_t>(nh) * nw * 3);
        resize_bilinear(pixels.data(), h, w, resized.data(), nh, nw);
        img = resized.data();
        ih = nh;
        iw = nw;
      }
      place_center(img, ih, iw,
                   out + static_cast<size_t>(i) * out_h * out_w * 3, out_h,
                   out_w);
    }
  };

  int nt = threads < n ? threads : n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failure.load();
}
