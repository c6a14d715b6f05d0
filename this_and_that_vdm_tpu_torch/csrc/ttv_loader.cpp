// ttv_loader: the port's native frame loader and the C entry points of the
// host codecs (bound with ctypes by data/native_loader.py and
// utils/host_native.py).
//
// A batch of frames is decoded (PNG or JPEG by signature: the codecs of
// this directory), bicubic-resized on uint8, optionally flipped and written
// as float32 in [-1, 1] or uint8 by a pool of threads in one call: ctypes
// releases the GIL, so the data loader's threads run side by side.
//
// The resize is data/image.resize_bicubic bit for bit: float64 taps
// (half-pixel centres, Keys' cubic with a = -0.75, clamped edge indices),
// the column pass then the row pass, the four taps summed k = 0..3 in that
// order, rounded half to even and clipped as numpy rounds and clips.  It
// must be compiled with -ffp-contract=off (no fused multiply-add).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>

#include "host_codec.h"

namespace ttv {
namespace {

// A PNG or JPEG file by its signature, as utils/video_io.read_image tells
// them apart.
Rgb read_image_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) throw CodecError(std::string("cannot open: ") + std::strerror(errno));
  std::vector<uint8_t> data;
  uint8_t buf[65536];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) data.insert(data.end(), buf, buf + got);
  std::fclose(f);
  static const uint8_t png[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (data.size() >= 8 && std::memcmp(data.data(), png, 8) == 0)
    return png_decode(data.data(), data.size());
  if (data.size() >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return jpeg_decode(data.data(), data.size());
  throw CodecError("neither PNG nor JPEG");
}

struct Taps {
  std::vector<int> idx;     // [n_out * 4]
  std::vector<double> wt;   // [n_out * 4]
};

// data/image._cubic_taps, expression for expression.
Taps cubic_taps(int n_in, int n_out) {
  Taps t;
  t.idx.resize(static_cast<size_t>(n_out) * 4);
  t.wt.resize(static_cast<size_t>(n_out) * 4);
  const double scale = static_cast<double>(n_in) / static_cast<double>(n_out);
  const double a = -0.75;
  for (int d = 0; d < n_out; ++d) {
    double fx = (static_cast<double>(d) + 0.5) * scale - 0.5;
    double sx = std::floor(fx);
    double x = fx - sx;
    double x1 = x + 1, y = 1 - x;
    double c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a;
    double c1 = ((a + 2) * x - (a + 3)) * x * x + 1;
    double c2 = ((a + 2) * y - (a + 3)) * y * y + 1;
    double c3 = 1 - c0 - c1 - c2;
    const double w[4] = {c0, c1, c2, c3};
    long base = static_cast<long>(sx);
    for (int k = 0; k < 4; ++k) {
      t.idx[d * 4 + k] = static_cast<int>(std::clamp<long>(base - 1 + k, 0, n_in - 1));
      t.wt[d * 4 + k] = w[k];
    }
  }
  return t;
}

// [ih, iw, 3] uint8 -> [oh, ow, 3] uint8, flipped left-right when asked.
void resize_bicubic_u8(const Rgb& in, int oh, int ow, bool flip, uint8_t* out) {
  const Taps ct = cubic_taps(in.w, ow), rt = cubic_taps(in.h, oh);
  std::vector<double> tmp(static_cast<size_t>(in.h) * ow * 3);
  for (int y = 0; y < in.h; ++y) {
    const uint8_t* src = in.px.data() + static_cast<size_t>(y) * in.w * 3;
    double* dst = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x)
      for (int c = 0; c < 3; ++c) {
        double s = static_cast<double>(src[ct.idx[x * 4] * 3 + c]) * ct.wt[x * 4];
        for (int k = 1; k < 4; ++k)
          s = s + static_cast<double>(src[ct.idx[x * 4 + k] * 3 + c]) * ct.wt[x * 4 + k];
        dst[x * 3 + c] = s;
      }
  }
  const size_t row = static_cast<size_t>(ow) * 3;
  for (int y = 0; y < oh; ++y) {
    const double* r[4];
    for (int k = 0; k < 4; ++k) r[k] = tmp.data() + rt.idx[y * 4 + k] * row;
    const double* w = &rt.wt[y * 4];
    uint8_t* o = out + static_cast<size_t>(y) * row;
    for (int x = 0; x < ow; ++x) {
      const int ox = flip ? ow - 1 - x : x;
      for (int c = 0; c < 3; ++c) {
        const size_t i = static_cast<size_t>(x) * 3 + c;
        double s = r[0][i] * w[0];
        s = s + r[1][i] * w[1];
        s = s + r[2][i] * w[2];
        s = s + r[3][i] * w[3];
        double v = std::nearbyint(s);  // round half to even, as np.round
        o[ox * 3 + c] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
  }
}

void run_pool(int n, int num_threads, const std::function<void(int)>& work) {
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) work(i);
  };
  const int t = std::max(1, std::min(num_threads, n));
  if (t == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// Decode, resize and flip each frame into `store(i, u8 frame)`; returns 0
// or 1 + the first index that failed, its message in err.
int load(const char** paths, int n, int h, int w, int flip, int num_threads, char* err,
         int errlen, const std::function<void(int, const uint8_t*)>& store) {
  std::atomic<int> first_bad{n};
  std::vector<std::string> msgs(n);
  const size_t frame = static_cast<size_t>(h) * w * 3;
  run_pool(n, num_threads, [&](int i) {
    std::vector<uint8_t> u8(frame);
    try {
      resize_bicubic_u8(read_image_file(paths[i]), h, w, flip != 0, u8.data());
    } catch (const std::exception& e) {
      msgs[i] = e.what();
      int cur = first_bad.load();
      while (i < cur && !first_bad.compare_exchange_weak(cur, i)) {
      }
      std::fill(u8.begin(), u8.end(), 0);
    }
    store(i, u8.data());
  });
  const int bad = first_bad.load();
  if (bad == n) return 0;
  set_error(err, errlen, std::string(paths[bad]) + ": " + msgs[bad]);
  return 1 + bad;
}

}  // namespace
}  // namespace ttv

extern "C" {

// [n, h, w, 3] float32 in [-1, 1] (u8 / 127.5f - 1.0f) of the files at
// `paths`: decoded, resized bicubic on uint8, flipped left-right when
// `flip`.  0, or 1 + the index of the first file that failed.
int ttv_load_frames(const char** paths, int n, int h, int w, int flip, int num_threads,
                    float* out, char* err, int errlen) {
  const size_t frame = static_cast<size_t>(h) * w * 3;
  return ttv::load(paths, n, h, w, flip, num_threads, err, errlen,
                   [&](int i, const uint8_t* u8) {
                     float* o = out + static_cast<size_t>(i) * frame;
                     for (size_t k = 0; k < frame; ++k)
                       o[k] = static_cast<float>(u8[k]) / 127.5f - 1.0f;
                   });
}

// The same frames as uint8 RGB.
int ttv_load_frames_u8(const char** paths, int n, int h, int w, int flip, int num_threads,
                       uint8_t* out, char* err, int errlen) {
  const size_t frame = static_cast<size_t>(h) * w * 3;
  return ttv::load(paths, n, h, w, flip, num_threads, err, errlen,
                   [&](int i, const uint8_t* u8) {
                     std::memcpy(out + static_cast<size_t>(i) * frame, u8, frame);
                   });
}

// JPEG bytes -> RGB in a buffer the caller frees with ttv_free.  0 or -1.
int ttv_jpeg_decode(const uint8_t* data, long n, uint8_t** out, int* h, int* w, char* err,
                    int errlen) {
  try {
    ttv::Rgb img = ttv::jpeg_decode(data, static_cast<size_t>(n));
    *out = static_cast<uint8_t*>(std::malloc(img.px.size()));
    if (!*out) throw ttv::CodecError("out of memory");
    std::memcpy(*out, img.px.data(), img.px.size());
    *h = img.h;
    *w = img.w;
    return 0;
  } catch (const std::exception& e) {
    ttv::set_error(err, errlen, e.what());
    return -1;
  }
}

// [h, w, c] uint8 (RGB or grey) -> JPEG bytes in a buffer the caller frees
// with ttv_free; returns the byte count, or -1.  ``scan_per_component``:
// the encoder's test mode (three non-interleaved scans).
long ttv_jpeg_encode(const uint8_t* px, int h, int w, int c, int scan_per_component,
                     uint8_t** out, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes = ttv::jpeg_encode(px, h, w, c, scan_per_component != 0);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) throw ttv::CodecError("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    return static_cast<long>(bytes.size());
  } catch (const std::exception& e) {
    ttv::set_error(err, errlen, e.what());
    return -1;
  }
}

void ttv_free(void* p) { std::free(p); }

}  // extern "C"
