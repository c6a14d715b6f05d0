// JPEG decoder: the pixels cv2.imread(path, IMREAD_COLOR) returns (in RGB
// order), computed from the algorithms libjpeg-turbo runs at its defaults:
//
// - baseline, extended-sequential and progressive Huffman frames (SOF0,
//   SOF1, SOF2), 8-bit samples, 1 or 3 components, interleaved or one
//   component a scan; progressive scans as jdphuff.c decodes them (spectral
//   selection, successive approximation, DC and AC first and refinement
//   scans, EOB runs), every scan's coefficients kept until the end; DQT /
//   DHT anywhere before a scan, restart intervals (DRI, RSTn), APPn and COM
//   skipped, the Adobe APP14 transform flag, any image size;
// - the islow integer IDCT (CONST_BITS 13, PASS1_BITS 2) with its
//   range-limit table (values wrap modulo 1024 before the clamp);
// - fancy upsampling: the triangular filter of h2v1 / h1v2 / h2v2 with
//   libjpeg's alternating 1/2 biases, box replication where the
//   downsampled width is <= 2 (as jinit_upsampler chooses) and for other
//   integral factors; context rows clamped at the image's first and last
//   real rows;
// - YCbCr -> RGB through the SCALEBITS-16 fixed-point tables; grey
//   replicated; an Adobe transform-0 or 'R','G','B' stream copied;
// - the EXIF orientation applied as cv2.imread applies it.
//
// Refused with a CodecError naming the marker: lossless, arithmetic-coded,
// hierarchical and 12-bit streams, and a progressive stream whose scans
// leave one of the first ten coefficients of a component inexact (there
// libjpeg smooths the blocks; every complete progressive file, as cv2 and
// libjpeg write them, refines each coefficient to its last bit).  A truncated stream
// (entropy data that ends early, or no EOI) raises: cv2.imread returns None
// for it, where libjpeg alone would fill the rest with grey after a warning.

#include <algorithm>
#include <cstring>

#include "host_codec.h"
#include "jpeg_common.h"

namespace ttv {
namespace {

using namespace jpeg;  // NOLINT

[[noreturn]] void fail(const std::string& what) { throw CodecError(what); }

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoff[17] = {};
  uint16_t look[512] = {};  // 9-bit lookahead: (length << 8) | value, 0 = longer

  void build(const uint8_t* bits, const uint8_t* values, int count) {
    std::memcpy(vals, values, count);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      // The codes of this length must fit in it, none of them all ones
      // (jpeg_make_d_derived_tbl's check), before any fills the lookahead.
      if (code + bits[len - 1] >= (1 << len)) fail("bad Huffman table");
      valoff[len] = k - code;
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// The entropy-coded bit stream of one scan.  At a marker or the end of the
// data it feeds zero bits, as libjpeg does, and notes when a zero bit fed
// that way is consumed: the data ran out.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int cnt = 0;        // bits held in acc (the low cnt bits)
  int padded = 0;     // of which the lowest `padded` are fed zeros
  bool at_marker = false;
  bool overrun = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p != 0xFF) {
          b = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q < end && *q == 0) {
            b = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
          }
        }
      }
      if (at_marker) padded += 8;
      acc = (acc << 8) | b;
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) fill();
    return static_cast<uint32_t>(acc >> (cnt - n)) & ((1u << n) - 1);
  }
  void skip(int n) {
    cnt -= n;
    if (cnt < padded) {
      overrun = true;
      padded = cnt;
    }
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& t) {
    uint32_t v = peek(16);
    uint16_t e = t.look[v >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      int32_t code = static_cast<int32_t>(v >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[t.valoff[len] + code];
      }
    }
    fail("corrupt Huffman data");
  }
  static int extend(uint32_t v, int s) {
    return s == 0 ? 0 : (v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                              : static_cast<int>(v));
  }
  // Drop the bits of the current segment (a restart point or the scan's end).
  void reset() {
    acc = 0;
    cnt = padded = 0;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // block grid (MCU-padded)
  int dw = 0, dh = 0;  // downsampled width / height (ceil of the image's)
  int td = 0, ta = 0;
  bool scanned = false;
  int coef_bits[64];  // progressive: the Al of the last scan of each coefficient, -1 unseen
  uint16_t quant[64] = {};
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // IDCT output, bw * 8 wide
};

// The islow IDCT's output clamp: idx = value & 1023 into a table that maps
// [-128, 127] to [0, 255], saturates 128..511 to 255 and -512..-129 to 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const RangeLimit kRange;

// jpeg_idct_islow: dequantise, columns then rows, into 8 rows of `out`.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16], z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065, tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065, tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// The component's plane at full resolution (w x h), by libjpeg's upsampler
// for its sampling ratio.
std::vector<uint8_t> upsample(const Component& c, int hr, int vr, int w, int h) {
  std::vector<uint8_t> out(static_cast<size_t>(w) * h);
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  auto row = [&](int y) { return c.plane.data() + static_cast<size_t>(std::clamp(y, 0, dh - 1)) * stride; };
  std::vector<int> sum(dw + 2);
  std::vector<uint8_t> line(2 * dw + 2);
  for (int y = 0; y < h; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * w;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, row(y), w);
    } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      for (int i = 0; i < dw; ++i) {
        int cur = in[i] * 3, prev = in[std::max(i - 1, 0)], next = in[std::min(i + 1, dw - 1)];
        line[2 * i] = static_cast<uint8_t>((cur + prev + 1) >> 2);
        line[2 * i + 1] = static_cast<uint8_t>((cur + next + 2) >> 2);
      }
      std::memcpy(o, line.data(), w);
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      int j = y >> 1, lower = y & 1;
      const uint8_t* in0 = row(j);
      const uint8_t* in1 = row(lower ? j + 1 : j - 1);
      int bias = lower ? 2 : 1;
      for (int x = 0; x < w; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      int j = y >> 1, lower = y & 1;
      const uint8_t* in0 = row(j);
      const uint8_t* in1 = row(lower ? j + 1 : j - 1);
      for (int i = 0; i < dw; ++i) sum[i + 1] = in0[i] * 3 + in1[i];
      sum[0] = sum[1];
      sum[dw + 1] = sum[dw];
      for (int i = 0; i < dw; ++i) {
        int cur = sum[i + 1] * 3;
        line[2 * i] = static_cast<uint8_t>((cur + sum[i] + 8) >> 4);
        line[2 * i + 1] = static_cast<uint8_t>((cur + sum[i + 2] + 7) >> 4);
      }
      std::memcpy(o, line.data(), w);
    } else {  // int_upsample / h2v1_upsample / h2v2_upsample: box replication
      const uint8_t* in = row(y / vr);
      for (int x = 0; x < w; ++x) o[x] = in[x / hr];
    }
  }
  return out;
}

// YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

// EXIF orientation tag (0x0112) of an APP1 "Exif\0\0" payload, 1 if absent.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 14 || std::memcmp(d, "Exif\0\0", 6) != 0) return 1;
  const uint8_t* t = d + 6;
  size_t tn = n - 6;
  bool le = t[0] == 'I' && t[1] == 'I';
  if (!le && !(t[0] == 'M' && t[1] == 'M')) return 1;
  auto u16 = [&](size_t o) -> uint32_t {
    return o + 2 > tn ? 0 : le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return o + 4 > tn ? 0 : le ? u16(o) | (u16(o + 2) << 16) : (u16(o) << 16) | u16(o + 2);
  };
  size_t ifd = u32(4);
  uint32_t entries = u16(ifd);
  for (uint32_t i = 0; i < entries; ++i) {
    size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
    if (e + 12 > tn) break;
    if (u16(e) == 0x0112) {
      uint32_t v = u16(e + 8);
      return v >= 1 && v <= 8 ? static_cast<int>(v) : 1;
    }
  }
  return 1;
}

// cv2's ExifTransform: flips and a transpose by orientation 2..8.
Rgb orient(Rgb img, int o) {
  if (o <= 1) return img;
  const bool transpose = o >= 5;
  const bool flip_x = o == 2 || o == 3 || o == 6 || o == 7;
  const bool flip_y = o == 3 || o == 4 || o == 7 || o == 8;
  Rgb out;
  out.h = transpose ? img.w : img.h;
  out.w = transpose ? img.h : img.w;
  out.px.resize(img.px.size());
  for (int y = 0; y < out.h; ++y)
    for (int x = 0; x < out.w; ++x) {
      int sy = flip_y ? out.h - 1 - y : y, sx = flip_x ? out.w - 1 - x : x;
      int iy = transpose ? sx : sy, ix = transpose ? sy : sx;
      std::memcpy(&out.px[(static_cast<size_t>(y) * out.w + x) * 3],
                  &img.px[(static_cast<size_t>(iy) * img.w + ix) * 3], 3);
    }
  return out;
}

const char* refused_frame(int m) {
  switch (m) {
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
    default: return nullptr;
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : p_(d), end_(d + n) {}

  Rgb run() {
    if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    p_ += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (const char* what = refused_frame(m))
        fail(std::string(what) + " JPEG is not supported (baseline, extended-sequential and "
             "progressive Huffman only)");
      if (m == 0xCC) fail("arithmetic-coding conditioning (DAC) is not supported");
      if (m == 0xDC) fail("DNL marker is not supported");
      const uint8_t* seg = segment();
      size_t len = be16(seg) - 2;
      const uint8_t* body = seg + 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          progressive_ = m == 0xC2;
          frame(body, len);
          break;
        case 0xC4: dht(body, len); break;
        case 0xDB: dqt(body, len); break;
        case 0xDD:
          if (len < 2) fail("bad DRI marker");
          restart_interval_ = be16(body);
          break;
        case 0xDA: scan(body, len); break;
        case 0xE0:
          if (len >= 14 && std::memcmp(body, "JFIF", 5) == 0) saw_jfif_ = true;
          break;
        case 0xE1:
          if (!saw_exif_ && len >= 6 && std::memcmp(body, "Exif\0\0", 6) == 0) {
            saw_exif_ = true;
            orientation_ = exif_orientation(body, len);
          }
          break;
        case 0xEE:
          if (len >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = body[11];
          }
          break;
        default: break;  // other APPn, COM, JPGn: skipped
      }
    }
    if (!frame_seen_) fail("no frame header (SOF) before EOI");
    for (const Component& c : comps_)
      if (!c.scanned) fail("truncated JPEG: a component was never scanned");
    if (progressive_) check_smoothing();
    return orient(output(), orientation_);
  }

  // Reached the end of the data: a file cut short.
  void end_of_data() { fail("truncated JPEG: the data ends before EOI"); }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool frame_seen_ = false, saw_jfif_ = false, saw_adobe_ = false, saw_exif_ = false;
  bool progressive_ = false;
  unsigned eobrun_ = 0;  // blocks left in the current end-of-band run
  int adobe_transform_ = -1, orientation_ = 1;
  unsigned restart_interval_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];

  // Past any bytes up to a 0xFF, past fill bytes, the marker code.
  int next_marker() {
    for (;;) {
      while (p_ < end_ && *p_ != 0xFF) ++p_;
      while (p_ < end_ && *p_ == 0xFF) ++p_;
      if (p_ >= end_) end_of_data();  // cv2.imread returns None without EOI too
      int m = *p_++;
      if (m != 0) return m;
    }
  }
  // The segment at p_ (its length field first); advances past it.
  const uint8_t* segment() {
    if (end_ - p_ < 2) end_of_data();
    size_t len = be16(p_);
    if (len < 2) fail("bad marker length");
    if (static_cast<size_t>(end_ - p_) < len) end_of_data();
    const uint8_t* s = p_;
    p_ += len;
    return s;
  }

  void frame(const uint8_t* b, size_t len) {
    if (frame_seen_) fail("more than one frame header");
    if (len < 6) fail("bad SOF marker");
    if (b[0] != 8) fail(std::to_string(b[0]) + "-bit JPEG is not supported (8-bit only)");
    height_ = be16(b + 1);
    width_ = be16(b + 3);
    int n = b[5];
    if (height_ == 0 || width_ == 0) fail("image of zero size (or a DNL height) is not supported");
    if (n != 1 && n != 3) fail(std::to_string(n) + "-component JPEG is not supported (1 or 3)");
    if (len < 6 + 3 * static_cast<size_t>(n)) fail("bad SOF marker");
    comps_.resize(n);
    for (int i = 0; i < n; ++i) {
      Component& c = comps_[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad sampling factors");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
      c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame_seen_ = true;
  }

  void dht(const uint8_t* b, size_t len) {
    size_t i = 0;
    while (i < len) {
      if (len - i < 17) fail("bad DHT marker");
      int cls = b[i] >> 4, id = b[i] & 15;
      if (cls > 1 || id > 3) fail("bad DHT table index");
      int count = 0;
      for (int k = 0; k < 16; ++k) count += b[i + 1 + k];
      if (count > 256 || len - i - 17 < static_cast<size_t>(count)) fail("bad DHT marker");
      (cls ? ac_ : dc_)[id].build(b + i + 1, b + i + 17, count);
      i += 17 + count;
    }
  }

  void dqt(const uint8_t* b, size_t len) {
    size_t i = 0;
    while (i < len) {
      int pq = b[i] >> 4, id = b[i] & 15;
      if (id > 3 || pq > 1) fail("bad DQT marker");
      size_t need = 1 + 64 * (pq + 1);
      if (len - i < need) fail("bad DQT marker");
      for (int k = 0; k < 64; ++k)
        qt_[id][kNatural[k]] = pq ? be16(b + i + 1 + 2 * k) : b[i + 1 + k];
      qt_defined_[id] = true;
      i += need;
    }
  }

  void scan(const uint8_t* b, size_t len) {
    if (!frame_seen_) fail("scan before the frame header");
    int ns = len ? b[0] : 0;
    if (ns < 1 || ns > 4 || len < 4 + 2 * static_cast<size_t>(ns)) fail("bad SOS marker");
    std::vector<Component*> in;
    for (int i = 0; i < ns; ++i) {
      int id = b[1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps_)
        if (k.id == id) c = &k;
      if (!c) fail("scan names an unknown component");
      c->td = b[2 + 2 * i] >> 4;
      c->ta = b[2 + 2 * i] & 15;
      in.push_back(c);
    }
    const uint8_t* t = b + 1 + 2 * ns;
    const int ss = t[0], se = t[1], ah = t[2] >> 4, al = t[2] & 15;
    if (!progressive_) {
      if (ss != 0 || se != 63 || t[2] != 0) fail("bad spectral selection for a sequential scan");
    } else {  // start_pass_phuff_decoder's checks
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13 || bad) fail("bad progressive scan parameters");
    }
    const bool dc_band = ss == 0, need_dc = !progressive_ || (dc_band && ah == 0),
               need_ac = !progressive_ || !dc_band;
    for (Component* c : in) {
      if (c->td > 3 || c->ta > 3 || (need_dc && !dc_[c->td].defined) ||
          (need_ac && !ac_[c->ta].defined))
        fail("scan uses an undefined Huffman table");
      if (!c->scanned) {  // the quantisation table is latched at its first scan
        if (!qt_defined_[c->tq]) fail("component uses an undefined quantisation table");
        std::memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
      }
      if (progressive_)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    int blocks = 0;
    for (Component* c : in) blocks += ns == 1 ? 1 : c->h * c->v;
    if (blocks > 10) fail("too many blocks in an MCU");

    BitReader bits(p_, end_);
    int mx_n, my_n;
    if (ns == 1) {
      mx_n = (in[0]->dw + 7) / 8;
      my_n = (in[0]->dh + 7) / 8;
    } else {
      mx_n = mcux_;
      my_n = mcuy_;
    }
    int pred[4] = {0, 0, 0, 0};
    eobrun_ = 0;
    unsigned to_go = restart_interval_;
    int next_rst = 0;
    const long total = static_cast<long>(mx_n) * my_n;
    for (long m = 0; m < total; ++m) {
      if (restart_interval_) {
        if (to_go == 0) {
          restart(bits, next_rst);
          next_rst = (next_rst + 1) & 7;
          std::fill(pred, pred + 4, 0);
          eobrun_ = 0;
          to_go = restart_interval_;
        }
        --to_go;
      }
      int mx = static_cast<int>(m % mx_n), my = static_cast<int>(m / mx_n);
      for (int ci = 0; ci < ns; ++ci) {
        Component* c = in[ci];
        int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
        for (int j = 0; j < bh; ++j)
          for (int i = 0; i < bw; ++i) {
            int bx = mx * bw + i, by = my * bh + j;
            int16_t* out = &c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64];
            if (!progressive_)
              block(bits, *c, pred[ci], out);
            else if (dc_band && ah == 0)
              dc_first(bits, *c, pred[ci], out, al);
            else if (dc_band)
              out[0] = static_cast<int16_t>(out[0] | (bits.get(1) << al));
            else if (ah == 0)
              ac_first(bits, *c, out, ss, se, al);
            else
              ac_refine(bits, *c, out, ss, se, al);
          }
      }
      if (bits.overrun) fail("truncated JPEG: the entropy-coded data ends early");
    }
    for (Component* c : in) c->scanned = true;
    p_ = bits.p;  // at the next marker, or where the data stopped
  }

  void block(BitReader& bits, const Component& c, int& pred, int16_t* out) {
    int s = bits.decode(dc_[c.td]);
    if (s > 11) fail("corrupt Huffman data");
    pred += BitReader::extend(bits.get(s), s);
    out[0] = static_cast<int16_t>(pred);
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = bits.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt Huffman data");
        out[kNatural[k]] = static_cast<int16_t>(BitReader::extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first.
  void dc_first(BitReader& bits, const Component& c, int& pred, int16_t* out, int al) {
    int s = bits.decode(dc_[c.td]);
    if (s > 16) fail("corrupt Huffman data");
    pred += BitReader::extend(bits.get(s), s);
    out[0] = static_cast<int16_t>(static_cast<unsigned>(pred) << al);
  }

  // jdphuff.c decode_mcu_AC_first: one band of a block, or one block of an
  // end-of-band run.
  void ac_first(BitReader& bits, const Component& c, int16_t* out, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& ac = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = bits.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt Huffman data");
        out[kNatural[k]] =
            static_cast<int16_t>(static_cast<unsigned>(BitReader::extend(bits.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += bits.get(r);
        --eobrun_;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine: a correction bit for every nonzero
  // coefficient of the band passed over, new coefficients of +-2^al.
  void ac_refine(BitReader& bits, const Component& c, int16_t* out, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t& v) {
      if (bits.get(1) && (v & p1) == 0) v = static_cast<int16_t>(v + (v >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
      const Huffman& ac = ac_[c.ta];
      for (; k <= se; ++k) {
        int rs = bits.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a new coefficient of size 1 (libjpeg warns on another size)
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += bits.get(r);
          break;  // the rest of the block is the end-of-band run's
        }
        do {
          int16_t& v = out[kNatural[k]];
          if (v != 0) {
            correct(v);
          } else if (--r < 0) {
            break;  // the zero coefficient that becomes nonzero
          }
          ++k;
        } while (k <= se);
        if (s) out[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t& v = out[kNatural[k]];
        if (v != 0) correct(v);
      }
      --eobrun_;
    }
  }

  // jdcoefct.c smoothing_ok: where a component's DC is known and one of its
  // first ten coefficients is inexact after the last scan, libjpeg smooths
  // the blocks (do_block_smoothing, on by default); that is not done here.
  void check_smoothing() const {
    for (const Component& c : comps_)
      if (c.coef_bits[0] < 0) return;
    for (const Component& c : comps_)
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          fail("progressive JPEG whose scans leave coefficients inexact (libjpeg's block "
               "smoothing) is not supported");
  }

  void restart(BitReader& bits, int expect) {
    bits.reset();
    const uint8_t* q = bits.p;
    while (q < end_ && *q != 0xFF) ++q;  // stray bytes before the marker
    while (q < end_ && *q == 0xFF) ++q;
    if (q >= end_) fail("truncated JPEG: the data ends at a restart point");
    if (*q != 0xD0 + expect) fail("corrupt JPEG: expected RST" + std::to_string(expect));
    bits.p = q + 1;
    bits.at_marker = false;
  }

  Rgb output() {
    const int w = width_, h = height_;
    std::vector<std::vector<uint8_t>> full;
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) fail("fractional sampling factors are not supported");
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      const int stride = c.bw * 8;
      const int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
      for (int by = 0; by < rows; ++by)
        for (int bx = 0; bx < cols; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      full.push_back(upsample(c, hmax_ / c.h, vmax_ / c.v, w, h));
      std::vector<int16_t>().swap(c.coef);
    }
    Rgb img;
    img.h = h;
    img.w = w;
    img.px.resize(static_cast<size_t>(w) * h * 3);
    const size_t n = static_cast<size_t>(w) * h;
    uint8_t* o = img.px.data();
    if (comps_.size() == 1) {
      for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
      return img;
    }
    bool ycc = true;  // default_decompress_parms: JFIF, then Adobe, then component ids
    if (!saw_jfif_) {
      if (saw_adobe_)
        ycc = adobe_transform_ != 0;
      else if (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66)
        ycc = false;
    }
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (!ycc) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = p0[i];
        o[3 * i + 1] = p1[i];
        o[3 * i + 2] = p2[i];
      }
      return img;
    }
    for (size_t i = 0; i < n; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      o[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      o[3 * i + 1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
    return img;
  }
};

}  // namespace

Rgb jpeg_decode(const uint8_t* data, size_t n) { return Decoder(data, n).run(); }

}  // namespace ttv
