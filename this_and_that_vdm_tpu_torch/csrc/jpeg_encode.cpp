// JPEG encoder: the bytes cv2.imwrite(path, bgr) writes for a .jpg at its
// defaults, the only settings the JAX package uses, from the algorithms
// libjpeg-turbo runs there:
//
// - SOI, a JFIF 1.01 APP0 (no density unit, 1:1), one DQT a table, SOF0,
//   one DHT a table (DC then AC, luminance then chrominance), SOS, EOI;
// - quality 95: the ITU-T T.81 Annex K tables scaled as jpeg_quality_scaling
//   scales them, clamped to 1..255 (baseline);
// - RGB -> YCbCr through jccolor.c's SCALEBITS-16 tables; Y at 2x2, Cb and
//   Cr at 1x1 (4:2:0) through h2v2_downsample with its alternating 1, 2
//   bias; edges replicated as jcprepct.c / jcsample.c pad them, and the
//   dummy blocks of a partial MCU made as jccoefct.c makes them (zero AC,
//   the DC of the block before);
// - the islow forward DCT (jfdctint.c) and libjpeg-turbo's reciprocal
//   quantisation (jcdctmgr.c compute_reciprocal / quantize);
// - the standard Huffman tables (no optimisation, no restart markers), the
//   last byte filled with one bits.
//
// A grey [h, w] image is written as one component at 1x1, as cv2 writes a
// 2-D array.  ``scan_per_component`` (a test mode: no writer the repo runs
// makes such files) writes an RGB image's three components in three
// non-interleaved scans, each over the component's own block grid.

#include <cstring>

#include "host_codec.h"
#include "jpeg_common.h"

namespace ttv {
namespace {

using namespace jpeg;  // NOLINT

// T.81 Annex K.1, natural order.
const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// T.81 Annex K.3: code counts of lengths 1..16, then the values.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kQuality = 95;

struct HuffCodes {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: quantising x by
// divisor is ((|x| + corr) * recip) >> shift, sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t divisor) {
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= divisor / 2u) {
      ++c;
    } else {
      ++fq;
    }
    recip = fq;
    corr = c;
    shift = r;
  }
  int16_t apply(int x) const {
    uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
    int q = static_cast<int>(((a + corr) * recip) >> shift);
    return static_cast<int16_t>(x < 0 ? -q : q);
  }
};

struct QuantTable {
  uint8_t q[64];  // natural order
  std::vector<Divisor> div;
  explicit QuantTable(const uint8_t* base) {
    const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
    for (int i = 0; i < 64; ++i) {
      long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
      q[i] = static_cast<uint8_t>(t < 1 ? 1 : t > 255 ? 255 : t);
      div.emplace_back(static_cast<uint32_t>(q[i]) << 3);  // islow output is scaled by 8
    }
  }
};

// jpeg_fdct_islow on 8 x 8 level-shifted samples, in place, rows then
// columns; results scaled up by 8.
void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
      }
      const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, n));
      p[6 * step] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, n));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560 + z5;
      z4 = z4 * -FIX_0_390180644 + z5;
      p[7 * step] = static_cast<int>(descale(tmp4 + z1 + z3, n));
      p[5 * step] = static_cast<int>(descale(tmp5 + z2 + z4, n));
      p[3 * step] = static_cast<int>(descale(tmp6 + z2 + z3, n));
      p[step] = static_cast<int>(descale(tmp7 + z1 + z4, n));
    }
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    cnt_ += size;
    while (cnt_ >= 8) {
      uint8_t b = static_cast<uint8_t>(acc_ >> (cnt_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      cnt_ -= 8;
    }
  }
  void flush() { put(0x7F, 7); }  // the partial byte filled with ones
 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* c, int& last_dc, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int diff = c[0] - last_dc, bitsv = diff;
  last_dc = c[0];
  if (diff < 0) {
    diff = -diff;
    --bitsv;
  }
  int n = nbits(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(bitsv), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = c[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int b = v;
    if (v < 0) {
      v = -v;
      --b;
    }
    n = nbits(v);
    int sym = (run << 4) + n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(b), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

// A padded component plane: `w` x `h` samples, rows of `w`.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> s;
  uint8_t at(int x, int y) const { return s[static_cast<size_t>(y) * w + x]; }
};

// One component's block row-major quantised coefficients, from its padded
// plane (blocks that lie on real samples; the caller makes dummies).
void forward_block(const Plane& p, int bx, int by, const QuantTable& qt, int16_t* out) {
  int d[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = p.at(bx * 8 + x, by * 8 + y) - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) out[i] = qt.div[i].apply(d[i]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dqt(std::vector<uint8_t>& o, int id, const QuantTable& t) {
  o.insert(o.end(), {0xFF, 0xDB, 0x00, 0x43, static_cast<uint8_t>(id)});
  for (int k = 0; k < 64; ++k) o.push_back(t.q[kNatural[k]]);
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

}  // namespace

std::vector<uint8_t> jpeg_encode(const uint8_t* px, int h, int w, int c, bool scan_per_component) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) throw CodecError("JPEG size out of range");
  if (c != 1 && c != 3) throw CodecError("JPEG encoder takes RGB or grey images");
  const bool color = c == 3;
  static const QuantTable luma(kLumaQuant), chroma(kChromaQuant);
  static const HuffCodes dc0(kDcLumaBits, kDcVals), ac0(kAcLumaBits, kAcLumaVals),
      dc1(kDcChromaBits, kDcVals), ac1(kAcChromaBits, kAcChromaVals);

  // Component planes, padded as libjpeg pads them.
  const int mcu = color ? 16 : 8;
  const int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;
  std::vector<Plane> planes(c);
  if (!color) {
    Plane& p = planes[0];
    p.w = mcux * 8;
    p.h = mcuy * 8;
    p.s.resize(static_cast<size_t>(p.w) * p.h);
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x)
        p.s[static_cast<size_t>(y) * p.w + x] = px[static_cast<size_t>(std::min(y, h - 1)) * w +
                                                   std::min(x, w - 1)];
  } else {
    // jccolor.c rgb_ycc_convert tables
    static const struct Tab {
      int64_t t[8][256];
      Tab() {
        auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
        const int64_t half = int64_t(1) << 15, cbcr = int64_t(128) << 16;
        for (int i = 0; i < 256; ++i) {
          t[0][i] = fix(0.29900) * i;
          t[1][i] = fix(0.58700) * i;
          t[2][i] = fix(0.11400) * i + half;
          t[3][i] = -fix(0.16874) * i;
          t[4][i] = -fix(0.33126) * i;
          t[5][i] = fix(0.50000) * i + cbcr + half - 1;  // B -> Cb and R -> Cr
          t[6][i] = -fix(0.41869) * i;
          t[7][i] = -fix(0.08131) * i;
        }
      }
    } tab;
    // full-resolution Y, Cb, Cr with the right edge replicated to the MCU
    // width and the rows to an even count (the row group)
    const int fw = mcux * 16, fh = h + (h & 1);
    std::vector<uint8_t> full[3];
    for (auto& f : full) f.resize(static_cast<size_t>(fw) * fh);
    for (int y = 0; y < fh; ++y) {
      const uint8_t* row = px + static_cast<size_t>(std::min(y, h - 1)) * w * 3;
      for (int x = 0; x < fw; ++x) {
        const uint8_t* q = row + static_cast<size_t>(std::min(x, w - 1)) * 3;
        int r = q[0], g = q[1], b = q[2];
        size_t i = static_cast<size_t>(y) * fw + x;
        full[0][i] = static_cast<uint8_t>((tab.t[0][r] + tab.t[1][g] + tab.t[2][b]) >> 16);
        full[1][i] = static_cast<uint8_t>((tab.t[3][r] + tab.t[4][g] + tab.t[5][b]) >> 16);
        full[2][i] = static_cast<uint8_t>((tab.t[5][r] + tab.t[6][g] + tab.t[7][b]) >> 16);
      }
    }
    Plane& yp = planes[0];
    yp.w = fw;
    yp.h = mcuy * 16;
    yp.s.resize(static_cast<size_t>(yp.w) * yp.h);
    for (int y = 0; y < yp.h; ++y)
      std::memcpy(&yp.s[static_cast<size_t>(y) * fw], &full[0][static_cast<size_t>(std::min(y, h - 1)) * fw], fw);
    // h2v2_downsample of the row groups, then the last row replicated
    const int cw = mcux * 8, ch = mcuy * 8, real = fh / 2;
    for (int k = 1; k < 3; ++k) {
      Plane& p = planes[k];
      p.w = cw;
      p.h = ch;
      p.s.resize(static_cast<size_t>(cw) * ch);
      for (int y = 0; y < ch; ++y) {
        uint8_t* o = &p.s[static_cast<size_t>(y) * cw];
        if (y >= real) {
          std::memcpy(o, &p.s[static_cast<size_t>(real - 1) * cw], cw);
          continue;
        }
        const uint8_t* i0 = &full[k][static_cast<size_t>(2 * y) * fw];
        const uint8_t* i1 = i0 + fw;
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          o[x] = static_cast<uint8_t>((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), jfif, jfif + sizeof(jfif));
  put_dqt(o, 0, luma);
  if (color) put_dqt(o, 1, chroma);
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * c);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(c));
  for (int k = 0; k < c; ++k) {
    o.push_back(static_cast<uint8_t>(k + 1));
    o.push_back(color && k == 0 ? 0x22 : 0x11);
    o.push_back(k == 0 ? 0 : 1);
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (color) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  auto put_sos = [&o](int first, int count) {
    o.push_back(0xFF);
    o.push_back(0xDA);
    put16(o, 6 + 2 * count);
    o.push_back(static_cast<uint8_t>(count));
    for (int k = first; k < first + count; ++k) {
      o.push_back(static_cast<uint8_t>(k + 1));
      o.push_back(k == 0 ? 0x00 : 0x11);
    }
    o.insert(o.end(), {0x00, 0x3F, 0x00});
  };
  int16_t blk[64];
  if (color && scan_per_component) {
    // each scan covers the component's blocks of real samples, row by row
    const int dims[3][2] = {{(w + 7) / 8, (h + 7) / 8},
                            {((w + 1) / 2 + 7) / 8, ((h + 1) / 2 + 7) / 8},
                            {((w + 1) / 2 + 7) / 8, ((h + 1) / 2 + 7) / 8}};
    for (int k = 0; k < 3; ++k) {
      put_sos(k, 1);
      BitWriter bw(o);
      int last_dc = 0;
      for (int by = 0; by < dims[k][1]; ++by)
        for (int bx = 0; bx < dims[k][0]; ++bx) {
          forward_block(planes[k], bx, by, k ? chroma : luma, blk);
          encode_block(bw, blk, last_dc, k ? dc1 : dc0, k ? ac1 : ac0);
        }
      bw.flush();
    }
    o.push_back(0xFF);
    o.push_back(0xD9);
    return o;
  }
  put_sos(0, c);

  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  if (!color) {
    for (int by = 0; by < mcuy; ++by)
      for (int bx = 0; bx < mcux; ++bx) {
        forward_block(planes[0], bx, by, luma, blk);
        encode_block(bw, blk, last_dc[0], dc0, ac0);
      }
  } else {
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y's real blocks
    int16_t ys[4][64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        for (int j = 0; j < 2; ++j)
          for (int i = 0; i < 2; ++i) {
            int16_t* b = ys[2 * j + i];
            int bx = 2 * mx + i, by = 2 * my + j;
            if (by >= ybh) {  // a dummy row: the DC of the MCU's block before it
              std::memset(b, 0, sizeof(ys[0]));
              b[0] = ys[1][0];
            } else if (bx >= ybw) {  // a dummy column: the DC of the block to its left
              std::memset(b, 0, sizeof(ys[0]));
              b[0] = ys[2 * j][0];
            } else {
              forward_block(planes[0], bx, by, luma, b);
            }
          }
        for (auto& b : ys) encode_block(bw, b, last_dc[0], dc0, ac0);
        for (int k = 1; k < 3; ++k) {
          forward_block(planes[k], mx, my, chroma, blk);
          encode_block(bw, blk, last_dc[k], dc1, ac1);
        }
      }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace ttv
