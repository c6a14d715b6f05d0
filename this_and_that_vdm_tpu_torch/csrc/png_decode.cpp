// PNG decoder for the frame loader: what utils/video_io.read_png reads
// (8-bit grey, RGB or RGBA, every row filter, no interlace), with its own
// inflate (RFC 1950 / 1951: stored, fixed and dynamic Huffman blocks).

#include <cstdlib>
#include <cstring>

#include "host_codec.h"

namespace ttv {
namespace {

[[noreturn]] void fail(const std::string& what) { throw CodecError(what); }

class Inflater {
 public:
  Inflater(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  std::vector<uint8_t> run() {
    if (n_ < 2 || (d_[0] & 15) != 8 || ((d_[0] << 8) | d_[1]) % 31 != 0 || (d_[1] & 0x20))
      fail("PNG: bad zlib header");
    pos_ = 2;
    std::vector<uint8_t> out;
    for (bool last = false; !last;) {
      last = bits(1);
      int type = static_cast<int>(bits(2));
      if (type == 0) {
        bit_ = 0;
        nbits_ = 0;
        if (pos_ + 4 > n_) fail("PNG: truncated data");
        size_t len = d_[pos_] | (d_[pos_ + 1] << 8);
        pos_ += 4;
        if (pos_ + len > n_) fail("PNG: truncated data");
        out.insert(out.end(), d_ + pos_, d_ + pos_ + len);
        pos_ += len;
      } else if (type == 1) {
        uint8_t lens[288 + 32];
        std::memset(lens, 8, 144);
        std::memset(lens + 144, 9, 112);
        std::memset(lens + 256, 7, 24);
        std::memset(lens + 280, 8, 8);
        std::memset(lens + 288, 5, 32);
        Table lit(lens, 288), dist(lens + 288, 30);
        block(out, lit, dist);
      } else if (type == 2) {
        int hlit = static_cast<int>(bits(5)) + 257, hdist = static_cast<int>(bits(5)) + 1;
        int hclen = static_cast<int>(bits(4)) + 4;
        static const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        uint8_t cl[19] = {};
        for (int i = 0; i < hclen; ++i) cl[order[i]] = static_cast<uint8_t>(bits(3));
        Table clt(cl, 19);
        uint8_t lens[320] = {};
        for (int i = 0; i < hlit + hdist;) {
          int sym = decode(clt);
          if (sym < 16) {
            lens[i++] = static_cast<uint8_t>(sym);
            continue;
          }
          int rep, val = 0;
          if (sym == 16) {
            if (i == 0) fail("PNG: bad code lengths");
            val = lens[i - 1];
            rep = 3 + static_cast<int>(bits(2));
          } else if (sym == 17) {
            rep = 3 + static_cast<int>(bits(3));
          } else {
            rep = 11 + static_cast<int>(bits(7));
          }
          if (i + rep > hlit + hdist) fail("PNG: bad code lengths");
          while (rep--) lens[i++] = static_cast<uint8_t>(val);
        }
        Table lit(lens, hlit), dist(lens + hlit, hdist);
        block(out, lit, dist);
      } else {
        fail("PNG: bad deflate block type");
      }
    }
    return out;
  }

 private:
  struct Table {  // canonical code: counts by length, symbols by code
    int count[16] = {};
    int symbol[320] = {};
    Table(const uint8_t* lens, int n) {
      for (int i = 0; i < n; ++i) ++count[lens[i]];
      count[0] = 0;
      int offs[16] = {};
      for (int l = 1; l < 16; ++l) offs[l] = offs[l - 1] + count[l - 1];
      for (int i = 0; i < n; ++i)
        if (lens[i]) symbol[offs[lens[i]]++] = i;
    }
  };

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint32_t bit_ = 0;
  int nbits_ = 0;

  uint32_t bits(int need) {
    while (nbits_ < need) {
      if (pos_ >= n_) fail("PNG: truncated data");
      bit_ |= static_cast<uint32_t>(d_[pos_++]) << nbits_;
      nbits_ += 8;
    }
    uint32_t v = bit_ & ((1u << need) - 1);
    bit_ >>= need;
    nbits_ -= need;
    return v;
  }
  int decode(const Table& t) {
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= static_cast<int>(bits(1));
      int count = t.count[len];
      if (code - count < first) return t.symbol[index + (code - first)];
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    fail("PNG: bad Huffman code");
  }
  void block(std::vector<uint8_t>& out, const Table& lit, const Table& dist) {
    static const int lbase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                                  31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int dbase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                  193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                  6145, 8193, 12289, 16385, 24577};
    static const int dext[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int sym = decode(lit);
      if (sym < 256) {
        out.push_back(static_cast<uint8_t>(sym));
      } else if (sym == 256) {
        return;
      } else {
        sym -= 257;
        if (sym >= 29) fail("PNG: bad length code");
        size_t len = lbase[sym] + bits(lext[sym]);
        int ds = decode(dist);
        if (ds >= 30) fail("PNG: bad distance code");
        size_t back = dbase[ds] + bits(dext[ds]);
        if (back > out.size()) fail("PNG: distance too far back");
        size_t from = out.size() - back;
        for (size_t i = 0; i < len; ++i) out.push_back(out[from + i]);
      }
    }
  }
};

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

}  // namespace

Rgb png_decode(const uint8_t* data, size_t n) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(data, sig, 8) != 0) fail("not a PNG file");
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= n) {
    uint32_t len = be32(data + pos);
    const uint8_t* kind = data + pos + 4;
    if (pos + 12 + static_cast<size_t>(len) > n) fail("PNG: truncated chunk");
    const uint8_t* body = data + pos + 8;
    pos += 12 + static_cast<size_t>(len);
    if (!std::memcmp(kind, "IHDR", 4) && len >= 13) {
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
    } else if (!std::memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(kind, "IEND", 4)) {
      break;
    }
  }
  const int channels = color == 0 ? 1 : color == 2 ? 3 : color == 6 ? 4 : 0;
  if (depth != 8 || channels == 0 || interlace)
    fail("PNG of bit depth " + std::to_string(depth) + ", colour type " + std::to_string(color) +
         ", interlace " + std::to_string(interlace) +
         " is not supported (8-bit grey, RGB or RGBA only)");
  if (w == 0 || h == 0 || w > 65535 || h > 65535) fail("PNG: bad size");
  std::vector<uint8_t> raw = Inflater(idat.data(), idat.size()).run();
  const size_t stride = static_cast<size_t>(w) * channels;
  if (raw.size() < (stride + 1) * h) fail("PNG: image data too short");
  std::vector<uint8_t> prior(stride, 0), cur(stride);
  Rgb img;
  img.h = static_cast<int>(h);
  img.w = static_cast<int>(w);
  img.px.resize(static_cast<size_t>(w) * h * 3);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* r = raw.data() + y * (stride + 1);
    int kind = r[0];
    ++r;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= static_cast<size_t>(channels) ? cur[i - channels] : 0;
      int b = prior[i];
      int c = i >= static_cast<size_t>(channels) ? prior[i - channels] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: fail("PNG: unknown row filter " + std::to_string(kind));
      }
      cur[i] = static_cast<uint8_t>(r[i] + pred);
    }
    uint8_t* o = img.px.data() + static_cast<size_t>(y) * w * 3;
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* s = cur.data() + static_cast<size_t>(x) * channels;
      o[3 * x] = s[0];
      o[3 * x + 1] = channels == 1 ? s[0] : s[1];
      o[3 * x + 2] = channels == 1 ? s[0] : s[2];
    }
    prior.swap(cur);
  }
  return img;
}

}  // namespace ttv
