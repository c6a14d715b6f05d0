// Host-side image codecs of the port's frame loader (built with the host
// compiler into build/libttv_host_<hash>.so, never by nvcc).
//
// jpeg_decode.cpp: what cv2.imread(path, IMREAD_COLOR) computes with
//   libjpeg-turbo's defaults (islow IDCT, fancy upsampling, fixed-point
//   YCbCr->RGB), for baseline, extended-sequential and progressive Huffman
//   streams.
// jpeg_encode.cpp: the bytes cv2.imwrite writes for a .jpg at its defaults
//   (JFIF 1.01, quality 95, 4:2:0, islow FDCT, standard Huffman tables).
// png_decode.cpp: 8-bit grey / RGB / RGBA PNG (the frames some trees hold
//   under im_N.jpg names), with its own inflate.
// ttv_loader.cpp: the threaded frame loader over these.
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace ttv {

// A decode or encode failure: the message names what was wrong; the loader
// and the ctypes entry points prefix the file's path.
struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// RGB image, rows of w * 3 bytes.
struct Rgb {
  int h = 0, w = 0;
  std::vector<uint8_t> px;
};

// JPEG bytes -> RGB (cv2.imread's pixels in RGB order, EXIF orientation
// applied as cv2 applies it).  Throws CodecError.
Rgb jpeg_decode(const uint8_t* data, size_t n);

// [h, w, c] uint8 (c = 3: RGB, c = 1: grey) -> the JPEG bytes cv2.imwrite
// writes for the same pixels (given in BGR / grey); with
// scan_per_component (a test mode), an RGB image's components in three
// non-interleaved scans instead.  Throws CodecError.
std::vector<uint8_t> jpeg_encode(const uint8_t* px, int h, int w, int c,
                                 bool scan_per_component = false);

// PNG bytes -> RGB (grey replicated, alpha dropped).  Throws CodecError.
Rgb png_decode(const uint8_t* data, size_t n);

}  // namespace ttv
