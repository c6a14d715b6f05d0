// Tables and fixed-point helpers that the JPEG decoder and encoder share
// (libjpeg's jidctint.c / jfdctint.c constants: CONST_BITS 13, PASS1_BITS 2).
#pragma once

#include <cstdint>

namespace ttv {
namespace jpeg {

// Zigzag position -> natural (row-major) index, with 16 guard entries for
// a corrupt run that steps past the last coefficient.
inline constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline constexpr int kConstBits = 13, kPass1Bits = 2;
inline constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                         FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                         FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                         FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                         FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                         FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

// libjpeg's DESCALE: x / 2^n rounded half up, on an arithmetic shift.
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

}  // namespace jpeg
}  // namespace ttv
