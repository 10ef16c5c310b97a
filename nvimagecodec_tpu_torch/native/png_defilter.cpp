// PNG scanline defilter (RFC 2083 §6) — the serial hot loop of PNG decode.
// Native counterpart of the filter-undo work libpng does inside the
// reference's CPU PNG path (extensions/opencv/opencv_decoder.cpp via
// cv::imdecode). Implemented from the spec; no reference code used.
//
// In-place over the raw inflate output: rows of (1 filter byte + rowbytes).
// Writes the defiltered pixel bytes contiguously into `out`.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return pb <= pc ? (uint8_t)b : (uint8_t)c;
}

}  // namespace

extern "C" {

// raw: h * (1 + rowbytes) filtered bytes. out: h * rowbytes.
// bpp: filter unit in bytes (ceil(bitdepth*channels/8), min 1).
int tic_png_defilter(const uint8_t* raw, int64_t raw_len, int h,
                     int64_t rowbytes, int bpp, uint8_t* out) {
  if ((int64_t)h * (rowbytes + 1) > raw_len) return 1;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t filter = raw[(size_t)y * (rowbytes + 1)];
    const uint8_t* src = raw + (size_t)y * (rowbytes + 1) + 1;
    uint8_t* dst = out + (size_t)y * rowbytes;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, rowbytes);
        break;
      case 1:  // Sub
        std::memcpy(dst, src, bpp < rowbytes ? bpp : rowbytes);
        for (int64_t i = bpp; i < rowbytes; ++i)
          dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (int64_t i = 0; i < rowbytes; ++i)
            dst[i] = (uint8_t)(src[i] + prev[i]);
        else
          std::memcpy(dst, src, rowbytes);
        break;
      case 3:  // Average
        for (int64_t i = 0; i < rowbytes; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < rowbytes; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(left, up, ul));
        }
        break;
      default:
        return 2;
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
