// TIFF LZW decompressor (TIFF 6.0 spec §13) — MSB-first variable-width
// codes (9→12 bits), ClearCode=256, EOI=257, with the "early change"
// code-width bump libtiff uses. Native counterpart of the decompression
// libtiff does inside the reference's TIFF path
// (extensions/libtiff/libtiff_decoder.cpp). Written from the spec.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxCodes = 4096;

struct Entry {
  int prev;      // previous code (-1 for roots)
  uint8_t byte;  // last byte of this string
  int len;
};

}  // namespace

extern "C" {

// Returns bytes written, or -1 on malformed input / overflow.
int64_t tic_tiff_lzw_decode(const uint8_t* src, int64_t srclen, uint8_t* dst,
                            int64_t dstcap) {
  Entry table[kMaxCodes];
  std::memset(table, 0, sizeof(table));
  for (int i = 0; i < 256; ++i) table[i] = {-1, (uint8_t)i, 1};

  int next_code = kFirst;
  int width = 9;
  uint32_t acc = 0;
  int nbits = 0;
  int64_t si = 0, di = 0;
  int prev = -1;
  uint8_t first_of_prev = 0;

  auto emit = [&](int code, uint8_t* first_out) -> bool {
    // walk the chain backwards, then reverse in place
    int len = table[code].len;
    if (di + len > dstcap) return false;
    int64_t w = di + len;
    int c = code;
    for (int i = 0; i < len; ++i) {
      dst[--w] = table[c].byte;
      c = table[c].prev;
    }
    *first_out = dst[di];
    di += len;
    return true;
  };

  while (si < srclen || nbits >= width) {
    while (nbits < width && si < srclen) {
      acc = (acc << 8) | src[si++];
      nbits += 8;
    }
    if (nbits < width) break;
    int code = (int)((acc >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;

    if (code == kEoi) break;
    if (code == kClear) {
      next_code = kFirst;
      width = 9;
      prev = -1;
      continue;
    }
    uint8_t first;
    if (code < next_code) {
      if (table[code].len == 0) return -1;  // 256/257 or stale slot
      if (!emit(code, &first)) return -1;
    } else if (code == next_code && prev >= 0) {
      // KwKwK case: string = prev + first byte of prev
      int len = table[prev].len + 1;
      if (di + len > dstcap) return -1;
      int64_t w = di + len;
      dst[--w] = first_of_prev;
      int c = prev;
      for (int i = 0; i < len - 1; ++i) {
        dst[--w] = table[c].byte;
        c = table[c].prev;
      }
      first = dst[di];
      di += len;
    } else {
      return -1;
    }

    if (prev >= 0 && next_code < kMaxCodes) {
      table[next_code] = {prev, first, table[prev].len + 1};
      ++next_code;
      // early change: bump width when next_code+1 hits the limit
      if (next_code + 1 == (1 << width) && width < 12) ++width;
    }
    prev = code;
    first_of_prev = first;
  }
  return di;
}

}  // extern "C"
