// Shared by K2 (huffman.cu) and K3 (prog_huffman.cu): the per-lane bit
// reader over one column of the [W, S] word matrix, canonical Huffman
// decode against a table row in shared memory, and EXTEND.
//
// A table row is int32 [34 + nv]: maxcode[17], base[17] (sym index =
// code + base[len]), values[nv] zero padded; an index outside [0, nv)
// reads 0, as the TPU kernels' one-hot lookup gives.

#pragma once

#include <cstdint>

namespace tic {

constexpr int kMaxBpm = 64;
constexpr int kTabHeader = 34;  // maxcode[17] + base[17]

struct CompMap {
  int8_t c[kMaxBpm];
};

struct BitReader {
  const uint32_t* col;  // words + s, stride S
  int W;
  long long S;
  uint64_t buf;  // valid bits left-aligned at bit 63
  int nbits;
  int next;

  __device__ uint32_t word(int w) const {
    return w < W ? col[(long long)w * S] : 0u;  // zeros past row W
  }
  __device__ void init(int start_bit) {
    buf = ((uint64_t)word(0) << 32) | (uint64_t)word(1);
    buf <<= start_bit;  // start_bit < 32
    nbits = 64 - start_bit;
    next = 2;
  }
  // One call before each symbol: leaves >= 33 bits, and a symbol takes at
  // most 31 (a 16-bit code plus up to 15 value bits).
  __device__ void refill() {
    if (nbits <= 32) {
      buf |= (uint64_t)word(next) << (32 - nbits);
      ++next;
      nbits += 32;
    }
  }
  __device__ uint32_t peek16() const { return (uint32_t)(buf >> 48); }
  __device__ void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  __device__ int get(int n) {
    if (n == 0) return 0;
    int v = (int)(buf >> (64 - n));
    skip(n);
    return v;
  }
};

// T.81 F.2.2.1 EXTEND
__device__ __forceinline__ int extend(int v, int t) {
  if (t == 0) return 0;
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// Canonical decode: the first length l whose l-bit prefix is <= maxcode[l].
__device__ __forceinline__ bool decode_symbol(const int32_t* tab, int nv,
                                              uint32_t peek, int* len,
                                              int* sym) {
  for (int l = 1; l <= 16; ++l) {
    int code = (int)(peek >> (16 - l));
    if (code <= tab[l]) {
      *len = l;
      int idx = code + tab[17 + l];
      *sym = (idx >= 0 && idx < nv) ? tab[kTabHeader + idx] : 0;
      return true;
    }
  }
  return false;
}

}  // namespace tic
