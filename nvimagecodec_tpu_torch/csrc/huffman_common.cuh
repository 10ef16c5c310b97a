// Shared by K2 (huffman.cu) and K3 (prog_huffman.cu): the per-lane bit
// reader over one column of the [W, S] word matrix, Huffman decode by
// lookahead table with the canonical walk behind it, and EXTEND.
//
// A table row is int32 [34 + nv]: maxcode[17], base[17] (sym index =
// code + base[len]), values[nv] zero padded; an index outside [0, nv)
// reads 0, as the TPU kernels' one-hot lookup gives. Its lookahead row is
// int16 [1 << L]: entry (len << 8) | symbol for every L-bit prefix that
// starts with a code of <= L bits, 0 (escape) where the code is longer or
// missing. The host builds it by running the canonical walk on every
// prefix, so the two agree by construction.

#pragma once

#include <cstdint>

namespace tic {

constexpr int kMaxBpm = 64;
constexpr int kTabHeader = 34;  // maxcode[17] + base[17]
constexpr int kMaxLook = 12;    // lookahead bits, at most
constexpr unsigned kFullMask = 0xffffffffu;

// Which component, and which block of it, each block of an MCU is.
struct McuMap {
  int8_t comp[kMaxBpm];
  int8_t by[kMaxBpm];
  int8_t bx[kMaxBpm];
};

// A 32-bit window on the lane's bit stream: w0 and w1 are the two words
// the window lies in, `pos` (< 32) its first bit in w0. The next two words
// are already in registers (a0, a1), requested two refills before they are
// used, so no symbol waits on device memory. With kStaged the first `nnear`
// words of the column are read from shared memory (`near`).
template <bool kStaged>
struct BitReader {
  const uint32_t* p;  // row `next` of the lane's column, stride S
  int W;
  long long S;
  const uint32_t* near;
  int nnear;
  uint32_t w0, w1, a0, a1;
  int pos;
  int next;  // row of the word after a1

  // The word at row `next` (zeros past row W); moves on to the next row.
  __device__ uint32_t fetch() {
    uint32_t v;
    if (kStaged && next < nnear) {
      v = near[next];
    } else {
      v = next < W ? __ldg(p) : 0u;
    }
    p += S;
    ++next;
    return v;
  }
  __device__ void init(int start_bit) {  // start_bit < 32
    w0 = fetch();
    w1 = fetch();
    a0 = fetch();
    a1 = fetch();
    pos = start_bit;
  }
  // The next 32 bits, MSB first.
  __device__ uint32_t peek() const { return __funnelshift_l(w1, w0, pos); }
  // n <= 32 bits are used up. A symbol (a code of <= 16 bits and <= 15 value
  // bits) is taken from one window and consumed at once.
  __device__ void consume(int n) {
    pos += n;
    if (pos >= 32) {
      pos -= 32;
      w0 = w1;
      w1 = a0;
      a0 = a1;
      a1 = fetch();
    }
  }
  __device__ int bit() {
    const int v = (int)(peek() >> 31);
    consume(1);
    return v;
  }
};

// The n <= 15 bits that follow the first `len` bits of a window
// (len + n <= 31); 0 for n = 0.
__device__ __forceinline__ int window_bits(uint32_t window, int len, int n) {
  return (int)(((window << len) >> 1) >> (31 - n));
}

// T.81 F.2.2.1 EXTEND
__device__ __forceinline__ int extend(int v, int t) {
  if (t == 0) return 0;
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// EXTEND for t >= 1, without a branch.
__device__ __forceinline__ int extend_nz(int v, int t) {
  return v + (((v - (1 << (t - 1))) >> 31) & ((int)(0xffffffffu << t) + 1));
}

// Canonical decode: the first length l whose l-bit prefix is <= maxcode[l].
// Returns (l << 8) | symbol, or 0 when no code matches. (By value: results
// passed out through pointers would live in local memory on the hot path.)
static __device__ __noinline__ int decode_symbol(const int32_t* tab, int nv,
                                                 uint32_t peek) {
  for (int l = 1; l <= 16; ++l) {
    int code = (int)(peek >> (16 - l));
    if (code <= tab[l]) {
      int idx = code + tab[17 + l];
      int sym = (idx >= 0 && idx < nv) ? tab[kTabHeader + idx] : 0;
      return (l << 8) | (sym & 0xff);
    }
  }
  return 0;
}

// One table: its canonical row and its lookahead row, in shared memory.
struct HuffTab {
  const int32_t* tab;
  const int16_t* look;
};

// Decode the code a 32-bit window starts with: (len << 8) | symbol, or 0
// when no code matches. One shared-memory load for a code of <= L bits; the
// walk for the rest (long codes, missing codes).
__device__ __forceinline__ int decode_fast(const HuffTab& t, int nv, int L,
                                           uint32_t window) {
  const int e = t.look[window >> (32 - L)];
  return e != 0 ? e : decode_symbol(t.tab, nv, window >> 16);
}

// Copies the canonical rows and the lookahead rows into shared memory.
__device__ __forceinline__ void load_tables(int32_t* s_tab,
                                            const int32_t* tables, int ntab,
                                            int16_t* s_look,
                                            const int16_t* look, int nlook) {
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = tables[i];
  // nlook is a multiple of 2 (rows of 1 << L entries, L >= 1)
  const int32_t* src = reinterpret_cast<const int32_t*>(look);
  int32_t* dst = reinterpret_cast<int32_t*>(s_look);
  for (int i = threadIdx.x; i < nlook / 2; i += blockDim.x) dst[i] = src[i];
}

}  // namespace tic
