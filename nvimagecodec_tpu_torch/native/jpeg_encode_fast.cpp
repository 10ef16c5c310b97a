// Fused single-pass baseline JPEG encoder — the speed-of-light host path.
//
// Covers the common case the batched encoder hits in production (uint8,
// baseline sequential, standard or caller-supplied Huffman tables, sampling
// factors with per-axis ratios 1 or 2): color convert, chroma downsample,
// AAN fDCT + quantization and Huffman bitstream assembly all happen inside
// one MCU-row-resident pass, so every intermediate stays in L1/L2 instead
// of round-tripping ~1 MB of planes and coefficient blocks through memory
// the way the staged path (jpeg_encode_pixels.cpp + jpeg_huffman_encode.cpp)
// does. Fills the role of the reference's fused device encode pipeline
// (extensions/nvjpeg/cuda_encoder.cpp:284-436) on the host side.
//
// Numerics:
//  - color convert: libjpeg jccolor.c fixed-point (identical to ops/color.py
//    and jpeg_encode_pixels.cpp — bit-exact with both);
//  - downsample: libjpeg bias-exact h2v2/h2v1/h1v2 (bit-exact with
//    ops/resample.py);
//  - fDCT: AAN 8-point flowgraph in f32 with the AAN scale factors folded
//    into the quantization reciprocals (float rounding may differ from the
//    staged orthonormal-matmul path by ±1 on exact quantizer boundaries —
//    both are valid encoders, outputs decode identically to within 1 ulp);
//  - entropy: T.81 F.1.2, bit-identical to jpeg_huffman_encode.cpp given
//    the same coefficients.
//
// From-scratch implementation; no reference code used.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// natural index -> zigzag position
struct ZzInv {
  int8_t inv[64];
  ZzInv() {
    for (int k = 0; k < 64; k++) inv[kZigzag[k]] = (int8_t)k;
  }
};
const ZzInv kZzInv;

// byte b of a natural-order nonzero bitmask -> its bits scattered to
// zigzag positions (mask permutation as 8 table lookups)
struct ZzMaskLut {
  uint64_t lut[8][256];
  ZzMaskLut() {
    for (int b = 0; b < 8; b++)
      for (int v = 0; v < 256; v++) {
        uint64_t m = 0;
        for (int j = 0; j < 8; j++)
          if (v & (1 << j)) m |= 1ull << kZzInv.inv[b * 8 + j];
        lut[b][v] = m;
      }
  }
};
const ZzMaskLut kZzMask;

// ---- color conversion LUTs (libjpeg jccolor.c fixed point, SCALEBITS=16)
struct RgbYccTab {
  int32_t ry[256], gy[256], by[256];    // by has +ONE_HALF folded
  int32_t rcb[256], gcb[256], bcb[256]; // bcb has +CBCR_OFF folded
  int32_t gcr[256], bcr[256];           // rcr == bcb table (0.5 factor)
  RgbYccTab() {
    const int32_t ONE_HALF = 1 << 15;
    const int32_t CBCR_OFF = (128 << 16) + ONE_HALF - 1;
    for (int i = 0; i < 256; i++) {
      ry[i] = 19595 * i;
      gy[i] = 38470 * i;
      by[i] = 7471 * i + ONE_HALF;
      rcb[i] = -11059 * i;
      gcb[i] = -21709 * i;
      bcb[i] = 32768 * i + CBCR_OFF;
      gcr[i] = -27439 * i;
      bcr[i] = -5329 * i;
    }
  }
};
const RgbYccTab kYcc;

// ---- Huffman encode tables (T.81 C.2), same blob layout as
// jpeg_huffman_encode.cpp: 8 slots x 272 bytes (0-3 DC, 4-7 AC)
struct EncTable {
  uint32_t code[256];
  int8_t size[256];
};

void derive_table(const uint8_t* blob, EncTable& t) {
  std::memset(t.size, 0, sizeof(t.size));
  uint32_t code = 0;
  int k = 16;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < blob[len - 1]; ++i) {
      uint8_t v = blob[k++];
      t.code[v] = code;
      t.size[v] = (int8_t)len;
      ++code;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* buf = nullptr;
  size_t len = 0;
  uint64_t acc = 0;
  int nbits = 0;

  inline void emit(uint8_t b) {
    buf[len++] = b;
    if (b == 0xFF) buf[len++] = 0x00;
  }
  inline void put(uint32_t code, int size) {
    acc = (acc << size) | code;
    nbits += size;
    if (nbits >= 32) {
      nbits -= 32;
      uint32_t w32 = (uint32_t)(acc >> nbits);
      emit((uint8_t)(w32 >> 24));
      emit((uint8_t)(w32 >> 16));
      emit((uint8_t)(w32 >> 8));
      emit((uint8_t)w32);
    }
  }
  inline void flush() {
    while (nbits >= 8) {
      nbits -= 8;
      emit((uint8_t)((acc >> nbits) & 0xFF));
    }
    if (nbits) {
      emit((uint8_t)(((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1)) &
                     0xFF));
      nbits = 0;
    }
  }
};

inline int csize(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

// --------------------------------------------------------------------------
// fDCT + quantize: AAN flowgraph, AVX2 (8 columns per vector) with scalar
// fallback. src: int16 rows (stride in elements); qs: natural-order f32
// reciprocals with the AAN scale folded (1 / (q * aan[u] * aan[v] * 8)).
// out: int16[64] natural order. Returns the natural-order nonzero bitmask.
// --------------------------------------------------------------------------

#if defined(__AVX2__)

inline void transpose8(__m256 r[8]) {
  __m256 t0 = _mm256_unpacklo_ps(r[0], r[1]);
  __m256 t1 = _mm256_unpackhi_ps(r[0], r[1]);
  __m256 t2 = _mm256_unpacklo_ps(r[2], r[3]);
  __m256 t3 = _mm256_unpackhi_ps(r[2], r[3]);
  __m256 t4 = _mm256_unpacklo_ps(r[4], r[5]);
  __m256 t5 = _mm256_unpackhi_ps(r[4], r[5]);
  __m256 t6 = _mm256_unpacklo_ps(r[6], r[7]);
  __m256 t7 = _mm256_unpackhi_ps(r[6], r[7]);
  __m256 s0 = _mm256_shuffle_ps(t0, t2, 0x44);
  __m256 s1 = _mm256_shuffle_ps(t0, t2, 0xEE);
  __m256 s2 = _mm256_shuffle_ps(t1, t3, 0x44);
  __m256 s3 = _mm256_shuffle_ps(t1, t3, 0xEE);
  __m256 s4 = _mm256_shuffle_ps(t4, t6, 0x44);
  __m256 s5 = _mm256_shuffle_ps(t4, t6, 0xEE);
  __m256 s6 = _mm256_shuffle_ps(t5, t7, 0x44);
  __m256 s7 = _mm256_shuffle_ps(t5, t7, 0xEE);
  r[0] = _mm256_permute2f128_ps(s0, s4, 0x20);
  r[1] = _mm256_permute2f128_ps(s1, s5, 0x20);
  r[2] = _mm256_permute2f128_ps(s2, s6, 0x20);
  r[3] = _mm256_permute2f128_ps(s3, s7, 0x20);
  r[4] = _mm256_permute2f128_ps(s0, s4, 0x31);
  r[5] = _mm256_permute2f128_ps(s1, s5, 0x31);
  r[6] = _mm256_permute2f128_ps(s2, s6, 0x31);
  r[7] = _mm256_permute2f128_ps(s3, s7, 0x31);
}

// one AAN 1D pass across the vector index (lanes stay independent)
inline void aan_pass(__m256 r[8]) {
  const __m256 c707 = _mm256_set1_ps(0.707106781f);
  const __m256 c382 = _mm256_set1_ps(0.382683433f);
  const __m256 c541 = _mm256_set1_ps(0.541196100f);
  const __m256 c130 = _mm256_set1_ps(1.306562965f);
  __m256 tmp0 = _mm256_add_ps(r[0], r[7]);
  __m256 tmp7 = _mm256_sub_ps(r[0], r[7]);
  __m256 tmp1 = _mm256_add_ps(r[1], r[6]);
  __m256 tmp6 = _mm256_sub_ps(r[1], r[6]);
  __m256 tmp2 = _mm256_add_ps(r[2], r[5]);
  __m256 tmp5 = _mm256_sub_ps(r[2], r[5]);
  __m256 tmp3 = _mm256_add_ps(r[3], r[4]);
  __m256 tmp4 = _mm256_sub_ps(r[3], r[4]);
  // even part
  __m256 tmp10 = _mm256_add_ps(tmp0, tmp3);
  __m256 tmp13 = _mm256_sub_ps(tmp0, tmp3);
  __m256 tmp11 = _mm256_add_ps(tmp1, tmp2);
  __m256 tmp12 = _mm256_sub_ps(tmp1, tmp2);
  r[0] = _mm256_add_ps(tmp10, tmp11);
  r[4] = _mm256_sub_ps(tmp10, tmp11);
  __m256 z1 = _mm256_mul_ps(_mm256_add_ps(tmp12, tmp13), c707);
  r[2] = _mm256_add_ps(tmp13, z1);
  r[6] = _mm256_sub_ps(tmp13, z1);
  // odd part
  tmp10 = _mm256_add_ps(tmp4, tmp5);
  tmp11 = _mm256_add_ps(tmp5, tmp6);
  tmp12 = _mm256_add_ps(tmp6, tmp7);
  __m256 z5 = _mm256_mul_ps(_mm256_sub_ps(tmp10, tmp12), c382);
  __m256 z2 = _mm256_fmadd_ps(c541, tmp10, z5);
  __m256 z4 = _mm256_fmadd_ps(c130, tmp12, z5);
  __m256 z3 = _mm256_mul_ps(tmp11, c707);
  __m256 z11 = _mm256_add_ps(tmp7, z3);
  __m256 z13 = _mm256_sub_ps(tmp7, z3);
  r[5] = _mm256_add_ps(z13, z2);
  r[3] = _mm256_sub_ps(z13, z2);
  r[1] = _mm256_add_ps(z11, z4);
  r[7] = _mm256_sub_ps(z11, z4);
}

inline uint64_t fdct_quant_block(const int16_t* src, int64_t stride,
                                 const float* qs, int16_t* out) {
  const __m256 c128 = _mm256_set1_ps(128.0f);
  __m256 r[8];
  for (int i = 0; i < 8; i++) {
    __m128i v16 = _mm_loadu_si128((const __m128i*)(src + i * stride));
    __m256i v32 = _mm256_cvtepi16_epi32(v16);
    r[i] = _mm256_sub_ps(_mm256_cvtepi32_ps(v32), c128);
  }
  aan_pass(r);     // transform down columns
  transpose8(r);   // r[j] now holds (lane u) the column-DCT of column j
  aan_pass(r);     // transform across columns -> r[v] lane u = S[u][v]
  transpose8(r);   // r[u] lane v = S[u][v] (natural order rows)

  const __m256 half = _mm256_set1_ps(0.5f);
  const __m256 sgnmask = _mm256_set1_ps(-0.0f);
  uint64_t zero_nat = 0;
  const __m256i zeroi = _mm256_setzero_si256();
  for (int u = 0; u < 8; u += 2) {
    __m256 q0 = _mm256_mul_ps(r[u], _mm256_loadu_ps(qs + u * 8));
    __m256 q1 = _mm256_mul_ps(r[u + 1], _mm256_loadu_ps(qs + u * 8 + 8));
    // round half away from zero: sign(q) * floor(|q| + 0.5)
    __m256 s0 = _mm256_and_ps(q0, sgnmask);
    __m256 s1 = _mm256_and_ps(q1, sgnmask);
    __m256 a0 = _mm256_floor_ps(_mm256_add_ps(_mm256_andnot_ps(sgnmask, q0), half));
    __m256 a1 = _mm256_floor_ps(_mm256_add_ps(_mm256_andnot_ps(sgnmask, q1), half));
    __m256i i0 = _mm256_cvttps_epi32(_mm256_or_ps(a0, s0));
    __m256i i1 = _mm256_cvttps_epi32(_mm256_or_ps(a1, s1));
    __m256i p = _mm256_packs_epi32(i0, i1);
    p = _mm256_permute4x64_epi64(p, 0xD8);
    _mm256_storeu_si256((__m256i*)(out + u * 8), p);
    __m256i eq = _mm256_cmpeq_epi16(p, zeroi);
    uint32_t mm = (uint32_t)_mm256_movemask_epi8(eq);
#if defined(__BMI2__)
    uint64_t z16 = _pext_u64(mm, 0x55555555u);
#else
    uint64_t z16 = 0;
    for (int j = 0; j < 16; j++) z16 |= ((mm >> (2 * j)) & 1u) << j;
#endif
    zero_nat |= z16 << (u * 8);
  }
  return ~zero_nat;  // nonzero mask, natural order
}

#else  // scalar fallback

inline uint64_t fdct_quant_block(const int16_t* src, int64_t stride,
                                 const float* qs, int16_t* out) {
  float b[64], t[64];
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) b[i * 8 + j] = (float)src[i * stride + j] - 128.0f;
  auto pass = [](const float* in, int is, int js, float* o) {
    for (int j = 0; j < 8; j++) {
      const float* d = in + j * js;
      float tmp0 = d[0 * is] + d[7 * is], tmp7 = d[0 * is] - d[7 * is];
      float tmp1 = d[1 * is] + d[6 * is], tmp6 = d[1 * is] - d[6 * is];
      float tmp2 = d[2 * is] + d[5 * is], tmp5 = d[2 * is] - d[5 * is];
      float tmp3 = d[3 * is] + d[4 * is], tmp4 = d[3 * is] - d[4 * is];
      float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      float* q = o + j * js;
      q[0 * is] = tmp10 + tmp11;
      q[4 * is] = tmp10 - tmp11;
      float z1 = (tmp12 + tmp13) * 0.707106781f;
      q[2 * is] = tmp13 + z1;
      q[6 * is] = tmp13 - z1;
      tmp10 = tmp4 + tmp5;
      tmp11 = tmp5 + tmp6;
      tmp12 = tmp6 + tmp7;
      float z5 = (tmp10 - tmp12) * 0.382683433f;
      float z2 = 0.541196100f * tmp10 + z5;
      float z4 = 1.306562965f * tmp12 + z5;
      float z3 = tmp11 * 0.707106781f;
      float z11 = tmp7 + z3, z13 = tmp7 - z3;
      q[5 * is] = z13 + z2;
      q[3 * is] = z13 - z2;
      q[1 * is] = z11 + z4;
      q[7 * is] = z11 - z4;
    }
  };
  pass(b, 8, 1, t);  // down columns
  pass(t, 1, 8, b);  // across rows
  uint64_t nz = 0;
  for (int k = 0; k < 64; k++) {
    float q = b[k] * qs[k];
    int v = q >= 0 ? (int)(q + 0.5f) : -(int)(-q + 0.5f);
    out[k] = (int16_t)v;
    if (v) nz |= 1ull << k;
  }
  return nz;
}

#endif

#if defined(__AVX2__)

// RGB interleaved row -> Y/Cb/Cr int16 rows, 16 px per iteration (the
// fixed-point math matches the scalar LUT path bit-for-bit). The two
// 128-bit loads per 8-px group touch exactly bytes [3x, 3x+24) — no
// over-read past the row's own 24 bytes.
struct DeintMasks {
  __m128i rlo, rhi, glo, ghi, blo, bhi;
  DeintMasks() {
    alignas(16) int8_t m[6][16];
    std::memset(m, 0x80, sizeof(m));
    const int8_t idx[6][8] = {
        {0, 3, 6, 9, 12, 15, -1, -1},    // r lo (global 0..15)
        {-1, -1, -1, -1, -1, -1, 10, 13},  // r hi (global 18,21 -> -8)
        {1, 4, 7, 10, 13, -1, -1, -1},   // g lo
        {-1, -1, -1, -1, -1, 8, 11, 14},   // g hi (16,19,22)
        {2, 5, 8, 11, 14, -1, -1, -1},   // b lo
        {-1, -1, -1, -1, -1, 9, 12, 15}};  // b hi (17,20,23)
    for (int t = 0; t < 6; t++)
      for (int i = 0; i < 8; i++)
        if (idx[t][i] >= 0) m[t][i] = idx[t][i];
    rlo = _mm_load_si128((const __m128i*)m[0]);
    rhi = _mm_load_si128((const __m128i*)m[1]);
    glo = _mm_load_si128((const __m128i*)m[2]);
    ghi = _mm_load_si128((const __m128i*)m[3]);
    blo = _mm_load_si128((const __m128i*)m[4]);
    bhi = _mm_load_si128((const __m128i*)m[5]);
  }
};
const DeintMasks kDeint;

// one 8-px group: returns r,g,b as int32x8
inline void load_rgb8(const uint8_t* p, __m256i& r, __m256i& g, __m256i& b) {
  __m128i lo = _mm_loadu_si128((const __m128i*)p);
  __m128i hi = _mm_loadu_si128((const __m128i*)(p + 8));
  __m128i r8 = _mm_or_si128(_mm_shuffle_epi8(lo, kDeint.rlo),
                            _mm_shuffle_epi8(hi, kDeint.rhi));
  __m128i g8 = _mm_or_si128(_mm_shuffle_epi8(lo, kDeint.glo),
                            _mm_shuffle_epi8(hi, kDeint.ghi));
  __m128i b8 = _mm_or_si128(_mm_shuffle_epi8(lo, kDeint.blo),
                            _mm_shuffle_epi8(hi, kDeint.bhi));
  r = _mm256_cvtepu8_epi32(r8);
  g = _mm256_cvtepu8_epi32(g8);
  b = _mm256_cvtepu8_epi32(b8);
}

// (cr*r + cg*g + cb*b + off) >> 16 — all three YCC channels stay
// non-negative after the +off bias, so a logical shift is exact
inline __m256i ycc_dot(__m256i r, __m256i g, __m256i b, int32_t cr,
                       int32_t cg, int32_t cb, int32_t off) {
  __m256i s = _mm256_add_epi32(
      _mm256_add_epi32(_mm256_mullo_epi32(r, _mm256_set1_epi32(cr)),
                       _mm256_mullo_epi32(g, _mm256_set1_epi32(cg))),
      _mm256_add_epi32(_mm256_mullo_epi32(b, _mm256_set1_epi32(cb)),
                       _mm256_set1_epi32(off)));
  return _mm256_srli_epi32(s, 16);
}

// pack two int32x8 (px 0..7, 8..15) into int16x16 and store
inline void store16_i16(int16_t* dst, __m256i a, __m256i b) {
  __m256i p = _mm256_packs_epi32(a, b);
  p = _mm256_permute4x64_epi64(p, 0xD8);
  _mm256_storeu_si256((__m256i*)dst, p);
}

// full RGB->YCbCr row (three outputs); x16 vector groups + scalar tail
inline int64_t rgb_row_ycc_vec(const uint8_t* row, int64_t W, int16_t* py,
                               int16_t* pcb, int16_t* pcr) {
  const int32_t ONE_HALF = 1 << 15;
  const int32_t CBCR_OFF = (128 << 16) + ONE_HALF - 1;
  int64_t x = 0;
  for (; x + 16 <= W; x += 16) {
    __m256i r0, g0, b0, r1, g1, b1;
    load_rgb8(row + x * 3, r0, g0, b0);
    load_rgb8(row + (x + 8) * 3, r1, g1, b1);
    store16_i16(py + x, ycc_dot(r0, g0, b0, 19595, 38470, 7471, ONE_HALF),
                ycc_dot(r1, g1, b1, 19595, 38470, 7471, ONE_HALF));
    store16_i16(pcb + x,
                ycc_dot(r0, g0, b0, -11059, -21709, 32768, CBCR_OFF),
                ycc_dot(r1, g1, b1, -11059, -21709, 32768, CBCR_OFF));
    store16_i16(pcr + x,
                ycc_dot(r0, g0, b0, 32768, -27439, -5329, CBCR_OFF),
                ycc_dot(r1, g1, b1, 32768, -27439, -5329, CBCR_OFF));
  }
  return x;
}

// luma-only row (gray output from RGB input)
inline int64_t rgb_row_y_vec(const uint8_t* row, int64_t W, int16_t* py) {
  const int32_t ONE_HALF = 1 << 15;
  int64_t x = 0;
  for (; x + 16 <= W; x += 16) {
    __m256i r0, g0, b0, r1, g1, b1;
    load_rgb8(row + x * 3, r0, g0, b0);
    load_rgb8(row + (x + 8) * 3, r1, g1, b1);
    store16_i16(py + x, ycc_dot(r0, g0, b0, 19595, 38470, 7471, ONE_HALF),
                ycc_dot(r1, g1, b1, 19595, 38470, 7471, ONE_HALF));
  }
  return x;
}

#endif

// zigzag-permute a natural-order nonzero mask
inline uint64_t zz_mask(uint64_t nat) {
  uint64_t m = 0;
  for (int b = 0; b < 8; b++) m |= kZzMask.lut[b][(nat >> (b * 8)) & 0xFF];
  return m;
}

// Huffman-encode one block from its natural-order coefficients + zz mask
inline void encode_block(BitWriter& w, const int16_t* blk, uint64_t zmask,
                         int& pred, const EncTable& dt, const EncTable& at) {
  int dc = blk[0];
  int diff = dc - pred;
  pred = dc;
  int s = csize(diff);
  uint32_t mag = (uint32_t)(diff >= 0 ? diff : diff + (1 << s) - 1) &
                 ((1u << s) - 1);
  w.put((dt.code[s] << s) | mag, dt.size[s] + s);
  uint64_t m = zmask & ~1ull;
  int prev = 0;
  while (m) {
    int k = __builtin_ctzll(m);
    m &= m - 1;
    int run = k - prev - 1;
    prev = k;
    int v = blk[kZigzag[k]];
    while (run > 15) {
      w.put(at.code[0xF0], at.size[0xF0]);
      run -= 16;
    }
    s = csize(v);
    mag = (uint32_t)(v >= 0 ? v : v + (1 << s) - 1) & ((1u << s) - 1);
    int sym = (run << 4) | s;
    w.put((at.code[sym] << s) | mag, at.size[sym] + s);
  }
  if (prev != 63) w.put(at.code[0x00], at.size[0x00]);
}

}  // namespace

extern "C" {

// Fused baseline encode: uint8 interleaved img [H, W, nchan] -> entropy-coded
// scan bytes (header written by the caller). qs: ncomp*64 natural-order
// quant reciprocals with AAN scales folded. tables: 8*272-byte Huffman blob.
// Per-axis sampling ratios must be 1 or 2 (else rc=-3: caller falls back to
// the staged path). *out malloc'd; free with tic_free.
int tic_jpeg_encode_baseline(const uint8_t* img, int64_t H, int64_t W,
                             int32_t nchan, int32_t ncomp, const int32_t* hfac,
                             const int32_t* vfac, const float* qs,
                             const uint8_t* tables, const int32_t* dc_tbl,
                             const int32_t* ac_tbl, int32_t restart_interval,
                             uint8_t** out, size_t* out_len) {
  if (nchan != 1 && nchan != 3) return -1;
  if (ncomp != 1 && ncomp != 3) return -1;
  if (ncomp == 3 && nchan != 3) return -1;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; c++) {
    if (hfac[c] < 1 || vfac[c] < 1) return -1;
    if (hfac[c] > hmax) hmax = hfac[c];
    if (vfac[c] > vmax) vmax = vfac[c];
  }
  int hf[3], vf[3];
  for (int c = 0; c < ncomp; c++) {
    hf[c] = hmax / hfac[c];
    vf[c] = vmax / vfac[c];
    if (hf[c] * hfac[c] != hmax || vf[c] * vfac[c] != vmax ||
        (hf[c] != 1 && hf[c] != 2) || (vf[c] != 1 && vf[c] != 2))
      return -3;
  }

  const int64_t mcus_x = (W + 8 * hmax - 1) / (8 * hmax);
  const int64_t mcus_y = (H + 8 * vmax - 1) / (8 * vmax);
  const int64_t Wfull = mcus_x * 8 * hmax;
  int64_t bw[3], cw[3], ch[3];
  for (int c = 0; c < ncomp; c++) {
    bw[c] = mcus_x * hfac[c];
    cw[c] = (W * hfac[c] + hmax - 1) / hmax;
    ch[c] = (H * vfac[c] + vmax - 1) / vmax;
  }

  EncTable dct_t[4], act_t[4];
  for (int i = 0; i < 4; ++i) {
    derive_table(tables + (size_t)i * 272, dct_t[i]);
    derive_table(tables + (size_t)(4 + i) * 272, act_t[i]);
  }

  // full-res staging rows (one MCU row) + downsampled component rows
  const int64_t frows = (int64_t)vmax * 8;
  int16_t* full[3] = {nullptr, nullptr, nullptr};
  int16_t* dsb[3] = {nullptr, nullptr, nullptr};
  int16_t* lastrow[3] = {nullptr, nullptr, nullptr};
  bool have_last[3] = {false, false, false};
  for (int c = 0; c < ncomp; c++) {
    full[c] = (int16_t*)malloc(sizeof(int16_t) * frows * Wfull);
    if (hf[c] != 1 || vf[c] != 1) {
      dsb[c] = (int16_t*)malloc(sizeof(int16_t) * (size_t)vfac[c] * 8 *
                                bw[c] * 8);
      lastrow[c] = (int16_t*)malloc(sizeof(int16_t) * bw[c] * 8);
    }
  }
  int64_t total_blocks = 0;
  for (int c = 0; c < ncomp; c++)
    total_blocks += bw[c] * mcus_y * vfac[c];
  size_t cap = (size_t)total_blocks * 64 * 8 + (size_t)mcus_x * mcus_y * 2 + 64;
  BitWriter w;
  w.buf = (uint8_t*)std::malloc(cap);
  bool oom = !w.buf;
  for (int c = 0; c < ncomp; c++) {
    if (!full[c]) oom = true;
    if ((hf[c] != 1 || vf[c] != 1) && (!dsb[c] || !lastrow[c])) oom = true;
  }
  if (oom) {
    for (int c = 0; c < ncomp; c++) {
      free(full[c]);
      free(dsb[c]);
      free(lastrow[c]);
    }
    free(w.buf);
    return -2;
  }

  int pred[3] = {0, 0, 0};
  int rst = 0;
  int16_t blk[64];

  for (int64_t my = 0; my < mcus_y; my++) {
    // ---- stage full-res rows (clamped to H-1, cols replicated to Wfull)
    for (int64_t ry = 0; ry < frows; ry++) {
      int64_t sy = my * frows + ry;
      if (sy >= H) sy = H - 1;
      const uint8_t* row = img + sy * W * nchan;
      if (ncomp == 3) {
        int16_t* py = full[0] + ry * Wfull;
        int16_t* pcb = full[1] + ry * Wfull;
        int16_t* pcr = full[2] + ry * Wfull;
        int64_t x0 = 0;
#if defined(__AVX2__)
        x0 = rgb_row_ycc_vec(row, W, py, pcb, pcr);
#endif
        for (int64_t x = x0; x < W; x++) {
          int r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
          py[x] = (int16_t)((kYcc.ry[r] + kYcc.gy[g] + kYcc.by[b]) >> 16);
          pcb[x] = (int16_t)((kYcc.rcb[r] + kYcc.gcb[g] + kYcc.bcb[b]) >> 16);
          pcr[x] = (int16_t)((kYcc.bcb[r] /* 0.5 r */ + kYcc.gcr[g] +
                              kYcc.bcr[b]) >> 16);
        }
        for (int64_t x = W; x < Wfull; x++) {
          py[x] = py[W - 1];
          pcb[x] = pcb[W - 1];
          pcr[x] = pcr[W - 1];
        }
      } else {
        int16_t* py = full[0] + ry * Wfull;
        if (nchan == 1) {
          int64_t x = 0;
#if defined(__AVX2__)
          for (; x + 16 <= W; x += 16)
            _mm256_storeu_si256(
                (__m256i*)(py + x),
                _mm256_cvtepu8_epi16(
                    _mm_loadu_si128((const __m128i*)(row + x))));
#endif
          for (; x < W; x++) py[x] = row[x];
        } else {
          int64_t x0 = 0;
#if defined(__AVX2__)
          x0 = rgb_row_y_vec(row, W, py);
#endif
          for (int64_t x = x0; x < W; x++) {
            int r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
            py[x] = (int16_t)((kYcc.ry[r] + kYcc.gy[g] + kYcc.by[b]) >> 16);
          }
        }
        for (int64_t x = W; x < Wfull; x++) py[x] = py[W - 1];
      }
    }

    // ---- downsample components that need it (libjpeg bias patterns)
    for (int c = 0; c < ncomp; c++) {
      if (hf[c] == 1 && vf[c] == 1) continue;
      const int64_t crowsp = (int64_t)vfac[c] * 8;  // comp rows per MCU row
      const int64_t cbw = bw[c] * 8;
      for (int64_t cy = 0; cy < crowsp; cy++) {
        int16_t* d = dsb[c] + cy * cbw;
        int64_t gcy = my * crowsp + cy;
        if (gcy >= ch[c]) {  // below the last real row: replicate it
          std::memcpy(d, lastrow[c], sizeof(int16_t) * cbw);
          continue;
        }
        const int16_t* r0 = full[c] + (cy * vf[c]) * Wfull;
        const int16_t* r1 = full[c] + (cy * vf[c] + (vf[c] - 1)) * Wfull;
        if (hf[c] == 2 && vf[c] == 2) {
          for (int64_t x = 0; x < cw[c]; x++) {
            int bias = 1 + (int)(x & 1);
            d[x] = (int16_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] +
                              r1[2 * x + 1] + bias) >> 2);
          }
        } else if (hf[c] == 2) {
          for (int64_t x = 0; x < cw[c]; x++) {
            int bias = (int)(x & 1);
            d[x] = (int16_t)((r0[2 * x] + r0[2 * x + 1] + bias) >> 1);
          }
        } else {  // vf == 2
          for (int64_t x = 0; x < cw[c]; x++) {
            int bias = (int)(x & 1);
            d[x] = (int16_t)((r0[x] + r1[x] + bias) >> 1);
          }
        }
        for (int64_t x = cw[c]; x < cbw; x++) d[x] = d[cw[c] - 1];
        std::memcpy(lastrow[c], d, sizeof(int16_t) * cbw);
        have_last[c] = true;
      }
    }

    // ---- encode this MCU row
    for (int64_t mx = 0; mx < mcus_x; mx++) {
      if (restart_interval) {
        int64_t mcu = my * mcus_x + mx;
        if (mcu && mcu % restart_interval == 0) {
          w.flush();
          w.buf[w.len++] = 0xFF;
          w.buf[w.len++] = (uint8_t)(0xD0 + (rst & 7));
          ++rst;
          pred[0] = pred[1] = pred[2] = 0;
        }
      }
      for (int c = 0; c < ncomp; c++) {
        const int16_t* plane;
        int64_t stride;
        if (hf[c] == 1 && vf[c] == 1) {
          plane = full[c];
          stride = Wfull;
        } else {
          plane = dsb[c];
          stride = bw[c] * 8;
        }
        const EncTable& dt = dct_t[dc_tbl[c]];
        const EncTable& at = act_t[ac_tbl[c]];
        const float* q = qs + c * 64;
        for (int by = 0; by < vfac[c]; by++)
          for (int bx = 0; bx < hfac[c]; bx++) {
            const int16_t* src =
                plane + (int64_t)by * 8 * stride + (mx * hfac[c] + bx) * 8;
            uint64_t nz = fdct_quant_block(src, stride, q, blk);
            encode_block(w, blk, zz_mask(nz), pred[c], dt, at);
          }
      }
    }
  }
  w.flush();

  for (int c = 0; c < ncomp; c++) {
    free(full[c]);
    free(dsb[c]);
    free(lastrow[c]);
  }
  (void)have_last;
  *out = w.buf;
  *out_len = w.len;
  return 0;
}

}  // extern "C"
