// J2K Tier-1 on the card: the EBCOT code-block decode (T.800 Annex D: the
// MQ decoder of T.88 and the significance propagation, magnitude refinement
// and cleanup passes, with run-length mode), writing each code-block's int32
// coefficients straight into the flat subband buffer that the J2K pixel
// stage reads (codecs/jpeg2000/core.py, `_SubbandStage`).
//
// Replaces no TPU kernel: the JAX package decodes Tier-1 on the host, as
// the port's host route still does (native/j2k_t1.cpp). This is an own copy
// of that host decoder's logic (`T1Decoder`): the same stripe-column flag
// words, packed MQ states, contexts and tables, and every part-1 style it
// decodes (BYPASS, RESET, TERMALL, CAUSAL, SEGSYM; ERTERM segments read as
// any), so its coefficients equal the host's bit for bit.
//
// Input (ops/j2k_t1.py builds it and checks every row on the host, so the
// kernel has no error path): `table` [n, 10] int32, a row a code-block —
//   0 offset of its segment in `data` (bytes), 1 its length,
//   2 w, 3 h (1..4096, w * h <= 4096), 4 band type (0 LL, 1 HL, 2 LH, 3 HH)
//   | code-block style << 8, 5 magnitude bit-planes (0..31), 6 coding passes,
//   7 the destination's row stride (elements), 8 / 9 the low / high 32 bits
//   of the destination's offset in `out` (elements).
// Under TERMALL or BYPASS (style & 0x05) the segment is the host decoder's
// blob: [int32 count][int32 lengths...][the segments back to back].
// `out` arrives zeroed; the kernel writes each block's w x h coefficients.
//
// Bound on an H100: not bytes (a 1024x1024 RGB lossless image reads about
// 1.85 MB of codestream and writes 12.6 MB of coefficients: 4.3 us at 3.35
// TB/s) but the latency of the longest code-block's chain of MQ decisions,
// each of which waits on the one before through the coder's registers and
// the context states. What the design does about it:
//  - one warp a code-block, lane 0 decoding: the ~768 blocks of a 1024x1024
//    RGB image are all resident at once (a few warps an SM), so the launch
//    takes as long as its longest block, and no lane waits on another
//    block's branches. The other lanes zero the block's state, build the
//    tables and write the coefficients out, 128 B a store.
//  - the flag words (at most (h/4 + 2) x (w + 2) x 4 B) and the sign-
//    magnitude coefficients (w x h x 4 B) live in shared memory, so every
//    read-modify-write of the scan stays on the SM, and device memory sees
//    each coefficient once.
//  - the MQ registers stay in registers across a pass, the renormalisation
//    out of line; the contexts that magnitude refinement and run-length
//    mode use most (16, RUN, UNI) stay in registers too.
//  - the table comes sorted longest segment first, so where blocks
//    outnumber the resident warps the longest chains start first.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define T1_FN __device__ __forceinline__
#define T1_OUTLINED __device__ __noinline__
#define T1_CONST __constant__
#define T1_CLZ(x) __clz((int)(x))
#define T1_LD8(p) ((uint32_t)__ldg(p))
#else  // the same decode core compiled for the host (tests)
#define T1_FN inline
#define T1_OUTLINED inline
#define T1_CONST static const
#define T1_CLZ(x) __builtin_clz(x)
#define T1_LD8(p) ((uint32_t)*(p))
#endif

namespace {

struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

T1_CONST QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int kNumCtx = 19;
constexpr int CTX_UNI = 18;  // uniform
constexpr int CTX_RUN = 17;  // run-length
constexpr int kRowInts = 10;

// The tables a CTA builds in shared memory: the MQ states as (state, MPS)
// nodes packed into one word each (bits 63..32 qe | bit 24 mps | 23..12
// the LPS node | 11..0 the MPS node), the zero-coding context of every
// 3x3 significance window per band class (LL/LH, HL, HH; T.800 Table D.1)
// and the sign-coding context and XOR bit of every neighbourhood (Table
// D.2), as native/j2k_t1.cpp lays them out.
struct Tables {
  uint64_t mq[47 * 2];
  uint8_t zc[3][512];
  uint8_t sc[256];
};

T1_FN uint64_t mq_node(int k) {
  const int i = k >> 1, m = k & 1;
  const uint64_t nmps = (uint64_t)(2 * kQe[i].nmps + m);
  const uint64_t nlps = (uint64_t)(2 * kQe[i].nlps + (kQe[i].sw ? 1 - m : m));
  return ((uint64_t)kQe[i].qe << 32) | ((uint64_t)m << 24) | (nlps << 12) |
         nmps;
}

// band: 0 LL, 1 HL, 2 LH, 3 HH; h, v, d: significant horizontal, vertical
// and diagonal neighbours
T1_FN int zc_context(int band, int h, int v, int d) {
  if (band == 1) {
    int t = h;
    h = v;
    v = t;
  }
  if (band != 3) {
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : d >= 1 ? 6 : 5;
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : d;
  }
  const int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
  return hv >= 2 ? 2 : hv;
}

// idx: significance of W, E, N, S in bits 0..3, their signs in bits 4..7;
// returns the context | XOR bit << 5
T1_FN uint8_t sc_entry(int idx) {
  int hs = 0, vs = 0;
  for (int k = 0; k < 2; k++) {
    if ((idx >> k) & 1) hs += ((idx >> (4 + k)) & 1) ? -1 : 1;
    if ((idx >> (2 + k)) & 1) vs += ((idx >> (6 + k)) & 1) ? -1 : 1;
  }
  const int hc = hs > 0 ? 1 : hs < 0 ? -1 : 0;
  const int vc = vs > 0 ? 1 : vs < 0 ? -1 : 0;
  int cx, x;
  if (hc == 1) {
    cx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
    x = 0;
  } else if (hc == 0) {
    cx = vc == 0 ? 9 : 10;
    x = vc == -1;
  } else {
    cx = vc == 1 ? 11 : vc == 0 ? 12 : 13;
    x = 1;
  }
  return (uint8_t)(cx | (x << 5));
}

// lane `lane` of `lanes` fills its share of the tables
T1_FN void build_tables(Tables& tb, int lane, int lanes) {
  for (int k = lane; k < 47 * 2; k += lanes) tb.mq[k] = mq_node(k);
  for (int m = lane; m < 512; m += lanes) {
    const int hs = ((m >> 3) & 1) + ((m >> 5) & 1);
    const int vs = ((m >> 1) & 1) + ((m >> 7) & 1);
    const int d = (m & 1) + ((m >> 2) & 1) + ((m >> 6) & 1) + ((m >> 8) & 1);
    tb.zc[0][m] = (uint8_t)zc_context(0, hs, vs, d);
    tb.zc[1][m] = (uint8_t)zc_context(1, hs, vs, d);
    tb.zc[2][m] = (uint8_t)zc_context(3, hs, vs, d);
  }
  for (int k = lane; k < 256; k += lanes) tb.sc[k] = sc_entry(k);
}

// ---------------------------------------------------------------- MQ decoder
struct Mq {
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t c;
  uint32_t a;
  int ct;
};

T1_FN void mq_bytein(Mq& v) {
  if (v.bp < v.end && T1_LD8(v.bp) == 0xFF) {
    if (v.bp + 1 < v.end && T1_LD8(v.bp + 1) > 0x8F) {
      v.c += 0xFF00;
      v.ct = 8;
    } else {
      v.bp++;
      v.c += (v.bp < v.end ? T1_LD8(v.bp) : 0xFFu) << 9;
      v.ct = 7;
    }
  } else {
    v.bp++;
    v.c += (v.bp < v.end ? T1_LD8(v.bp) : 0xFFu) << 8;
    v.ct = 8;
  }
}

// shift in as many bits as the stuffing window allows an iteration. Out of
// line and by value: the decisions that need it are the rarer ones, and the
// common path stays short with the coder's registers in registers (on an
// H100, a 1024x1024x3 image took 13.0-13.6 ms inlined, 9.8 out of line by
// reference, which keeps them in local memory, and 8.4 so)
T1_OUTLINED Mq mq_renorm(Mq v) {
  do {
    if (v.ct == 0) mq_bytein(v);
    int sh = T1_CLZ(v.a) - 16;  // bits until bit 15 is set
    if (sh > v.ct) sh = v.ct;
    v.a <<= sh;
    v.c <<= sh;
    v.ct -= sh;
  } while (v.a < 0x8000);
  return v;
}

T1_FN uint32_t mq_decode(Mq& v, uint64_t& cx, const uint64_t* mqt) {
  const uint64_t st = cx;
  const uint32_t qe = (uint32_t)(st >> 32);
  const uint32_t mps = (uint32_t)(st >> 24) & 1u;
  uint32_t d;
  v.a -= qe;
  if (((v.c >> 16) & 0xFFFF) < qe) {
    // LPS exchange (T.88): t picks the straight or the exchanged outcome
    const uint32_t t = v.a < qe;
    d = mps ^ t ^ 1u;
    cx = mqt[(st >> (t ? 0 : 12)) & 0xFFF];
    v.a = qe;
    v = mq_renorm(v);
  } else {
    v.c -= qe << 16;
    if ((v.a & 0x8000) == 0) {  // MPS exchange
      const uint32_t t = v.a < qe;
      d = mps ^ t;
      cx = mqt[(st >> (t ? 12 : 0)) & 0xFFF];
      v = mq_renorm(v);
    } else {
      d = mps;
    }
  }
  return d;
}

// start the arithmetic registers on a segment (contexts untouched)
T1_FN void mq_start(Mq& v, const uint8_t* data, int len) {
  v.bp = data;
  v.end = data + len;
  v.c = (v.bp < v.end ? T1_LD8(v.bp) : 0xFFu) << 16;
  mq_bytein(v);
  v.c <<= 7;
  v.ct -= 7;
  v.a = 0x8000;
}

// raw (bypass) bits, MSB first; after an 0xFF byte only 7 bits of the next
struct Raw {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc;
  int n;
  bool prev_ff;
};

T1_FN void raw_start(Raw& r, const uint8_t* d, int len) {
  r.p = d;
  r.end = d + len;
  r.acc = 0;
  r.n = 0;
  r.prev_ff = false;
}

T1_FN uint32_t raw_bit(Raw& r) {
  if (r.n == 0) {
    const uint32_t b = r.p < r.end ? T1_LD8(r.p++) : 0xFFu;
    r.n = r.prev_ff ? 7 : 8;
    r.prev_ff = b == 0xFF;
    r.acc = b;
  }
  r.n--;
  return (r.acc >> r.n) & 1u;
}

// little-endian int32 of the TERMALL/BYPASS blob, at any alignment
T1_FN int32_t ld_i32(const uint8_t* p) {
  return (int32_t)(T1_LD8(p) | (T1_LD8(p + 1) << 8) | (T1_LD8(p + 2) << 16) |
                   (T1_LD8(p + 3) << 24));
}

// ------------------------------------------------------------- block state
// Stripe-column flag words, native/j2k_t1.cpp's layout: one word a (4-row
// stripe s, column x), for rows y0 = 4s .. y0 + 3 —
//   bits  0..17: significance of the 3x6 window (columns x-1, x, x+1 as
//                c = 0..2, rows y0-1 .. y0+4 as t = 0..5) at bit 3t + c;
//   bits 18..23: sign of the centre column, window rows t = 0..5;
//   bits 24..27: visited (pi) for rows j = 0..3;
//   bits 28..31: refined (mu) for rows j = 0..3.
constexpr uint32_t SIG_ALL = 0x3FFFFu;
constexpr uint32_t PI_ALL = 0xFu << 24;
constexpr uint32_t CENTER_ALL =
    (1u << 4) | (1u << 7) | (1u << 10) | (1u << 13);
#define SIG_SELF(j) (1u << (3 * (j) + 4))
#define PI_BIT(j) (1u << (24 + (j)))
#define MU_BIT(j) (1u << (28 + (j)))

struct BlockDec {
  int w, h, S, ws;
  uint32_t ncm3;     // row-3 ZC window mask (CAUSAL drops t = 5)
  uint32_t scm3;     // row-3 south significance/sign mask (CAUSAL: 0)
  uint32_t clnm;     // cleanup run-length significance mask
  uint32_t* F;       // (S + 2) x ws flag words, zeroed; the ring absorbs
                     // the border writes
  int32_t* mag;      // h x w sign-magnitude coefficients, zeroed
  uint64_t* ctx;     // kNumCtx context states
  const uint64_t* mqt;
  const uint8_t* zc;  // the band class's ZC table
  const uint8_t* sc;
  Mq mq;

  T1_FN uint32_t* wp(int s) { return F + (s + 1) * ws + 1; }

  T1_FN void reset_ctx() {
    for (int i = 0; i < kNumCtx; i++) ctx[i] = mqt[0];
    ctx[CTX_UNI] = mqt[2 * 46];
    ctx[CTX_RUN] = mqt[2 * 3];
    ctx[0] = mqt[2 * 4];  // the first ZC context starts at state 4
  }

  // the centre word `f` is in a register; the neighbours' words in memory
  T1_FN void update_sig(uint32_t* p, uint32_t& f, int j, uint32_t neg) {
    f |= SIG_SELF(j) | (neg << (19 + j));
    p[-1] |= 1u << (3 * j + 5);  // the west word sees us in its right column
    p[1] |= 1u << (3 * j + 3);
    if (j == 0) {  // the previous stripe's window row t = 5
      uint32_t* q = p - ws;
      q[0] |= (1u << 16) | (neg << 23);
      q[-1] |= 1u << 17;
      q[1] |= 1u << 15;
    } else if (j == 3) {  // the next stripe's window row t = 0
      uint32_t* q = p + ws;
      q[0] |= (1u << 1) | (neg << 18);
      q[-1] |= 1u << 2;
      q[1] |= 1u << 0;
    }
  }

  T1_FN int sc_index(const uint32_t* p, uint32_t f, int j) {
    const uint32_t sm = j == 3 ? scm3 : 1u;
    return (int)(((f >> (3 * j + 3)) & 1) | (((f >> (3 * j + 5)) & 1) << 1) |
                 (((f >> (3 * j + 1)) & 1) << 2) |
                 ((((f >> (3 * j + 7)) & 1) & sm) << 3) |
                 (((p[-1] >> (19 + j)) & 1) << 4) |
                 (((p[1] >> (19 + j)) & 1) << 5) |
                 (((f >> (18 + j)) & 1) << 6) |
                 ((((f >> (20 + j)) & 1) & sm) << 7));
  }

  // the decoded sign, 1 for negative
  T1_FN uint32_t decode_sign(Mq& mv, const uint32_t* p, uint32_t f, int j) {
    const uint32_t v = sc[sc_index(p, f, j)];
    return mq_decode(mv, ctx[v & 0x1F], mqt) ^ (v >> 5);
  }

#define T1D_SPP_ROW(J, R)                                               \
  {                                                                     \
    uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);        \
    if ((nb != 0) & ((nb & 0x10u) == 0)) {                              \
      if (mq_decode(mv, ctx[zc[nb]], mqt)) {                            \
        uint32_t neg = decode_sign(mv, rowp + x, f, (J));               \
        update_sig(rowp + x, f, (J), neg);                              \
        (R)[x] |= one | (int32_t)(neg << 31);                           \
      }                                                                 \
      f |= PI_BIT(J);                                                   \
    }                                                                   \
  }

  T1_FN void sig_prop_pass(int bp) {
    Mq mv = mq;
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s);
      int32_t* r0 = mag + 4 * s * w;
      int32_t* r1 = r0 + w;
      int32_t* r2 = r1 + w;
      int32_t* r3 = r2 + w;
      if (jmax == 4) {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          if ((f & CENTER_ALL) == CENTER_ALL) continue;  // all significant
          T1D_SPP_ROW(0, r0)
          T1D_SPP_ROW(1, r1)
          T1D_SPP_ROW(2, r2)
          T1D_SPP_ROW(3, r3)
          rowp[x] = f;
        }
      } else {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          T1D_SPP_ROW(0, r0)
          if (jmax > 1) T1D_SPP_ROW(1, r1)
          if (jmax > 2) T1D_SPP_ROW(2, r2)
          rowp[x] = f;
        }
      }
    }
    mq = mv;
  }

#define T1D_MRP_ROW(J, R)                                               \
  if ((f & (SIG_SELF(J) | PI_BIT(J))) == SIG_SELF(J)) {                 \
    if (f & MU_BIT(J)) {                                                \
      (R)[x] |= one & -(int32_t)mq_decode(mv, c16, mqt);                \
    } else {                                                            \
      int cx = ((f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu) & ~0x10u) \
                   ? 15 : 14;                                           \
      (R)[x] |= one & -(int32_t)mq_decode(mv, ctx[cx], mqt);            \
    }                                                                   \
    f |= MU_BIT(J) | PI_BIT(J);                                         \
  }

  T1_FN void mag_ref_pass(int bp) {
    Mq mv = mq;
    uint64_t c16 = ctx[16];
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s);
      int32_t* r0 = mag + 4 * s * w;
      int32_t* r1 = r0 + w;
      int32_t* r2 = r1 + w;
      int32_t* r3 = r2 + w;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        T1D_MRP_ROW(0, r0)
        if (jmax > 1) T1D_MRP_ROW(1, r1)
        if (jmax > 2) T1D_MRP_ROW(2, r2)
        if (jmax > 3) T1D_MRP_ROW(3, r3)
        rowp[x] = f;
      }
    }
    ctx[16] = c16;
    mq = mv;
  }

#define T1D_CLN_SIG(J, R)                                               \
  {                                                                     \
    uint32_t neg = decode_sign(mv, rowp + x, f, (J));                   \
    update_sig(rowp + x, f, (J), neg);                                  \
    (R)[x] |= one | (int32_t)(neg << 31);                               \
  }

#define T1D_CLN_ROW(J, R)                                               \
  {                                                                     \
    if (!(f & (SIG_SELF(J) | PI_BIT(J)))) {                             \
      uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);      \
      if (mq_decode(mv, ctx[zc[nb]], mqt)) T1D_CLN_SIG(J, R)            \
    }                                                                   \
  }

  T1_FN void cleanup_pass(int bp) {
    Mq mv = mq;
    uint64_t crun = ctx[CTX_RUN];
    uint64_t cuni = ctx[CTX_UNI];
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      const bool full = jmax >= 4;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s);
      int32_t* r0 = mag + 4 * s * w;
      int32_t* r1 = r0 + w;
      int32_t* r2 = r1 + w;
      int32_t* r3 = r2 + w;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (full) {
          if ((f & CENTER_ALL) == CENTER_ALL) {  // nothing to code
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          if (!(f & (clnm | PI_ALL))) {  // run-length mode
            if (mq_decode(mv, crun, mqt) == 0) continue;
            uint32_t r = mq_decode(mv, cuni, mqt) << 1;
            r |= mq_decode(mv, cuni, mqt);
            switch (r) {  // row r becomes significant; finish the column
              case 0:
                T1D_CLN_SIG(0, r0)
                T1D_CLN_ROW(1, r1)
                T1D_CLN_ROW(2, r2)
                T1D_CLN_ROW(3, r3)
                break;
              case 1:
                T1D_CLN_SIG(1, r1)
                T1D_CLN_ROW(2, r2)
                T1D_CLN_ROW(3, r3)
                break;
              case 2:
                T1D_CLN_SIG(2, r2)
                T1D_CLN_ROW(3, r3)
                break;
              default:
                T1D_CLN_SIG(3, r3)
                break;
            }
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          T1D_CLN_ROW(0, r0)
          T1D_CLN_ROW(1, r1)
          T1D_CLN_ROW(2, r2)
          T1D_CLN_ROW(3, r3)
          rowp[x] = f & ~PI_ALL;
        } else {
          T1D_CLN_ROW(0, r0)
          if (jmax > 1) T1D_CLN_ROW(1, r1)
          if (jmax > 2) T1D_CLN_ROW(2, r2)
          rowp[x] = f & ~PI_ALL;
        }
      }
    }
    ctx[CTX_RUN] = crun;
    ctx[CTX_UNI] = cuni;
    mq = mv;
  }

  // BYPASS: the decision and the sign are plain bits
  T1_FN void sig_prop_pass_raw(int bp, Raw& rr) {
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s);
      int32_t* r0 = mag + 4 * s * w;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & SIG_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          uint32_t nb = (f >> (3 * j)) & (j == 3 ? ncm3 : 0x1FFu);
          if ((nb != 0) & ((nb & 0x10u) == 0)) {
            if (raw_bit(rr)) {
              uint32_t neg = raw_bit(rr);
              update_sig(rowp + x, f, j, neg);
              r0[j * w + x] |= one | (int32_t)(neg << 31);
            }
            f |= PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  T1_FN void mag_ref_pass_raw(int bp, Raw& rr) {
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s);
      int32_t* r0 = mag + 4 * s * w;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          if ((f & (SIG_SELF(j) | PI_BIT(j))) == SIG_SELF(j)) {
            r0[j * w + x] |= one & -(int32_t)raw_bit(rr);
            f |= MU_BIT(j) | PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  // T.800 D.5: the segmentation symbol on the uniform context, consumed
  T1_FN void read_segsym() {
    Mq mv = mq;
    uint64_t cuni = ctx[CTX_UNI];
    for (int i = 0; i < 4; i++) (void)mq_decode(mv, cuni, mqt);
    ctx[CTX_UNI] = cuni;
    mq = mv;
  }
};

// pass p (0 = the first cleanup) is raw under BYPASS when p >= 10 and it is
// a significance (p % 3 == 1) or refinement (p % 3 == 2) pass
T1_FN bool pass_is_raw(int style, int p) {
  return (style & 0x01) && p >= 10 && (p % 3) != 0;
}

// a segment ends after pass p under TERMALL, and under BYPASS where the
// coder switches between MQ and raw
T1_FN bool terminated_after(int style, int p) {
  if (style & 0x04) return true;
  if (!(style & 0x01)) return false;
  return pass_is_raw(style, p) != pass_is_raw(style, p + 1);
}

// Decodes one code-block's passes into t.mag (sign in bit 31), as
// tic_j2k_t1_decode_strided_style does; t's geometry, zeroed flag words and
// magnitudes, tables and contexts are set by the caller.
T1_FN void decode_block(BlockDec& t, int style, const uint8_t* data,
                        int len, int nbps, int npasses) {
  t.S = (t.h + 3) >> 2;
  t.ws = t.w + 2;
  const bool causal = (style & 0x08) != 0;
  t.ncm3 = causal ? 0x3Fu : 0x1FFu;
  t.scm3 = causal ? 0u : 1u;
  t.clnm = causal ? 0x7FFFu : SIG_ALL;
  // TERMALL/BYPASS: the blob [count][lengths][segments]; each boundary
  // restarts the MQ (or raw) reader
  int nsegs = 1, seg = 0;
  const uint8_t* lens = data;
  const uint8_t* sp = data;
  int sl = len;
  if (style & 0x05) {
    nsegs = ld_i32(data);
    lens = data + 4;
    sp = data + 4 + 4 * nsegs;
    sl = ld_i32(lens);
  }
  t.reset_ctx();
  mq_start(t.mq, sp, sl);
  Raw raw;
  raw_start(raw, sp, 0);
  const bool segsym = (style & 0x20) != 0;
  const bool ctxreset = (style & 0x02) != 0;
  int pass = 0;
  bool cur_raw = false;
  // after pass p
  auto advance = [&](int p) {
    if (ctxreset) t.reset_ctx();
    if ((style & 0x05) && terminated_after(style, p) && pass < npasses &&
        seg + 1 < nsegs) {
      sp += sl;
      seg++;
      sl = ld_i32(lens + 4 * seg);
      if (pass_is_raw(style, p + 1)) {
        raw_start(raw, sp, sl);
        cur_raw = true;
      } else {
        mq_start(t.mq, sp, sl);
        cur_raw = false;
      }
    }
  };
  for (int bp = nbps - 1; bp >= 0 && pass < npasses; bp--) {
    if (bp == nbps - 1) {
      t.cleanup_pass(bp);
      if (segsym) t.read_segsym();
      pass++;
      advance(pass - 1);
    } else {
      if (pass < npasses) {
        if (cur_raw) t.sig_prop_pass_raw(bp, raw);
        else t.sig_prop_pass(bp);
        pass++;
        advance(pass - 1);
      }
      if (pass < npasses) {
        if (cur_raw) t.mag_ref_pass_raw(bp, raw);
        else t.mag_ref_pass(bp);
        pass++;
        advance(pass - 1);
      }
      if (pass < npasses) {
        t.cleanup_pass(bp);
        if (segsym) t.read_segsym();
        pass++;
        advance(pass - 1);
      }
    }
  }
}

// the band class of a band type: its ZC table
T1_FN int band_class(int band) { return band == 1 ? 1 : band == 3 ? 2 : 0; }

// sign-magnitude to two's complement
T1_FN int32_t from_sign_mag(int32_t v) {
  const int32_t m = v >> 31;
  return ((v & 0x7FFFFFFF) ^ m) - m;
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kWarp = 32;

// one CTA (one warp) a table row
// (kWarp, 1): registers are sized for one CTA an SM, not 32, so none spill
__global__ void __launch_bounds__(kWarp, 1)
    j2k_t1_kernel(const int32_t* __restrict__ table,
                  const uint8_t* __restrict__ data,
                  int32_t* __restrict__ out, int flag_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tables& tb = *reinterpret_cast<Tables*>(smem);
  uint64_t* ctx = reinterpret_cast<uint64_t*>(smem + sizeof(Tables));
  uint32_t* F = reinterpret_cast<uint32_t*>(ctx + kNumCtx + 1);
  int32_t* mag = reinterpret_cast<int32_t*>(F + flag_words);
  const int lane = threadIdx.x;
  const int32_t* row = table + (size_t)kRowInts * blockIdx.x;
  const int off = row[0], len = row[1], w = row[2], h = row[3];
  const int band = row[4] & 0xFF, style = row[4] >> 8;
  const int nbps = row[5], npasses = row[6], stride = row[7];
  const int64_t dest =
      (int64_t)(uint32_t)row[8] | ((int64_t)row[9] << 32);
  build_tables(tb, lane, kWarp);
  const int nflags = (((h + 3) >> 2) + 2) * (w + 2);
  for (int i = lane; i < nflags; i += kWarp) F[i] = 0;
  for (int i = lane; i < w * h; i += kWarp) mag[i] = 0;
  __syncwarp();
  if (lane == 0) {
    BlockDec t;
    t.w = w;
    t.h = h;
    t.F = F;
    t.mag = mag;
    t.ctx = ctx;
    t.mqt = tb.mq;
    t.zc = tb.zc[band_class(band)];
    t.sc = tb.sc;
    decode_block(t, style, data + off, len, nbps, npasses);
  }
  __syncwarp();
  int32_t* o = out + dest;
  for (int i = lane; i < w * h; i += kWarp) {
    const int y = i / w, x = i - y * w;
    o[(int64_t)y * stride + x] = from_sign_mag(mag[i]);
  }
}

}  // namespace

// Launches one warp a row of `table` on `stream`, without synchronising.
// flag_words / mag_words: the most flag words ((h/4 + 2) x (w + 2)) and
// coefficients (w x h) of any row, which size the dynamic shared memory.
extern "C" int tic_j2k_t1_decode_blocks(const void* table, int n,
                                        const void* data, void* out,
                                        int flag_words, int mag_words,
                                        void* stream) {
  if (n < 0 || flag_words < 0 || mag_words < 0 || mag_words > 4096)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = sizeof(Tables) + (kNumCtx + 1) * sizeof(uint64_t) +
                      4 * ((size_t)flag_words + (size_t)mag_words);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        j2k_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  j2k_t1_kernel<<<n, kWarp, smem, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const uint8_t*)data, (int32_t*)out,
      flag_words);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
