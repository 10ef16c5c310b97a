// JPEG2000 Tier-1: EBCOT codeblock coder (ITU-T T.800 Annexes C & D).
// MQ arithmetic coder (T.88) + the three coding passes over bitplanes:
// significance propagation, magnitude refinement, cleanup (with run-length
// mode). Both decoder and encoder, host-side — the bit-serial half of the
// hybrid J2K pipeline; the DWT/quant half runs on the GPU
// (the role nvjpeg2k's GPU stages play in the reference,
// extensions/nvjpeg2k/cuda_decoder.cpp). Written from the spec; no
// reference code used.
//
// Coefficients are sign-magnitude int32: bit 31 = sign, bits 30..0 = mag.
// All part-1 code-block styles are handled: BYPASS (raw SPP/MRP passes),
// RESET (per-pass context reset), TERMALL (per-pass termination),
// CAUSAL (stripe-causal context windows), SEGSYM (D.5 segmentation
// symbol), ERTERM — see the cblk_style plumbing below and t1_bridge.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- MQ coder
struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

static const QeEntry kQe[47] = {
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
// context indices
constexpr int CTX_UNI = 18;   // uniform
constexpr int CTX_RUN = 17;   // run-length

// Packed-u64 MQ decoder state: (state index, MPS sense) pairs flattened to
// 94 nodes, each packed into ONE 64-bit word —
//   bits 63..32 qe | bit 24 mps | bits 23..12 nlps node id | 11..0 nmps id
// so the decision's critical path is a single context-slot load (qe arrives
// with the first load, not behind a second dependent pointer chase); the
// next-state word is fetched from kMqPacked only on a state transition and
// is off the critical path until that context's next use.
uint64_t kMqPacked[47 * 2];
struct MqInit {
  MqInit() {
    for (int i = 0; i < 47; i++)
      for (int m = 0; m < 2; m++) {
        uint64_t nmps = (uint64_t)(2 * kQe[i].nmps + m);
        uint64_t nlps = (uint64_t)(2 * kQe[i].nlps + (kQe[i].sw ? 1 - m : m));
        kMqPacked[2 * i + m] = ((uint64_t)kQe[i].qe << 32) |
                               ((uint64_t)m << 24) | (nlps << 12) | nmps;
      }
  }
};
const MqInit kMqInit;

// Decoder state that the pass loops keep in REGISTERS: the flag-array
// stores in the scan loops would otherwise force the compiler to spill and
// reload every coder field around every mq_decode (measured ~2x of the
// whole T1 decode). Passes copy MQDecoder::v into a local, run, copy back.
struct MqVars {
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t c;
  uint32_t a;
  int ct;
};

static inline void mq_bytein(MqVars& v) {
  if (v.bp < v.end && *v.bp == 0xFF) {
    if (v.bp + 1 < v.end && v.bp[1] > 0x8F) {
      v.c += 0xFF00;
      v.ct = 8;
    } else {
      v.bp++;
      v.c += (uint32_t)(v.bp < v.end ? *v.bp : 0xFF) << 9;
      v.ct = 7;
    }
  } else {
    v.bp++;
    v.c += (uint32_t)(v.bp < v.end ? *v.bp : 0xFF) << 8;
    v.ct = 8;
  }
}

// renormalize: shift in as many bits as the 0xFF-stuffing window allows per
// iteration (usually one iteration) instead of bit-at-a-time
static inline void mq_renorm(MqVars& v) {
  do {
    if (v.ct == 0) mq_bytein(v);
    int sh = __builtin_clz(v.a) - 16;  // bits until bit 15 is set
    if (sh > v.ct) sh = v.ct;
    v.a <<= sh;
    v.c <<= sh;
    v.ct -= sh;
  } while (v.a < 0x8000);
}

#ifdef T1_PROFILE
long long g_mq_count = 0;  // profiling builds only (tools/t1prof.cpp)
#define T1_PROF_COUNT() g_mq_count++
#else
#define T1_PROF_COUNT()
#endif

__attribute__((always_inline)) static inline int mq_decode(MqVars& v,
                                                           uint64_t* cp) {
  T1_PROF_COUNT();
  uint64_t st = *cp;
  uint32_t qe = (uint32_t)(st >> 32);
  uint32_t mps = (uint32_t)(st >> 24) & 1u;
  uint32_t d;
  v.a -= qe;
  if (__builtin_expect(((v.c >> 16) & 0xFFFF) < qe, 0)) {
    // LPS exchange path (T.88): t selects straight vs exchanged outcome
    uint32_t t = v.a < qe;
    d = mps ^ t ^ 1u;
    *cp = kMqPacked[(st >> (t ? 0 : 12)) & 0xFFF];
    v.a = qe;
    mq_renorm(v);
  } else {
    v.c -= qe << 16;
    if (__builtin_expect((v.a & 0x8000) == 0, 0)) {
      // MPS exchange path
      uint32_t t = v.a < qe;
      d = mps ^ t;
      *cp = kMqPacked[(st >> (t ? 12 : 0)) & 0xFFF];
      mq_renorm(v);
    } else {
      d = mps;
    }
  }
  return (int)d;
}

struct MQDecoder {
  MqVars v;
  uint64_t ctx[kNumCtx];

  void reset_ctx() {
    for (int i = 0; i < kNumCtx; i++) ctx[i] = kMqPacked[0];
    ctx[CTX_UNI] = kMqPacked[2 * 46];
    ctx[CTX_RUN] = kMqPacked[2 * 3];
    ctx[0] = kMqPacked[2 * 4];
  }

  // restart the arithmetic registers on a new terminated segment while
  // keeping the adapted context states (TERMALL/BYPASS continuation)
  void init_keep_ctx(const uint8_t* data, int len) {
    v.bp = data;
    v.end = data + len;
    v.c = (uint32_t)(v.bp < v.end ? *v.bp : 0xFF) << 16;
    mq_bytein(v);
    v.c <<= 7;
    v.ct -= 7;
    v.a = 0x8000;
  }

  void init(const uint8_t* data, int len) {
    v.bp = data;
    v.end = data + len;
    for (int i = 0; i < kNumCtx; i++) ctx[i] = kMqPacked[0];
    ctx[CTX_UNI] = kMqPacked[2 * 46];
    ctx[CTX_RUN] = kMqPacked[2 * 3];
    ctx[0] = kMqPacked[2 * 4];  // first ZC ctx starts at state 4 (T.800 D.2)
    v.c = (uint32_t)(v.bp < v.end ? *v.bp : 0xFF) << 16;
    mq_bytein(v);
    v.c <<= 7;
    v.ct -= 7;
    v.a = 0x8000;
  }

  inline int decode(int cxi) { return mq_decode(v, &ctx[cxi]); }
};

// Raw (bypass) bit writer: MSB-first with 0xFF stuffing (T.800 D.6)
struct RawWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int n = 0, limit = 8;

  void start(std::vector<uint8_t>* o) {
    out = o;
    acc = 0;
    n = 0;
    limit = 8;
  }
  inline void bit(int b) {
    acc = (acc << 1) | (uint32_t)(b & 1);
    if (++n == limit) {
      out->push_back((uint8_t)acc);
      limit = out->back() == 0xFF ? 7 : 8;
      acc = 0;
      n = 0;
    }
  }
  void flush() {
    if (n) {
      acc <<= (limit - n);  // pad with zeros
      out->push_back((uint8_t)acc);
      acc = 0;
      n = 0;
      limit = 8;
    }
  }
};

struct MqeVars {
  uint32_t c;
  uint32_t a;
  int ct;
};

// Packed-context MQ encoder, mirror of the decoder's layout: each context
// holds its full kMqPacked node word (qe | mps | next-node ids) so the
// encode decision's critical path is one 64-bit load; the pass loops keep
// (a, c, ct) in registers via MqeVars and write them back once per pass.
struct MQEncoder {
  std::vector<uint8_t> out;
  MqeVars v;
  int bp;  // index into out of pending byte (B); -1 until first byteout
  uint64_t ctxw[kNumCtx];

  void init() {
    for (int i = 0; i < kNumCtx; i++) ctxw[i] = kMqPacked[0];
    ctxw[CTX_UNI] = kMqPacked[2 * 46];
    ctxw[CTX_RUN] = kMqPacked[2 * 3];
    ctxw[0] = kMqPacked[2 * 4];
    v.a = 0x8000;
    v.c = 0;
    v.ct = 12;
    bp = -1;
    out.clear();
  }

  __attribute__((noinline)) void byteout(MqeVars& vv) {
    if (bp >= 0 && out[bp] == 0xFF) {
      // stuff: next byte gets 7 bits
      out.push_back((uint8_t)(vv.c >> 20));
      bp = (int)out.size() - 1;
      vv.c &= 0xFFFFF;
      vv.ct = 7;
    } else {
      if (vv.c < 0x8000000) {
        out.push_back((uint8_t)(vv.c >> 19));
        bp = (int)out.size() - 1;
        vv.c &= 0x7FFFF;
        vv.ct = 8;
      } else {
        // carry propagation into B
        if (bp >= 0) {
          out[bp]++;
          if (out[bp] == 0xFF) {
            vv.c &= 0x7FFFFFF;
            out.push_back((uint8_t)(vv.c >> 20));
            bp = (int)out.size() - 1;
            vv.c &= 0xFFFFF;
            vv.ct = 7;
            return;
          }
        }
        vv.c &= 0x7FFFFFF;
        out.push_back((uint8_t)(vv.c >> 19));
        bp = (int)out.size() - 1;
        vv.c &= 0x7FFFF;
        vv.ct = 8;
      }
    }
  }

  __attribute__((always_inline)) inline void encode_w(MqeVars& vv,
                                                      uint64_t& w, int d) {
    uint32_t qe = (uint32_t)(w >> 32);
    vv.a -= qe;
    if (d == (int)((w >> 24) & 1)) {
      if (vv.a & 0x8000) {
        vv.c += qe;
        return;
      }
      if (vv.a < qe) vv.a = qe; else vv.c += qe;
      w = kMqPacked[w & 0xFFF];
    } else {
      if (vv.a < qe) vv.c += qe; else vv.a = qe;
      w = kMqPacked[(w >> 12) & 0xFFF];
    }
    // multi-bit renorm: shift count from the leading zeros of A (LPS
    // renorms move up to 15 bits at once instead of one per iteration);
    // byteout cadence and C growth are identical to the 1-bit loop, so
    // the byte stream is unchanged
    int sh = __builtin_clz((uint32_t)vv.a) - 16;
    while (sh >= vv.ct) {
      int k = vv.ct;
      vv.a <<= k;
      vv.c <<= k;
      sh -= k;
      vv.ct = 0;
      byteout(vv);
    }
    vv.a <<= sh;
    vv.c <<= sh;
    vv.ct -= sh;
  }

  void encode(int cx, int d) { encode_w(v, ctxw[cx], d); }

  void restart_keep_ctx() {
    v.a = 0x8000;
    v.c = 0;
    v.ct = 12;
    bp = -1;  // carry state does not cross a terminated segment
  }

  void flush() {
    // SETBITS
    uint32_t tempc = v.c + v.a;
    v.c |= 0xFFFF;
    if (v.c >= tempc) v.c -= 0x8000;
    v.c <<= v.ct;
    byteout(v);
    v.c <<= v.ct;
    byteout(v);
    // trailing 0xFF bytes may be dropped: the decoder synthesizes 0xFF past
    // the end of the segment (T.88 FLUSH convention used by JPEG2000)
    while (!out.empty() && out.back() == 0xFF) out.pop_back();
  }
};
// ------------------------------------------------- T1 context modeling
// Zero-coding context lookup per band (T.800 Table D.1).
// Inputs: h = sum of horizontal significant neighbors (0-2),
//         v = vertical (0-2), d = diagonal (0-4).
static int zc_context(int band, int h, int v, int d) {
  // band: 0 LL, 1 HL, 2 LH, 3 HH. T.800 Table D.1: LL and LH use the
  // table as-is; HL (horizontally high-pass, vertical correlation)
  // interchanges H and V.
  if (band == 1) {
    int t = h; h = v; v = t;
  }
  if (band == 0 || band == 1 || band == 2) {
    if (h == 2) return 8;
    if (h == 1) {
      if (v >= 1) return 7;
      if (d >= 1) return 6;
      return 5;
    }
    if (v == 2) return 4;
    if (v == 1) return 3;
    if (d >= 2) return 2;
    if (d == 1) return 1;
    return 0;
  }
  // HH
  int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) {
    if (hv >= 1) return 7;
    return 6;
  }
  if (d == 1) {
    if (hv >= 2) return 5;
    if (hv == 1) return 4;
    return 3;
  }
  if (hv >= 2) return 2;
  if (hv == 1) return 1;
  return 0;
}

// Sign-coding context + XOR bit (T.800 Table D.2). hc/vc in {-1,0,1}:
// net sign contribution of horizontal / vertical neighbors.
static void sc_context(int hc, int vc, int* cx, int* xorbit) {
  if (hc == 1) {
    if (vc == 1) { *cx = 13; *xorbit = 0; }
    else if (vc == 0) { *cx = 12; *xorbit = 0; }
    else { *cx = 11; *xorbit = 0; }
  } else if (hc == 0) {
    if (vc == 1) { *cx = 10; *xorbit = 0; }
    else if (vc == 0) { *cx = 9; *xorbit = 0; }
    else { *cx = 10; *xorbit = 1; }
  } else {
    if (vc == 1) { *cx = 11; *xorbit = 1; }
    else if (vc == 0) { *cx = 12; *xorbit = 1; }
    else { *cx = 13; *xorbit = 1; }
  }
}

// ----------------------------------------------------------- block state
// Per-coefficient FLAG WORDS with cached neighbor state (the classic T1
// speed structure, same idea as openjpeg's flags): when a coefficient
// becomes significant it pushes its significance/sign into the flag words
// of its 8 neighbors, so every context lookup is one load + one LUT index
// instead of a 6-load neighborhood walk and a decision tree.

// ---------------------------------------------------------------- decode
//
// Stripe-column flag words: ONE 32-bit word per (4-row stripe, column)
// carries the full 3x6 significance window, the center column's signs, and
// the per-row visited/refined bits, so
//  - a whole column of 4 skips on a single test (the dominant case in
//    early bitplanes),
//  - a ZC context is one shift+mask into a 512-entry LUT,
//  - becoming significant updates 3 words (6 on stripe boundaries)
// instead of 9 per-pixel flag words. This is the classic fast software-T1
// data layout (openjpeg's opj_flag_t uses the same idea); the bit
// assignment here is our own.
//
// Word layout for stripe s (rows y0=4s .. y0+3), column x:
//   bits  0..17: significance of the 3x6 window (cols x-1,x,x+1 as c=0,1,2;
//                window rows y0-1 .. y0+4 as t=0..5) at bit 3*t + c.
//                Row j's 3x3 ZC window is bits [3j, 3j+8]; self = 3j+4.
//   bits 18..23: sign (chi) of the CENTER column, window rows t=0..5.
//   bits 24..27: visited (pi) for rows j=0..3.
//   bits 28..31: refined (mu) for rows j=0..3.
constexpr uint32_t SIG_ALL = 0x3FFFFu;
constexpr uint32_t PI_ALL = 0xFu << 24;
constexpr uint32_t CENTER_ALL = (1u << 4) | (1u << 7) | (1u << 10) | (1u << 13);
inline uint32_t SIG_SELF(int j) { return 1u << (3 * j + 4); }
inline uint32_t PI_BIT(int j) { return 1u << (24 + j); }
inline uint32_t MU_BIT(int j) { return 1u << (28 + j); }

uint8_t kScLut[256];  // [sigWENS | negWENS<<4] -> cx | xorbit<<5

struct ScLutInit {  // fills the SC table once at load
  ScLutInit() {
    for (int idx = 0; idx < 256; idx++) {
      auto contrib = [&](int sig, int neg) {
        return sig ? (neg ? -1 : 1) : 0;
      };
      int hs = contrib(idx & 1, (idx >> 4) & 1) +
               contrib((idx >> 1) & 1, (idx >> 5) & 1);
      int vs = contrib((idx >> 2) & 1, (idx >> 6) & 1) +
               contrib((idx >> 3) & 1, (idx >> 7) & 1);
      int hc = hs > 0 ? 1 : hs < 0 ? -1 : 0;
      int vc = vs > 0 ? 1 : vs < 0 ? -1 : 0;
      int cx, xorbit;
      sc_context(hc, vc, &cx, &xorbit);
      kScLut[idx] = (uint8_t)(cx | (xorbit << 5));
    }
  }
};
const ScLutInit kScLutInit;

// Raw (bypass) segment reader: MSB-first bits with 0xFF stuffing — after
// an 0xFF byte only 7 bits come from the next byte (T.800 D.6).
struct RawReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc;
  int n;
  bool prev_ff;

  void init(const uint8_t* d, int len) {
    p = d;
    end = d + len;
    acc = 0;
    n = 0;
    prev_ff = false;
  }
  inline int bit() {
    if (n == 0) {
      uint8_t b = p < end ? *p++ : 0xFF;
      n = prev_ff ? 7 : 8;
      prev_ff = (b == 0xFF);
      acc = b;
    }
    n--;
    return (int)((acc >> n) & 1);
  }
};

uint8_t kZcLut9[3][512];  // [cls][9-bit 3x3 sig window] -> ZC context
struct Zc9Init {
  Zc9Init() {
    const int bands[3] = {0, 1, 3};
    for (int m = 0; m < 512; m++) {
      int hsum = ((m >> 3) & 1) + ((m >> 5) & 1);
      int vsum = ((m >> 1) & 1) + ((m >> 7) & 1);
      int d = (m & 1) + ((m >> 2) & 1) + ((m >> 6) & 1) + ((m >> 8) & 1);
      for (int c = 0; c < 3; c++)
        kZcLut9[c][m] = (uint8_t)zc_context(bands[c], hsum, vsum, d);
    }
  }
};
const Zc9Init kZc9Init;

struct T1Decoder {
  int w, h, S, cls, ws;
  int style = 0;            // part-1 mode switches (RESET/CAUSAL/SEGSYM)
  uint32_t ncm3 = 0x1FF;    // row-3 ZC window mask (causal drops t=5)
  uint32_t scm3 = 1;        // row-3 south sig/sign mask (causal: 0)
  uint32_t clnm = SIG_ALL;  // cleanup RL significance check mask
  int64_t mstride;          // row stride (elements) of the mag output
  std::vector<uint32_t> F;  // (S+2) x (w+2), pad ring absorbs border writes
  int32_t* mag = nullptr;   // caller's zeroed out buffer
  MQDecoder mq;

  inline uint32_t* wp(int s, int x) {
    return &F[(size_t)(s + 1) * ws + (x + 1)];
  }

  void reset(int w_, int h_, int band_, int style_ = 0) {
    w = w_;
    h = h_;
    S = (h_ + 3) >> 2;
    cls = band_ == 1 ? 1 : band_ == 3 ? 2 : 0;
    ws = w + 2;
    F.assign((size_t)ws * (S + 2), 0);
    style = style_;
    bool causal = (style_ & 0x08) != 0;
    ncm3 = causal ? 0x3Fu : 0x1FFu;    // drop window row t=5 for j=3
    scm3 = causal ? 0u : 1u;
    clnm = causal ? 0x7FFFu : SIG_ALL;  // RL check ignores t=5 row
  }

  // Register-resident column word: the pass loops load the stripe-column
  // flag word ONCE per column into a local `f`, run all four rows against
  // it, and store it back once. Sign/significance updates to the CENTER
  // word therefore go to `f`; only neighbor words are written to memory.
  // (The previous per-row reload + read-modify-write of rowp[x] was ~8
  // memory ops per column on the scan's critical path.) Decoded signs ride
  // bit 31 of the output coefficient — there is no separate sign plane, so
  // the hot path has no uint8 store (char stores defeat TBAA and force
  // member reloads around every MQ decision).
  __attribute__((always_inline)) inline void update_sig_f(
      uint32_t* p, uint32_t& f, int j, uint32_t neg) {
    f |= SIG_SELF(j) | (neg << (19 + j));
    p[-1] |= 1u << (3 * j + 5);  // west word sees us in its right column
    p[1] |= 1u << (3 * j + 3);
    if (j == 0) {  // previous stripe's window row t=5
      uint32_t* q = p - ws;
      q[0] |= (1u << 16) | (neg << 23);
      q[-1] |= 1u << 17;
      q[1] |= 1u << 15;
    } else if (j == 3) {  // next stripe's window row t=0
      uint32_t* q = p + ws;
      q[0] |= (1u << 1) | (neg << 18);
      q[-1] |= 1u << 2;
      q[1] |= 1u << 0;
    }
  }

  // SC context index (same convention as kScLut): sig W/E/N/S | chi<<4.
  // Center-word bits come from the live local `f`; E/W sign bits from the
  // neighbor words in memory (kept current by earlier columns' writebacks).
  __attribute__((always_inline)) inline int sc_index_f(const uint32_t* p,
                                                       uint32_t f, int j) {
    uint32_t sm = j == 3 ? scm3 : 1u;  // stripe-causal: no south for j=3
    int idx = (int)(((f >> (3 * j + 3)) & 1) | (((f >> (3 * j + 5)) & 1) << 1) |
                    (((f >> (3 * j + 1)) & 1) << 2) |
                    ((((f >> (3 * j + 7)) & 1) & sm) << 3) |
                    (((p[-1] >> (19 + j)) & 1) << 4) |
                    (((p[1] >> (19 + j)) & 1) << 5) |
                    (((f >> (18 + j)) & 1) << 6) |
                    ((((f >> (20 + j)) & 1) & sm) << 7));
    return idx;
  }

  // always_inline is load-bearing: if this outlines, mv's address escapes
  // and the compiler demotes the whole pass loop's MQ state to memory
  // (measured ~2x on SPP/MRP). Returns the decoded sign (1 = negative).
  __attribute__((always_inline)) inline uint32_t decode_sign_f(
      MqVars& mv, const uint32_t* p, uint32_t f, int j) {
    uint8_t v = kScLut[sc_index_f(p, f, j)];
    return (uint32_t)(mq_decode(mv, &mq.ctx[v & 0x1F]) ^ (v >> 5));
  }

// one SPP row with compile-time J (immediate shifts/masks) against the
// register-resident column word `f`; R is the hoisted output row pointer
#define T1_SPP_ROW(J, R)                                                \
  {                                                                     \
    uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);        \
    if ((nb != 0) & ((nb & 0x10u) == 0)) {                              \
      if (mq_decode(mv, &mq.ctx[zc[nb]])) {                             \
        uint32_t neg = decode_sign_f(mv, rowp + x, f, (J));             \
        update_sig_f(rowp + x, f, (J), neg);                            \
        (R)[x] |= one | (int32_t)(neg << 31);                           \
      }                                                                 \
      f |= PI_BIT(J);                                                   \
    }                                                                   \
  }

  void sig_prop_pass(int bp) {
    MqVars mv = mq.v;
    const uint8_t* zc = kZcLut9[cls];
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      int32_t* r0 = mag + (size_t)4 * s * mstride;
      int32_t* r1 = r0 + mstride;
      int32_t* r2 = r1 + mstride;
      int32_t* r3 = r2 + mstride;
      if (jmax == 4) {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          // fully-significant column: every row has its self bit, so no
          // sample is SPP-codable and no flag changes — exact skip (the
          // dominant case at the deep bitplanes of busy images)
          if ((f & CENTER_ALL) == CENTER_ALL) continue;
          T1_SPP_ROW(0, r0)
          T1_SPP_ROW(1, r1)
          T1_SPP_ROW(2, r2)
          T1_SPP_ROW(3, r3)
          rowp[x] = f;
        }
      } else {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          T1_SPP_ROW(0, r0)
          if (jmax > 1) T1_SPP_ROW(1, r1)
          if (jmax > 2) T1_SPP_ROW(2, r2)
          rowp[x] = f;
        }
      }
    }
    mq.v = mv;
  }

// one MRP row; no sign coding, so f stays in a register for the column.
// The refinement bit is stored branchlessly — its value is coin-flip data
// and a conditional store mispredicts ~50% of the time.
// ctx16 (already-refined) dominates MRP; its state node stays in a register
// (c16) across the whole pass instead of round-tripping mq.ctx[16] memory
#define T1_MRP_ROW(J, R)                                                \
  if ((f & (SIG_SELF(J) | PI_BIT(J))) == SIG_SELF(J)) {                 \
    if (f & MU_BIT(J)) {                                                \
      (R)[x] |= one & -mq_decode(mv, &c16);                             \
    } else {                                                            \
      int cx = ((f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu) & ~0x10u) \
                   ? 15 : 14;                                           \
      (R)[x] |= one & -mq_decode(mv, &mq.ctx[cx]);                      \
    }                                                                   \
    f |= MU_BIT(J) | PI_BIT(J);                                         \
  }

  void mag_ref_pass(int bp) {
    MqVars mv = mq.v;
    uint64_t c16 = mq.ctx[16];
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      int32_t* r0 = mag + (size_t)4 * s * mstride;
      int32_t* r1 = r0 + mstride;
      int32_t* r2 = r1 + mstride;
      int32_t* r3 = r2 + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        T1_MRP_ROW(0, r0)
        if (jmax > 1) T1_MRP_ROW(1, r1)
        if (jmax > 2) T1_MRP_ROW(2, r2)
        if (jmax > 3) T1_MRP_ROW(3, r3)
        rowp[x] = f;
      }
    }
    mq.ctx[16] = c16;
    mq.v = mv;
  }

// coefficient at compile-time row J becomes significant (CLN hit / RL first)
#define T1_CLN_SIG(J, R)                                                \
  {                                                                     \
    uint32_t neg = decode_sign_f(mv, rowp + x, f, (J));                 \
    update_sig_f(rowp + x, f, (J), neg);                                \
    (R)[x] |= one | (int32_t)(neg << 31);                               \
  }

#define T1_CLN_ROW(J, R)                                                \
  {                                                                     \
    if (!(f & (SIG_SELF(J) | PI_BIT(J)))) {                             \
      uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);      \
      if (mq_decode(mv, &mq.ctx[zc[nb]])) T1_CLN_SIG(J, R)              \
    }                                                                   \
  }

  // Raw (bypass) significance pass: the decision and the sign are plain
  // bits; visited/significance bookkeeping identical to the MQ pass.
  void sig_prop_pass_raw(int bp, RawReader& rr) {
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      int32_t* rows[4];
      rows[0] = mag + (size_t)4 * s * mstride;
      for (int j = 1; j < 4; j++) rows[j] = rows[j - 1] + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & SIG_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          uint32_t nb = (f >> (3 * j)) & (j == 3 ? ncm3 : 0x1FFu);
          if ((nb != 0) & ((nb & 0x10u) == 0)) {
            if (rr.bit()) {
              uint32_t neg = (uint32_t)rr.bit();
              update_sig_f(rowp + x, f, j, neg);
              rows[j][x] |= one | (int32_t)(neg << 31);
            }
            f |= PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  void mag_ref_pass_raw(int bp, RawReader& rr) {
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      int32_t* rows[4];
      rows[0] = mag + (size_t)4 * s * mstride;
      for (int j = 1; j < 4; j++) rows[j] = rows[j - 1] + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          if ((f & (SIG_SELF(j) | PI_BIT(j))) == SIG_SELF(j)) {
            rows[j][x] |= one & -rr.bit();
            f |= MU_BIT(j) | PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  void read_segsym() {
    // T.800 D.5: segmentation symbol 1010 on the UNIFORM context at the
    // end of every cleanup pass; consumed (decoders may validate)
    MqVars mv = mq.v;
    uint64_t cuni = mq.ctx[CTX_UNI];
    for (int i = 0; i < 4; i++) (void)mq_decode(mv, &cuni);
    mq.ctx[CTX_UNI] = cuni;
    mq.v = mv;
  }

  void cleanup_pass(int bp) {
    MqVars mv = mq.v;
    const uint8_t* zc = kZcLut9[cls];
    uint64_t crun = mq.ctx[CTX_RUN];
    uint64_t cuni = mq.ctx[CTX_UNI];
    const int32_t one = (int32_t)1 << bp;
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      bool full = jmax >= 4;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      int32_t* r0 = mag + (size_t)4 * s * mstride;
      int32_t* r1 = r0 + mstride;
      int32_t* r2 = r1 + mstride;
      int32_t* r3 = r2 + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (full) {
          // fully-significant column: no row is CLN-codable; only the
          // visited bits need clearing for the next plane's MRP
          if ((f & CENTER_ALL) == CENTER_ALL) {
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          if (!(f & (clnm | PI_ALL))) {
            // run-length mode
            if (mq_decode(mv, &crun) == 0) continue;
            int r = (mq_decode(mv, &cuni) << 1) | mq_decode(mv, &cuni);
            switch (r) {  // signify row r, then finish the column
              case 0:
                T1_CLN_SIG(0, r0)
                T1_CLN_ROW(1, r1)
                T1_CLN_ROW(2, r2)
                T1_CLN_ROW(3, r3)
                break;
              case 1:
                T1_CLN_SIG(1, r1)
                T1_CLN_ROW(2, r2)
                T1_CLN_ROW(3, r3)
                break;
              case 2:
                T1_CLN_SIG(2, r2)
                T1_CLN_ROW(3, r3)
                break;
              default:
                T1_CLN_SIG(3, r3)
                break;
            }
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          T1_CLN_ROW(0, r0)
          T1_CLN_ROW(1, r1)
          T1_CLN_ROW(2, r2)
          T1_CLN_ROW(3, r3)
          rowp[x] = f & ~PI_ALL;
        } else {
          T1_CLN_ROW(0, r0)
          if (jmax > 1) T1_CLN_ROW(1, r1)
          if (jmax > 2) T1_CLN_ROW(2, r2)
          rowp[x] = f & ~PI_ALL;
        }
      }
    }
    mq.ctx[CTX_RUN] = crun;
    mq.ctx[CTX_UNI] = cuni;
    mq.v = mv;
  }
};

// ---------------------------------------------------------------- encode
// Stripe-column-word encoder: the same data layout and helpers as
// T1Decoder above (one 32-bit word per 4-row stripe column carrying the
// 3x6 significance window, centre signs and visited/refined bits), driven
// from known sign-magnitude coefficients instead of the MQ decisions. The
// legacy per-pixel-flag encoder this replaces spent ~3x the decoder\'s time
// per sample in flag-word traffic.
struct T1EncoderFast {
  int w, h, S, cls, ws;
  int style = 0;            // part-1 mode switches (RESET/CAUSAL/SEGSYM)
  uint32_t ncm3 = 0x1FF;
  uint32_t scm3 = 1;
  uint32_t clnm = SIG_ALL;
  int64_t mstride;
  std::vector<uint32_t> F;   // (S+2) x (w+2) pad ring
  const int32_t* vals = nullptr;  // sign-magnitude input rows
  // per stripe-column OR of the 4 magnitudes: early bitplanes skip an
  // insignificant run-length column on ONE load instead of 4 strided ones
  const uint32_t* mor = nullptr;
  MQEncoder mq;

  inline uint32_t* wp(int s, int x) {
    return &F[(size_t)(s + 1) * ws + (x + 1)];
  }

  void reset(int w_, int h_, int band_, int style_ = 0) {
    w = w_;
    h = h_;
    S = (h_ + 3) >> 2;
    cls = band_ == 1 ? 1 : band_ == 3 ? 2 : 0;
    ws = w + 2;
    F.assign((size_t)ws * (S + 2), 0);
    style = style_;
    bool causal = (style_ & 0x08) != 0;
    ncm3 = causal ? 0x3Fu : 0x1FFu;    // drop window row t=5 for j=3
    scm3 = causal ? 0u : 1u;
    clnm = causal ? 0x7FFFu : SIG_ALL;  // RL check ignores t=5 row
  }

  __attribute__((always_inline)) inline void update_sig_f(
      uint32_t* p, uint32_t& f, int j, uint32_t neg) {
    f |= SIG_SELF(j) | (neg << (19 + j));
    p[-1] |= 1u << (3 * j + 5);
    p[1] |= 1u << (3 * j + 3);
    if (j == 0) {
      uint32_t* q = p - ws;
      q[0] |= (1u << 16) | (neg << 23);
      q[-1] |= 1u << 17;
      q[1] |= 1u << 15;
    } else if (j == 3) {
      uint32_t* q = p + ws;
      q[0] |= (1u << 1) | (neg << 18);
      q[-1] |= 1u << 2;
      q[1] |= 1u << 0;
    }
  }

  __attribute__((always_inline)) inline int sc_index_f(const uint32_t* p,
                                                       uint32_t f, int j) {
    uint32_t sm = j == 3 ? scm3 : 1u;  // stripe-causal: no south for j=3
    return (int)(((f >> (3 * j + 3)) & 1) | (((f >> (3 * j + 5)) & 1) << 1) |
                 (((f >> (3 * j + 1)) & 1) << 2) |
                 ((((f >> (3 * j + 7)) & 1) & sm) << 3) |
                 (((p[-1] >> (19 + j)) & 1) << 4) |
                 (((p[1] >> (19 + j)) & 1) << 5) |
                 (((f >> (18 + j)) & 1) << 6) |
                 ((((f >> (20 + j)) & 1) & sm) << 7));
  }

  __attribute__((always_inline)) inline void encode_sign_f(
      MqeVars& mv, uint32_t* p, uint32_t& f, int j, uint32_t neg) {
    uint8_t v = kScLut[sc_index_f(p, f, j)];
    mq.encode_w(mv, mq.ctxw[v & 0x1F], (int)(neg ^ (uint32_t)(v >> 5)));
    update_sig_f(p, f, j, neg);
  }

#define T1E_SPP_ROW(J, R)                                               \
  {                                                                     \
    uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);        \
    if ((nb != 0) & ((nb & 0x10u) == 0)) {                              \
      uint32_t vv = (uint32_t)(R)[x];                                   \
      int bit = (int)((vv >> bp) & 1);                                  \
      mq.encode_w(mv, mq.ctxw[zc[nb]], bit);                            \
      if (bit) encode_sign_f(mv, rowp + x, f, (J), vv >> 31);           \
      f |= PI_BIT(J);                                                   \
    }                                                                   \
  }

  void sig_prop_pass(int bp) {
    MqeVars mv = mq.v;
    const uint8_t* zc = kZcLut9[cls];
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      const int32_t* r0 = vals + (size_t)4 * s * mstride;
      const int32_t* r1 = r0 + mstride;
      const int32_t* r2 = r1 + mstride;
      const int32_t* r3 = r2 + mstride;
      if (jmax == 4) {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          // fully-significant column: nothing SPP-codable, exact skip
          if ((f & CENTER_ALL) == CENTER_ALL) continue;
          T1E_SPP_ROW(0, r0)
          T1E_SPP_ROW(1, r1)
          T1E_SPP_ROW(2, r2)
          T1E_SPP_ROW(3, r3)
          rowp[x] = f;
        }
      } else {
        for (int x = 0; x < w; x++) {
          uint32_t f = rowp[x];
          if (!(f & SIG_ALL)) continue;
          T1E_SPP_ROW(0, r0)
          if (jmax > 1) T1E_SPP_ROW(1, r1)
          if (jmax > 2) T1E_SPP_ROW(2, r2)
          rowp[x] = f;
        }
      }
    }
    mq.v = mv;
  }

#define T1E_MRP_ROW(J, R)                                               \
  if ((f & (SIG_SELF(J) | PI_BIT(J))) == SIG_SELF(J)) {                 \
    int bit = (int)(((uint32_t)(R)[x] >> bp) & 1);                      \
    if (f & MU_BIT(J)) {                                                \
      mq.encode_w(mv, c16, bit);                                        \
    } else {                                                            \
      mq.encode_w(mv,                                                   \
                  ((f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu)        \
                   & ~0x10u) ? c15 : c14,                               \
                  bit);                                                 \
    }                                                                   \
    f |= MU_BIT(J) | PI_BIT(J);                                         \
  }

  void mag_ref_pass(int bp) {
    MqeVars mv = mq.v;
    // MRP touches exactly three contexts — keep all register-resident
    uint64_t c14 = mq.ctxw[14], c15 = mq.ctxw[15], c16 = mq.ctxw[16];
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      const int32_t* r0 = vals + (size_t)4 * s * mstride;
      const int32_t* r1 = r0 + mstride;
      const int32_t* r2 = r1 + mstride;
      const int32_t* r3 = r2 + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        T1E_MRP_ROW(0, r0)
        if (jmax > 1) T1E_MRP_ROW(1, r1)
        if (jmax > 2) T1E_MRP_ROW(2, r2)
        if (jmax > 3) T1E_MRP_ROW(3, r3)
        rowp[x] = f;
      }
    }
    mq.ctxw[14] = c14;
    mq.ctxw[15] = c15;
    mq.ctxw[16] = c16;
    mq.v = mv;
  }

#define T1E_CLN_SIG(J, R)                                               \
  encode_sign_f(mv, rowp + x, f, (J), ((uint32_t)(R)[x]) >> 31);

#define T1E_CLN_ROW(J, R)                                               \
  {                                                                     \
    if (!(f & (SIG_SELF(J) | PI_BIT(J)))) {                             \
      uint32_t nb = (f >> (3 * (J))) & ((J) == 3 ? ncm3 : 0x1FFu);      \
      int bit = (int)(((uint32_t)(R)[x] >> bp) & 1);                    \
      mq.encode_w(mv, mq.ctxw[zc[nb]], bit);                            \
      if (bit) T1E_CLN_SIG(J, R)                                        \
    }                                                                   \
  }

  void sig_prop_pass_raw(int bp, RawWriter& rw) {
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      const int32_t* rows[4];
      rows[0] = vals + (size_t)4 * s * mstride;
      for (int j = 1; j < 4; j++) rows[j] = rows[j - 1] + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & SIG_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          uint32_t nb = (f >> (3 * j)) & (j == 3 ? ncm3 : 0x1FFu);
          if ((nb != 0) & ((nb & 0x10u) == 0)) {
            uint32_t vv = (uint32_t)rows[j][x];
            int bit = (int)((vv >> bp) & 1);
            rw.bit(bit);
            if (bit) {
              uint32_t neg = vv >> 31;
              rw.bit((int)neg);
              update_sig_f(rowp + x, f, j, neg);
            }
            f |= PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  void mag_ref_pass_raw(int bp, RawWriter& rw) {
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      const int32_t* rows[4];
      rows[0] = vals + (size_t)4 * s * mstride;
      for (int j = 1; j < 4; j++) rows[j] = rows[j - 1] + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (!(f & CENTER_ALL)) continue;
        for (int j = 0; j < jmax; j++) {
          if ((f & (SIG_SELF(j) | PI_BIT(j))) == SIG_SELF(j)) {
            rw.bit((int)(((uint32_t)rows[j][x] >> bp) & 1));
            f |= MU_BIT(j) | PI_BIT(j);
          }
        }
        rowp[x] = f;
      }
    }
  }

  void write_segsym() {
    // T.800 D.5: segmentation symbol 1010 on the UNIFORM context
    MqeVars mv = mq.v;
    mq.encode_w(mv, mq.ctxw[CTX_UNI], 1);
    mq.encode_w(mv, mq.ctxw[CTX_UNI], 0);
    mq.encode_w(mv, mq.ctxw[CTX_UNI], 1);
    mq.encode_w(mv, mq.ctxw[CTX_UNI], 0);
    mq.v = mv;
  }

  void reset_ctx() {
    for (int i = 0; i < kNumCtx; i++) mq.ctxw[i] = kMqPacked[0];
    mq.ctxw[CTX_UNI] = kMqPacked[2 * 46];
    mq.ctxw[CTX_RUN] = kMqPacked[2 * 3];
    mq.ctxw[0] = kMqPacked[2 * 4];
  }

  void cleanup_pass(int bp) {
    MqeVars mv = mq.v;
    uint64_t crun = mq.ctxw[CTX_RUN];
    uint64_t cuni = mq.ctxw[CTX_UNI];
    const uint8_t* zc = kZcLut9[cls];
    for (int s = 0; s < S; s++) {
      int jmax = h - 4 * s;
      bool full = jmax >= 4;
      if (jmax > 4) jmax = 4;
      uint32_t* rowp = wp(s, 0);
      const uint32_t* morrow = mor + (size_t)s * w;
      const int32_t* r0 = vals + (size_t)4 * s * mstride;
      const int32_t* r1 = r0 + mstride;
      const int32_t* r2 = r1 + mstride;
      const int32_t* r3 = r2 + mstride;
      for (int x = 0; x < w; x++) {
        uint32_t f = rowp[x];
        if (full) {
          // fully-significant column: no row is CLN-codable; clear PI
          if ((f & CENTER_ALL) == CENTER_ALL) {
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          if (!(f & (clnm | PI_ALL))) {
            // run-length mode: none of the 4 rows has a sig neighbor
            if (!((morrow[x] >> bp) & 1)) {
              mq.encode_w(mv, crun, 0);
              continue;  // f has no PI/MU bits to clear
            }
            int first;
            if (((uint32_t)r0[x] >> bp) & 1) first = 0;
            else if (((uint32_t)r1[x] >> bp) & 1) first = 1;
            else if (((uint32_t)r2[x] >> bp) & 1) first = 2;
            else first = 3;
            mq.encode_w(mv, crun, 1);
            mq.encode_w(mv, cuni, (first >> 1) & 1);
            mq.encode_w(mv, cuni, first & 1);
            switch (first) {
              case 0:
                T1E_CLN_SIG(0, r0)
                T1E_CLN_ROW(1, r1)
                T1E_CLN_ROW(2, r2)
                T1E_CLN_ROW(3, r3)
                break;
              case 1:
                T1E_CLN_SIG(1, r1)
                T1E_CLN_ROW(2, r2)
                T1E_CLN_ROW(3, r3)
                break;
              case 2:
                T1E_CLN_SIG(2, r2)
                T1E_CLN_ROW(3, r3)
                break;
              default:
                T1E_CLN_SIG(3, r3)
                break;
            }
            rowp[x] = f & ~PI_ALL;
            continue;
          }
          T1E_CLN_ROW(0, r0)
          T1E_CLN_ROW(1, r1)
          T1E_CLN_ROW(2, r2)
          T1E_CLN_ROW(3, r3)
          rowp[x] = f & ~PI_ALL;
        } else {
          T1E_CLN_ROW(0, r0)
          if (jmax > 1) T1E_CLN_ROW(1, r1)
          if (jmax > 2) T1E_CLN_ROW(2, r2)
          rowp[x] = f & ~PI_ALL;
        }
      }
    }
    mq.ctxw[CTX_RUN] = crun;
    mq.ctxw[CTX_UNI] = cuni;
    mq.v = mv;
  }
};

}  // namespace

extern "C" {

// Style bit of an irreversible (9/7) block, above the part-1 mode
// switches and HT's 0x40: the decoder writes the mid-interval
// reconstruction with one fractional bit (the caller scales by step / 2).
constexpr int kMidpoint = 0x80;

// Decode one codeblock. data: single codeword segment (default style).
// num_bps: magnitude bitplanes present (Mb - zero_bitplanes).
// num_passes: coding passes included (first bitplane has cleanup only).
// out: signed reconstruction values (no dequant; caller applies) written as
// h rows of w at row stride `stride` elements: the decoded integer, or,
// under kMidpoint, twice the mid-interval value (at most 30 bit-planes).
// The written region must arrive zero-initialized (magnitude bits are
// OR-accumulated in place) — both bridges pass np.zeros / fresh band
// arrays.
// Pass index p (0 = first cleanup) is a RAW pass under BYPASS when
// p >= 10 and it is an SPP (p % 3 == 1) or MRP (p % 3 == 2) pass.
static inline bool pass_is_raw(int style, int p) {
  return (style & 0x01) && p >= 10 && (p % 3) != 0;
}

// A termination occurs AFTER pass p (i.e. pass p+1 starts a new codeword
// segment) under TERMALL always, and under BYPASS at every MQ<->raw
// switch: after the CLN preceding a raw SPP and after the raw MRP.
static inline bool terminated_after(int style, int p) {
  if (style & 0x04) return true;
  if (!(style & 0x01)) return false;
  return pass_is_raw(style, p) != pass_is_raw(style, p + 1);
}

int tic_j2k_t1_decode_strided_style(const uint8_t* data, int len, int w,
                                    int h, int64_t stride, int band,
                                    int num_bps, int num_passes,
                                    int32_t* out, int style) {
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096 || num_bps < 0 ||
      num_bps > ((style & kMidpoint) ? 30 : 31) || num_passes < 0 ||
      stride < w)
    return 1;
  // Reused across the batch fan-out. The coder lives on the heap behind one
  // thread-local pointer, looked up once a block: with the object itself in
  // global-dynamic TLS every t-relative access (mq.ctx inside the MQ decode
  // hot path included) would go through __tls_get_addr, and initial-exec
  // TLS of this size takes the static TLS block a dlopen'd library may not
  // get (it fails to load beside another library that took it).
  static thread_local std::unique_ptr<T1Decoder> tls;
  if (!tls) tls.reset(new T1Decoder());
  T1Decoder& t = *tls;
  t.reset(w, h, band, style);
  t.mstride = stride;
  t.mag = out;
  // multi-segment blocks (TERMALL/BYPASS): blob = [i32 nsegs][i32 lens..]
  // [data]; each segment boundary restarts the MQ (or raw) reader
  const uint8_t* segp[112];
  int seglen[112];
  int nsegs = 1;
  const uint8_t* d0 = data;
  int l0 = len;
  if (style & 0x05) {
    if (len < 4) return 1;
    int32_t ns;
    memcpy(&ns, data, 4);
    if (ns < 1 || ns > 112 || len < 4 + 4 * ns) return 1;
    nsegs = ns;
    const uint8_t* p = data + 4 + 4 * ns;
    int64_t remain = len - 4 - 4 * ns;
    for (int i = 0; i < nsegs; i++) {
      int32_t sl;
      memcpy(&sl, data + 4 + 4 * i, 4);
      if (sl < 0 || sl > remain) return 1;
      segp[i] = p;
      seglen[i] = sl;
      p += sl;
      remain -= sl;
    }
    d0 = segp[0];
    l0 = seglen[0];
  }
  int seg = 0;
  t.mq.init(d0, l0);
  RawReader raw;
  const bool segsym = (style & 0x20) != 0;
  const bool ctxreset = (style & 0x02) != 0;
  int pass = 0;
  bool cur_raw = false;
  auto advance = [&](int p) {
    // called after pass p completed
    if (ctxreset) t.mq.reset_ctx();
    if ((style & 0x05) && terminated_after(style, p) &&
        pass < num_passes && seg + 1 < nsegs) {
      seg++;
      if (pass_is_raw(style, p + 1)) {
        raw.init(segp[seg], seglen[seg]);
        cur_raw = true;
      } else {
        t.mq.init_keep_ctx(segp[seg], seglen[seg]);
        cur_raw = false;
      }
    }
  };
  for (int bp = num_bps - 1; bp >= 0 && pass < num_passes; bp--) {
    if (bp == num_bps - 1) {
      t.cleanup_pass(bp);
      if (segsym) t.read_segsym();
      pass++;
      advance(pass - 1);
    } else {
      if (pass < num_passes) {
        if (cur_raw) t.sig_prop_pass_raw(bp, raw);
        else t.sig_prop_pass(bp);
        pass++;
        advance(pass - 1);
      }
      if (pass < num_passes) {
        if (cur_raw) t.mag_ref_pass_raw(bp, raw);
        else t.mag_ref_pass(bp);
        pass++;
        advance(pass - 1);
      }
      if (pass < num_passes) {
        t.cleanup_pass(bp);
        if (segsym) t.read_segsym();
        pass++;
        advance(pass - 1);
      }
    }
  }
  if ((style & kMidpoint) && pass > 0) {
    // Each coefficient at the middle of the interval its decoded
    // bit-planes leave (T.800 E.1.1.2, r = 1/2), with one fractional bit:
    // 2|q| + 2^L, L the lowest plane decoded for it. The last pass decides
    // L: a cleanup or a refinement pass reached every significant
    // coefficient at its plane; a significance pass only those it made
    // significant (below 2^(plane+1)), the others end a plane higher.
    const int last = pass - 1;
    const int plane = last == 0 ? num_bps - 1 : num_bps - 2 - (last - 1) / 3;
    const bool spp = last > 0 && (last - 1) % 3 == 0;
    const uint32_t thr = spp ? 1u << (plane + 1) : 0xFFFFFFFFu;
    const uint32_t lo = 1u << plane;
    const uint32_t hi = spp ? 1u << (plane + 1) : lo;
    for (int y = 0; y < h; y++) {
      int32_t* row = out + (size_t)y * stride;
      for (int x = 0; x < w; x++) {
        int32_t v = row[x];
        uint32_t mag = (uint32_t)v & 0x7FFFFFFFu;
        uint32_t r = mag ? 2 * mag + (mag >= thr ? hi : lo) : 0;
        int32_t m = v >> 31;
        row[x] = ((int32_t)r ^ m) - m;
      }
    }
    return 0;
  }
  // sign-magnitude (sign in bit 31, set at significance time) → two's
  // complement; branchless, auto-vectorizes
  for (int y = 0; y < h; y++) {
    int32_t* row = out + (size_t)y * stride;
    for (int x = 0; x < w; x++) {
      int32_t v = row[x];
      int32_t m = v >> 31;  // all-ones if negative
      row[x] = ((v & 0x7FFFFFFF) ^ m) - m;
    }
  }
  return 0;
}

int tic_j2k_t1_decode_strided(const uint8_t* data, int len, int w, int h,
                              int64_t stride, int band, int num_bps,
                              int num_passes, int32_t* out) {
  return tic_j2k_t1_decode_strided_style(data, len, w, h, stride, band,
                                         num_bps, num_passes, out, 0);
}

// contiguous-output compatibility wrapper (stride == w)
int tic_j2k_t1_decode(const uint8_t* data, int len, int w, int h, int band,
                      int num_bps, int num_passes, int32_t* out) {
  return tic_j2k_t1_decode_strided(data, len, w, h, w, band, num_bps,
                                   num_passes, out);
}

// Encode one codeblock from signed int32 coefficients. Returns the number
// of magnitude bitplanes used via *num_bps and passes via *num_passes;
// caller provides out buffer of cap bytes, gets *outlen written.
// min_bps: force at least this many coded magnitude bitplanes (leading
// all-zero planes become cheap RL cleanup passes). Decoders that bound the
// signaled zero-bitplanes by the band's nominal Mb (openjpeg with RGN)
// need background blocks to keep zbps < Mb.
int tic_j2k_t1_encode_seg(const int32_t* in, int w, int h, int band,
                          uint8_t* out_buf, int cap, int* outlen,
                          int* num_bps, int* num_passes, int min_bps,
                          int style, int* seg_ends, int* nsegs_out) {
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  static thread_local std::unique_ptr<T1EncoderFast> tls;  // as the decoder's
  if (!tls) tls.reset(new T1EncoderFast());
  T1EncoderFast& t = *tls;
  static thread_local std::vector<int32_t> sm;  // sign-magnitude plane
  static thread_local std::vector<uint32_t> morv;  // stripe-column |v| OR
  t.reset(w, h, band, style);
  sm.resize((size_t)w * h);
  int S = (h + 3) >> 2;
  morv.assign((size_t)S * w, 0);
  // OR of magnitudes shares its top bit with the max — the whole setup
  // loop is branch-free and auto-vectorizes (row-major mor indexing)
  uint32_t magor = 0;
  for (int y = 0; y < h; y++) {
    const int32_t* row = in + (size_t)y * w;
    int32_t* smrow = sm.data() + (size_t)y * w;
    uint32_t* mrow = morv.data() + (size_t)(y >> 2) * w;
    for (int x = 0; x < w; x++) {
      int32_t v = row[x];
      int32_t neg = (int32_t)((uint32_t)v >> 31);
      int32_t m = (v ^ -neg) + neg;  // |v| branchless
      smrow[x] = m | (neg << 31);
      mrow[x] |= (uint32_t)m;
      magor |= (uint32_t)m;
    }
  }
  int32_t maxmag = (int32_t)magor;
  t.mor = morv.data();
  int nbps = 0;
  while ((1 << nbps) <= maxmag) nbps++;
  if (nbps == 0) {
    *num_bps = 0;
    *num_passes = 0;
    *outlen = 0;
    return 0;
  }
  if (nbps < min_bps && min_bps <= 30) nbps = min_bps;
  *num_bps = nbps;
  t.vals = sm.data();
  t.mstride = w;
  t.mq.init();
  t.mq.out.clear();
  const bool segsym = (style & 0x20) != 0;
  const bool ctxreset = (style & 0x02) != 0;
  const bool multiseg = (style & 0x05) != 0;
  int total = (nbps - 1) * 3 + 1;
  RawWriter rw;
  int pass = 0;
  int ns = 0;
  auto endpass = [&](bool was_raw) {
    if (ctxreset) t.reset_ctx();
    if (multiseg && pass < total && terminated_after(style, pass - 1)) {
      if (was_raw) rw.flush();
      else t.mq.flush();
      if (seg_ends && ns < 112) seg_ends[ns++] = (int)t.mq.out.size();
      if (pass_is_raw(style, pass)) rw.start(&t.mq.out);
      else t.mq.restart_keep_ctx();
    }
  };
  for (int bp = nbps - 1; bp >= 0; bp--) {
    if (bp == nbps - 1) {
      t.cleanup_pass(bp);
      if (segsym) t.write_segsym();
      pass++;
      endpass(false);
    } else {
      if (pass_is_raw(style, pass)) t.sig_prop_pass_raw(bp, rw);
      else t.sig_prop_pass(bp);
      bool wr = pass_is_raw(style, pass);
      pass++;
      endpass(wr);
      if (pass_is_raw(style, pass)) t.mag_ref_pass_raw(bp, rw);
      else t.mag_ref_pass(bp);
      wr = pass_is_raw(style, pass);
      pass++;
      endpass(wr);
      t.cleanup_pass(bp);
      if (segsym) t.write_segsym();
      pass++;
      endpass(false);
    }
  }
  if (multiseg && pass_is_raw(style, pass - 1)) rw.flush();
  else t.mq.flush();
  if (multiseg) {
    if (!pass_is_raw(style, pass - 1)) { /* flushed above */ }
    if (seg_ends && ns < 112) seg_ends[ns++] = (int)t.mq.out.size();
    if (nsegs_out) *nsegs_out = ns;
  } else if (nsegs_out) {
    *nsegs_out = 1;
  }
  *num_passes = pass;
  if ((int)t.mq.out.size() > cap) return 2;
  std::memcpy(out_buf, t.mq.out.data(), t.mq.out.size());
  *outlen = (int)t.mq.out.size();
  return 0;
}

int tic_j2k_t1_encode(const int32_t* in, int w, int h, int band,
                      uint8_t* out_buf, int cap, int* outlen, int* num_bps,
                      int* num_passes, int min_bps, int style) {
  return tic_j2k_t1_encode_seg(in, w, h, band, out_buf, cap, outlen,
                               num_bps, num_passes, min_bps, style,
                               nullptr, nullptr);
}

}  // extern "C"
