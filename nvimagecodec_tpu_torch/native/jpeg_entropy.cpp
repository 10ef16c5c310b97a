// JPEG Huffman entropy decode — native host stage.
//
// Counterpart of the CPU Huffman host stage in the reference's
// hybrid decoder (extensions/nvjpeg/cuda_decoder.cpp:412-563:
// nvjpegDecodeJpegHost runs CPU Huffman before the GPU pixel stage). Entropy
// coding is bit-serial and branchy, so the host route runs it here at
// native speed and ships quantized coefficient blocks to the GPU.
//
// Semantics are validated bit-exact against both the pure-Python reference
// decoder (entropy_py.py) and libjpeg's jpeg_read_coefficients.
//
// From-scratch implementation of ITU-T T.81 §F (sequential) and §G
// (progressive) entropy decoding. No reference code used.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// zigzag index -> natural position
static const uint8_t kNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  // two-level decode: 9-bit lookahead LUT, then canonical slow path
  int16_t lut_sym[512];
  int8_t lut_len[512];
  // fused skip LUT for the index walk's AC loop: one lookup yields the
  // total bits to consume (code + value) and the coefficient advance.
  // bits 0-5 skip, 6-12 advance (r+1, or 16 for ZRL), 14 valid, 15 EOB
  uint16_t lut_skip[512];
  int32_t maxcode[18];   // largest code of length l (as left-justified compare)
  int32_t valptr[18];    // index into values[] of first code of length l
  int32_t mincode[18];
  uint8_t values[256];
  bool valid = false;
  uint64_t def_key = 0;  // FNV-1a of the DHT definition (pair-LUT cache key)
  // fused MULTI-unit LUT over a 16-bit window (index walk hot loop): as
  // many whole (code+value) units as fit in 16 bits consumed per lookup.
  // Entry: 0x8000 valid | 0x4000 EOB-terminal | kadv<<5 | total_bits.
  // Shared via a process-global cache keyed by def_key — the (usually
  // libjpeg-standard) tables build once per process, not per image.
  const uint16_t* pair = nullptr;
  std::shared_ptr<std::vector<uint16_t>> pair_hold;

  bool build(const uint8_t bits[16], const uint8_t* vals, int nvals) {
    valid = false;
    if (nvals > 256) return false;
    memcpy(values, vals, nvals);
    {
      uint64_t h = 1469598103934665603ull;
      for (int i = 0; i < 16; i++) h = (h ^ bits[i]) * 1099511628211ull;
      for (int i = 0; i < nvals; i++) h = (h ^ vals[i]) * 1099511628211ull;
      def_key = h;
      pair = nullptr;
      pair_hold.reset();
    }
    int code = 0, k = 0;
    int codes[256], lens[256];
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; i++) {
        codes[k] = code;
        lens[k] = l;
        code++;
        k++;
      }
      // canonical codes of length l must fit in l bits; a malformed DHT
      // (e.g. bits[1]=255) would otherwise push LUT bases past 512
      if (code > (1 << l)) return false;
      maxcode[l] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < 512; i++) {
      lut_sym[i] = -1;
      lut_len[i] = 0;
      lut_skip[i] = 0;
    }
    for (int i = 0; i < k; i++) {
      if (lens[i] <= 9) {
        int base = codes[i] << (9 - lens[i]);
        int span = 1 << (9 - lens[i]);
        int sym = values[i];
        int r = sym >> 4, sz = sym & 15;
        uint16_t e;
        if (sz > 0)
          e = (uint16_t)((lens[i] + sz) | ((r + 1) << 6) | 0x4000);
        else if (r == 15)
          e = (uint16_t)(lens[i] | (16 << 6) | 0x4000);  // ZRL
        else
          e = (uint16_t)(lens[i] | 0x4000 | 0x8000);  // EOB
        for (int j = 0; j < span; j++) {
          lut_sym[base + j] = values[i];
          lut_len[base + j] = (int8_t)lens[i];
          lut_skip[base + j] = e;
        }
      }
    }
    valid = true;
    return true;
  }
};

// Process-global cache of pair LUTs (see HuffTable.pair). A handful of
// distinct AC tables exist across any realistic corpus; the 128 KiB build
// happens once per distinct table instead of once per image.
struct PairLutCache {
  std::mutex mu;
  std::vector<std::pair<uint64_t, std::shared_ptr<std::vector<uint16_t>>>>
      ents;
};
static PairLutCache g_pair_cache;

static std::shared_ptr<std::vector<uint16_t>> build_pair_lut(
    const HuffTable& t) {
  auto lut = std::make_shared<std::vector<uint16_t>>(65536, 0);
  uint16_t* e = lut->data();
  for (uint32_t w = 0; w < 65536; w++) {
    int consumed = 0, kadv = 0, units = 0;
    bool terminal = false;
    for (;;) {
      int rem = 16 - consumed;
      if (rem < 9) break;  // code length unknown beyond the window
      int c9 = (int)((w >> (rem - 9)) & 0x1FF);
      int len = t.lut_len[c9];
      if (!len || len > rem) break;
      int sym = t.lut_sym[c9];
      int r = sym >> 4, sz = sym & 15;
      if (sz == 0) {
        if (r == 15) {  // ZRL
          consumed += len;
          kadv += 16;
          units++;
          if (kadv > 64) break;
          continue;
        }
        consumed += len;  // EOB: block ends, next bits are another table's
        units++;
        terminal = true;
        break;
      }
      if (len + sz > rem) break;
      consumed += len + sz;
      kadv += r + 1;
      units++;
      if (kadv > 64) break;
    }
    if (units)
      e[w] = (uint16_t)(0x8000u | (terminal ? 0x4000u : 0) |
                        ((uint32_t)kadv << 5) | (uint32_t)consumed);
  }
  return lut;
}

static void attach_pair_lut(HuffTable& t) {
  if (t.pair || !t.valid) return;
  std::lock_guard<std::mutex> g(g_pair_cache.mu);
  for (auto& kv : g_pair_cache.ents)
    if (kv.first == t.def_key) {
      t.pair_hold = kv.second;
      t.pair = kv.second->data();
      return;
    }
  auto lut = build_pair_lut(t);
  if (g_pair_cache.ents.size() > 16) g_pair_cache.ents.clear();
  g_pair_cache.ents.emplace_back(t.def_key, lut);
  t.pair_hold = lut;
  t.pair = lut->data();
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  const uint8_t* marker = nullptr;  // position of 0xFF of a seen marker

  void init(const uint8_t* start, const uint8_t* stop) {
    p = start;
    end = stop;
    acc = 0;
    nbits = 0;
    marker = nullptr;
  }

  inline void refill() {
    // fast path: next 8 bytes contain no 0xFF (no stuffing, no marker) —
    // load them in one shot (libjpeg-turbo-style amortized refill)
    if (!marker && p + 8 <= end) {
      uint64_t v;
      memcpy(&v, p, 8);
      uint64_t nx = ~v;  // has a 0x00 byte iff v has a 0xFF byte
      if (!((nx - 0x0101010101010101ULL) & ~nx & 0x8080808080808080ULL)) {
        int k = (64 - nbits) >> 3;  // bytes that fit
        uint64_t be = __builtin_bswap64(v);
        if (k == 8)
          acc = be;
        else
          acc = (acc << (8 * k)) | (be >> (64 - 8 * k));
        p += k;
        nbits += 8 * k;
        return;
      }
    }
    while (nbits <= 56) {
      uint8_t b = 0;
      if (p < end && !marker) {
        b = *p;
        if (b == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;  // stuffed
          } else {
            marker = p;  // stop consuming; pad zeros
            b = 0;
          }
        } else {
          p++;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline int peek9() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 9)) & 0x1FF);
  }

  inline void skip(int k) { nbits -= k; }

  inline int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) refill();
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }

  inline int get_bit() { return get_bits(1); }

  inline int peek16() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 16)) & 0xFFFF);
  }
};

// Destuffed-stream bit reader for the index scan: the scan bytes were
// already destuffed, so refills are pure loads (no 0xFF checks) and the
// absolute bit position is exact (consumed counts synthetic zero padding
// past the physical end, keeping positions consistent with the device
// kernel's own zero padding).
struct DBitReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t consumed = 0;  // bytes shifted into acc (incl. zero padding)
  uint64_t acc = 0;
  int nbits = 0;

  void init(const uint8_t* start, const uint8_t* stop) {
    p = start;
    end = stop;
    consumed = 0;
    acc = 0;
    nbits = 0;
  }

  inline int64_t bitpos() const { return consumed * 8 - nbits; }

  inline void refill() {
    if (p + 8 <= end) {
      uint64_t v;
      memcpy(&v, p, 8);
      int k = (64 - nbits) >> 3;
      uint64_t be = __builtin_bswap64(v);
      acc = (k == 8) ? be : ((acc << (8 * k)) | (be >> (64 - 8 * k)));
      p += k;
      consumed += k;
      nbits += 8 * k;
      return;
    }
    while (nbits <= 56) {
      uint8_t b = p < end ? *p++ : 0;
      acc = (acc << 8) | b;
      consumed++;
      nbits += 8;
    }
  }

  inline int peek9() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 9)) & 0x1FF);
  }

  inline int peek16() {
    if (nbits < 16) refill();
    return (int)((acc >> (nbits - 16)) & 0xFFFF);
  }

  inline void skip(int k) { nbits -= k; }

  inline int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) refill();
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }

  inline void skip_bits(int k) {
    if (k == 0) return;
    if (nbits < k) refill();
    nbits -= k;
  }

  // one refill covers a whole Huffman symbol + its value bits (<= 16 + 15)
  inline void ensure31() {
    if (nbits < 31) refill();
  }
  inline int peek9_nc() const {
    return (int)((acc >> (nbits - 9)) & 0x1FF);
  }
  inline int peek16_nc() const {
    return (int)((acc >> (nbits - 16)) & 0xFFFF);
  }
  inline int take_nc(int k) {  // k <= current nbits, no refill
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }
};

template <class BR>
inline int decode_huff(BR& br, const HuffTable& t) {
  int idx = br.peek9();
  int len = t.lut_len[idx];
  if (len) {
    br.skip(len);
    return t.lut_sym[idx];
  }
  // slow path: canonical decode beyond 9 bits
  int code = br.peek16();
  for (int l = 10; l <= 16; l++) {
    int c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.values[t.valptr[l] + (c - t.mincode[l])];
    }
  }
  return -1;  // invalid
}

inline int extend(int v, int t) {
  if (t == 0) return 0;
  return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int16_t* coef = nullptr;  // [bh][bw][64] (natural order)
  int bw = 0, bh = 0;       // MCU-padded block dims
  int true_bw = 0, true_bh = 0;
};

struct Scan {
  int ncomp;
  int comp_idx[4];
  int dc_tbl[4], ac_tbl[4];
  int ss, se, ah, al;
  const uint8_t* data_start;
  const uint8_t* data_end;
  HuffTable dc[4], ac[4];
  int restart_interval;
};

struct Decoder {
  const uint8_t* base;
  size_t len;
  // optional caller-provided coefficient buffers (batch preallocation path);
  // must match the parsed MCU-padded geometry
  int16_t* ext_coef[4] = {nullptr, nullptr, nullptr, nullptr};
  const int32_t* ext_bw = nullptr;
  const int32_t* ext_bh = nullptr;
  int ext_ncomp = 0;
  int width = 0, height = 0, precision = 0, ncomp = 0;
  int sof_marker = 0;
  Component comps[4];
  HuffTable dc_tbl[4], ac_tbl[4];
  int restart_interval = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  bool progressive = false;
  int error = 0;

  // ROI decode: only MCU rows [roi_y0, roi_y1) are materialized. Rows below
  // roi_y1 end the scan early (the parser re-syncs at the next marker found
  // by byte scan); rows above roi_y0 are entropy-decoded for DC-predictor /
  // bit-position tracking only (no coefficient writes), and on
  // restart-interval streams whole pre-ROI segments are skipped by marker
  // scan with no entropy work at all (reference analog: nvjpeg ROI decode,
  // extensions/nvjpeg/cuda_decoder.cpp:460-520).
  long roi_y0 = 0;
  long roi_y1 = 0x7FFFFFFFL;

  // index-scan mode (on-device entropy path): instead of decoding
  // coefficients, destuff the scan and record, every index_rows MCU rows,
  // the destuffed bit offset + running DC predictors — the per-lane seeds
  // that let the Huffman kernel decode MCU-row segments in parallel on
  // streams WITHOUT restart markers.
  int index_rows = 0;
  uint8_t* index_dst = nullptr;
  int64_t index_cap = 0;
  int64_t index_dlen = 0;
  int64_t* index_bits = nullptr;
  int32_t* index_preds = nullptr;
  int32_t index_max_segs = 0;
  int index_nsegs = -1;

  bool parse_and_decode();
  void decode_scan(Scan& s);
  void sequential_scan(Scan& s);
  void progressive_scan(Scan& s);
  void index_scan(Scan& s);
};

static inline uint16_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

bool Decoder::parse_and_decode() {
  const uint8_t* p = base;
  const uint8_t* end = base + len;
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return false;
  p += 2;
  bool have_sof = false;

  while (p + 2 <= end) {
    if (p[0] != 0xFF) {
      p++;
      continue;
    }
    uint8_t m = p[1];
    if (m == 0xFF) {
      p++;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) {
      p += 2;
      continue;
    }
    if (m == 0xD9) break;  // EOI
    if (p + 4 > end) break;
    int seglen = be16(p + 2);
    const uint8_t* seg = p + 4;
    const uint8_t* segend = p + 2 + seglen;
    if (segend > end) return false;

    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: {
        sof_marker = m;
        progressive = (m == 0xC2);
        precision = seg[0];
        height = be16(seg + 1);
        width = be16(seg + 3);
        ncomp = seg[5];
        if (ncomp > 4 || (precision != 8 && precision != 12)) return false;
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; c++) {
          comps[c].id = seg[6 + 3 * c];
          comps[c].h = seg[7 + 3 * c] >> 4;
          comps[c].v = seg[7 + 3 * c] & 15;
          comps[c].tq = seg[8 + 3 * c];
          if (comps[c].h < 1 || comps[c].v < 1) return false;
          if (comps[c].h > hmax) hmax = comps[c].h;
          if (comps[c].v > vmax) vmax = comps[c].v;
        }
        mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
        mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; c++) {
          Component& cc = comps[c];
          cc.bw = mcus_x * cc.h;
          cc.bh = mcus_y * cc.v;
          int tw = (width * cc.h + hmax - 1) / hmax;
          int th = (height * cc.v + vmax - 1) / vmax;
          cc.true_bw = (tw + 7) / 8;
          cc.true_bh = (th + 7) / 8;
          if (ext_coef[0]) {
            if (c >= ext_ncomp || cc.bw != ext_bw[c] || cc.bh != ext_bh[c])
              return false;  // geometry mismatch with preallocated batch slot
            cc.coef = ext_coef[c];
            memset(cc.coef, 0, (size_t)cc.bw * cc.bh * 64 * sizeof(int16_t));
          } else {
            cc.coef = (int16_t*)calloc((size_t)cc.bw * cc.bh * 64, sizeof(int16_t));
            if (!cc.coef) return false;
          }
        }
        have_sof = true;
        break;
      }
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return false;  // unsupported SOF type here (lossless/arith/diff)
      case 0xC4: {  // DHT
        const uint8_t* q = seg;
        while (q + 17 <= segend) {
          int tc = q[0] >> 4, th = q[0] & 15;
          if (th > 3) return false;
          uint8_t bits[16];
          int nv = 0;
          for (int i = 0; i < 16; i++) {
            bits[i] = q[1 + i];
            nv += bits[i];
          }
          if (q + 17 + nv > segend || nv > 256) return false;
          if (tc == 0) {
            if (!dc_tbl[th].build(bits, q + 17, nv)) return false;
          } else {
            if (!ac_tbl[th].build(bits, q + 17, nv)) return false;
          }
          q += 17 + nv;
        }
        break;
      }
      case 0xDD:  // DRI
        restart_interval = be16(seg);
        break;
      case 0xDA: {  // SOS
        if (!have_sof) return false;
        Scan s;
        s.ncomp = seg[0];
        // bounds: a corrupted SOS must fail cleanly, not index out of
        // range (ss/se drive kNat[] indexing; table ids index [4] arrays)
        if (s.ncomp < 1 || s.ncomp > 4) return false;
        if (seg + 4 + 2 * s.ncomp > segend) return false;
        for (int j = 0; j < s.ncomp; j++) {
          int cid = seg[1 + 2 * j];
          int tt = seg[2 + 2 * j];
          if ((tt >> 4) > 3 || (tt & 15) > 3) return false;
          int idx = -1;
          for (int c = 0; c < ncomp; c++)
            if (comps[c].id == cid) idx = c;
          if (idx < 0) return false;
          s.comp_idx[j] = idx;
          s.dc_tbl[j] = tt >> 4;
          s.ac_tbl[j] = tt & 15;
          s.dc[j] = dc_tbl[tt >> 4];
          s.ac[j] = ac_tbl[tt & 15];
        }
        // every table a scan will actually consult must have been defined
        // (an undefined HuffTable holds uninitialized LUT memory)
        for (int j = 0; j < s.ncomp; j++) {
          bool need_dc = (seg[1 + 2 * s.ncomp] == 0) &&
                         ((seg[3 + 2 * s.ncomp] >> 4) == 0);
          bool need_ac = seg[2 + 2 * s.ncomp] > 0;
          if (need_dc && !s.dc[j].valid) return false;
          if (need_ac && !s.ac[j].valid) return false;
        }
        s.ss = seg[1 + 2 * s.ncomp];
        s.se = seg[2 + 2 * s.ncomp];
        int ahal = seg[3 + 2 * s.ncomp];
        s.ah = ahal >> 4;
        s.al = ahal & 15;
        if (s.ss > 63 || s.se > 63 || s.ss > s.se) return false;
        if (progressive) {
          // T.81 G.1: DC scans are (0,0); AC scans exclude coefficient 0
          if (s.ss == 0 && s.se != 0) return false;
          if (s.ss > 0 && s.ncomp != 1) return false;
          if (s.al > 13 || s.ah > 13) return false;
        } else {
          if (s.ss != 0 || s.se != 63) return false;
        }
        s.restart_interval = restart_interval;
        s.data_start = segend;
        // find end: next marker that is not RST/stuffing
        const uint8_t* q = segend;
        while (q + 1 < end) {
          if (q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7))
            break;
          q++;
        }
        s.data_end = q;
        decode_scan(s);
        if (error) return false;
        p = q;
        continue;
      }
      default:
        break;
    }
    p += 2 + seglen;
  }
  return have_sof && error == 0;
}

void Decoder::decode_scan(Scan& s) {
  if (index_rows > 0) {
    index_scan(s);
    return;
  }
  if (progressive)
    progressive_scan(s);
  else
    sequential_scan(s);
}

// Destuff + light Huffman pass: no coefficient writes, value bits skipped,
// only DC predictors tracked. Sets index_nsegs / index_dlen, or error:
// 1 = malformed entropy data, -2 = max_segs capacity, -3 = stream shape
// outside the on-device kernel's support (caller routes to host decode).
// one block of the light Huffman pass: DC decoded into pred (predictors
// seed the device kernel), AC value bits skipped. Inlined into both the
// solo walk and the 2-stream interleaved walk.
static inline void idx_block(DBitReader& br, const HuffTable& dct,
                             const HuffTable& act, int& pred, int& error) {
  // ensure31 covers code (<=16) + value bits (<=15) in one check
  br.ensure31();
  int idx = br.peek9_nc();
  int t, len = dct.lut_len[idx];
  if (len) {
    t = dct.lut_sym[idx];
    br.nbits -= len;
  } else {
    int code = br.peek16_nc();
    t = -1;
    for (int l = 10; l <= 16; l++) {
      int cd = code >> (16 - l);
      if (cd <= dct.maxcode[l]) {
        br.nbits -= l;
        t = dct.values[dct.valptr[l] + (cd - dct.mincode[l])];
        break;
      }
    }
  }
  if (t < 0 || t > 15) { error = 1; return; }
  pred += extend(br.take_nc(t), t);
  int k = 1;
  const uint16_t* pl = act.pair;
  while (k < 64) {
    br.ensure31();
    if (pl) {
      // multi-unit fused path: every whole (code+value) unit inside the
      // 16-bit window consumed in ONE lookup (typically 2-3 units at
      // photographic qualities); falls through near the block end or on
      // long codes, where the unit-wise paths keep exact error checks
      uint32_t e2 = pl[br.peek16_nc()];
      int ka = (int)((e2 >> 5) & 0x7F);
      if ((e2 & 0x8000u) && k + ka <= 64) {
        br.nbits -= (int)(e2 & 31u);
        k += ka;
        if (e2 & 0x4000u) break;  // ended on EOB
        continue;
      }
    }
    uint32_t e = act.lut_skip[br.peek9_nc()];
    if (e & 0x4000u) {
      // fused fast path: code + value bits consumed in one step
      br.nbits -= (int)(e & 63u);
      if (e & 0x8000u) break;  // EOB
      k += (int)((e >> 6) & 0x7Fu);
      if (k > 64) { error = 1; return; }
    } else {
      int code = br.peek16_nc();
      int sym = -1;
      for (int l = 10; l <= 16; l++) {
        int cd = code >> (16 - l);
        if (cd <= act.maxcode[l]) {
          br.nbits -= l;
          sym = act.values[act.valptr[l] + (cd - act.mincode[l])];
          break;
        }
      }
      if (sym < 0) { error = 1; return; }
      int r = sym >> 4, sz = sym & 15;
      if (sz == 0) {
        if (r == 15) { k += 16; continue; }
        break;
      }
      k += r;
      if (k > 63) { error = 1; return; }
      br.nbits -= sz;  // value bits: covered by ensure31
      k++;
    }
  }
}

// prepared index scan: destuffed stream + the scan it belongs to (the walk
// runs either solo or interleaved with a second image's walk)
struct IdxCursor {
  const Scan* s = nullptr;
  Decoder* d = nullptr;

  bool prepare(Decoder& dec, Scan& sc) {
    d = &dec;
    s = &sc;
    // destuff the scan (memcpy runs between 0xFF bytes)
    const uint8_t* p = sc.data_start;
    const uint8_t* end = sc.data_end;
    int64_t n = 0;
    while (p < end) {
      const uint8_t* ff = (const uint8_t*)memchr(p, 0xFF, (size_t)(end - p));
      const uint8_t* run_end = ff ? ff : end;
      int64_t run = run_end - p;
      if (n + run > dec.index_cap) { dec.error = -2; return false; }
      memcpy(dec.index_dst + n, p, (size_t)run);
      n += run;
      if (!ff) break;
      if (ff + 1 < end && ff[1] == 0x00) {
        if (n + 1 > dec.index_cap) { dec.error = -2; return false; }
        dec.index_dst[n++] = 0xFF;
        p = ff + 2;
      } else {
        break;  // marker terminates the scan
      }
    }
    dec.index_dlen = n;
    return true;
  }
};

// solo walk: local bit reader + tight loops (state stays in registers)
static void idx_walk_solo(Decoder& d, const Scan& s) {
  DBitReader br;
  br.init(d.index_dst, d.index_dst + d.index_dlen);
  int pred[4] = {0, 0, 0, 0};
  int nseg = 0;
  for (long my = 0; my < d.mcus_y; my++) {
    if (my % d.index_rows == 0) {
      if (nseg >= d.index_max_segs) { d.error = -2; return; }
      d.index_bits[nseg] = br.bitpos();
      for (int j = 0; j < 4; j++) d.index_preds[nseg * 4 + j] = pred[j];
      nseg++;
    }
    for (long mx = 0; mx < d.mcus_x; mx++) {
      for (int j = 0; j < s.ncomp; j++) {
        int nb = d.comps[s.comp_idx[j]].h * d.comps[s.comp_idx[j]].v;
        for (int b = 0; b < nb; b++) {
          idx_block(br, s.dc[j], s.ac[j], pred[j], d.error);
          if (d.error) return;
        }
      }
    }
  }
  d.index_nsegs = nseg;
}

void Decoder::index_scan(Scan& s) {
  if (progressive || s.restart_interval > 0 || index_nsegs >= 0 ||
      s.ncomp != ncomp) {
    error = -3;  // multi-scan / progressive / DRI (DRI has its own split)
    return;
  }
  for (int j = 0; j < s.ncomp; j++) attach_pair_lut(s.ac[j]);
  IdxCursor cur;
  if (!cur.prepare(*this, s)) return;
  idx_walk_solo(*this, s);
}

// Advance past an RST marker between restart segments.
static const uint8_t* skip_restart(const uint8_t* from, const uint8_t* end) {
  const uint8_t* q = from;
  while (q + 1 < end) {
    if (q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7) return q + 2;
    q++;
  }
  return end;
}

void Decoder::sequential_scan(Scan& s) {
  int smx, smy;
  bool interleaved = s.ncomp > 1;
  if (interleaved) {
    smx = mcus_x;
    smy = mcus_y;
  } else {
    Component& c = comps[s.comp_idx[0]];
    smx = c.true_bw;
    smy = c.true_bh;
  }
  long total = (long)smx * smy;
  long ri = s.restart_interval ? s.restart_interval : total;

  // ROI bounds in this scan's row unit (MCU rows when interleaved, component
  // block rows otherwise)
  long rv = interleaved ? 1 : comps[s.comp_idx[0]].v;
  long ry0 = roi_y0 * rv;
  long ry1 = (roi_y1 >= (long)mcus_y) ? (long)smy : roi_y1 * rv;

  BitReader br;
  br.init(s.data_start, s.data_end);
  int pred[4] = {0, 0, 0, 0};
  long mcu = 0;
  if (s.restart_interval && ry0 > 0) {
    // Skip whole restart segments strictly before the ROI: no entropy work,
    // just RST-marker scans; predictors reset at each restart anyway.
    long nskip = (ry0 * smx) / ri;
    if (nskip > 0) {
      const uint8_t* q = s.data_start;
      for (long i = 0; i < nskip && q < s.data_end; i++)
        q = skip_restart(q, s.data_end);
      br.init(q, s.data_end);
      mcu = nskip * ri;
    }
  }
  while (mcu < total) {
    long seg_end = mcu + ri < total ? mcu + ri : total;
    long my = mcu / smx, mx = mcu % smx;
    if (my >= ry1) return;  // everything below the ROI: skip the rest
    for (; mcu < seg_end; mcu++, (++mx == smx ? (mx = 0, ++my) : 0L)) {
      if (my >= ry1) return;
      const bool wr = my >= ry0;  // pre-ROI rows: track, don't materialize
      for (int j = 0; j < s.ncomp; j++) {
        Component& c = comps[s.comp_idx[j]];
        const HuffTable& dct = s.dc[j];
        const HuffTable& act = s.ac[j];
        int nby = interleaved ? c.v : 1;
        int nbx = interleaved ? c.h : 1;
        for (int by = 0; by < nby; by++) {
          for (int bx = 0; bx < nbx; bx++) {
            long row = interleaved ? my * c.v + by : my;
            long col = interleaved ? mx * c.h + bx : mx;
            long bidx = row * c.bw + col;
            int t = decode_huff(br, dct);
            // DC magnitude category is at most 15 (12-bit mode); a larger
            // table byte would drive get_bits into UB shifts
            if (t < 0 || t > 15) { error = 1; return; }
            pred[j] += extend(br.get_bits(t), t);
            int16_t* block = c.coef + bidx * 64;
            if (wr) block[0] = (int16_t)pred[j];
            int k = 1;
            while (k < 64) {
              int sym = decode_huff(br, act);
              if (sym < 0) { error = 1; return; }
              int r = sym >> 4, sz = sym & 15;
              if (sz == 0) {
                if (r == 15) { k += 16; continue; }
                break;
              }
              k += r;
              if (k > 63) { error = 1; return; }
              int v = extend(br.get_bits(sz), sz);
              if (wr) block[kNat[k]] = (int16_t)v;
              k++;
            }
          }
        }
      }
    }
    if (mcu < total) {
      // restart: realign to next RST marker
      const uint8_t* next = br.marker ? br.marker : br.p;
      br.init(skip_restart(next, s.data_end), s.data_end);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
  }
}

void Decoder::progressive_scan(Scan& s) {
  bool is_dc = (s.ss == 0);
  int smx, smy;
  bool interleaved = s.ncomp > 1;
  if (interleaved) {
    smx = mcus_x;
    smy = mcus_y;
  } else {
    Component& c = comps[s.comp_idx[0]];
    smx = c.true_bw;
    smy = c.true_bh;
  }
  long total = (long)smx * smy;
  long ri = s.restart_interval ? s.restart_interval : total;

  // ROI: early-exit below the ROI in EVERY scan (the parser re-syncs at the
  // next marker); rows above it must still be fully decoded *and written*
  // because AC-refinement passes read the coefficient state — except on
  // restart-interval streams, where whole pre-ROI segments can be skipped
  // consistently in every scan (they are then never read).
  long rv = interleaved ? 1 : comps[s.comp_idx[0]].v;
  long ry0 = roi_y0 * rv;
  long ry1 = (roi_y1 >= (long)mcus_y) ? (long)smy : roi_y1 * rv;

  BitReader br;
  br.init(s.data_start, s.data_end);
  int pred[4] = {0, 0, 0, 0};
  long eobrun = 0;
  int p1 = 1 << s.al;
  int m1 = -1 << s.al;

  long mcu = 0;
  if (s.restart_interval && ry0 > 0) {
    long nskip = (ry0 * smx) / ri;
    if (nskip > 0) {
      const uint8_t* q = s.data_start;
      for (long i = 0; i < nskip && q < s.data_end; i++)
        q = skip_restart(q, s.data_end);
      br.init(q, s.data_end);
      mcu = nskip * ri;
    }
  }
  while (mcu < total) {
    long seg_end = mcu + ri < total ? mcu + ri : total;
    long my = mcu / smx, mx = mcu % smx;
    if (my >= ry1) return;
    for (; mcu < seg_end; mcu++, (++mx == smx ? (mx = 0, ++my) : 0L)) {
      if (my >= ry1) return;
      for (int j = 0; j < s.ncomp; j++) {
        Component& c = comps[s.comp_idx[j]];
        int nby = interleaved ? c.v : 1;
        int nbx = interleaved ? c.h : 1;
        for (int by = 0; by < nby; by++) {
          for (int bx = 0; bx < nbx; bx++) {
            long row = interleaved ? my * c.v + by : my;
            long col = interleaved ? mx * c.h + bx : mx;
            int16_t* block = c.coef + (row * c.bw + col) * 64;
            if (is_dc) {
              if (s.ah == 0) {
                int t = decode_huff(br, s.dc[j]);
                if (t < 0 || t > 15) { error = 1; return; }
                pred[j] += extend(br.get_bits(t), t);
                block[0] = (int16_t)(pred[j] << s.al);
              } else {
                if (br.get_bit()) block[0] = (int16_t)(block[0] | p1);
              }
            } else {
              const HuffTable& act = s.ac[j];
              if (s.ah == 0) {
                // AC first
                if (eobrun > 0) {
                  eobrun--;
                } else {
                  int k = s.ss;
                  while (k <= s.se) {
                    int sym = decode_huff(br, act);
                    if (sym < 0) { error = 1; return; }
                    int r = sym >> 4, sz = sym & 15;
                    if (sz == 0) {
                      if (r == 15) { k += 16; continue; }
                      eobrun = (1L << r) - 1;
                      if (r) eobrun += br.get_bits(r);
                      break;
                    }
                    k += r;
                    if (k > s.se) { error = 1; return; }
                    block[kNat[k]] = (int16_t)(extend(br.get_bits(sz), sz) << s.al);
                    k++;
                  }
                }
              } else {
                // AC refine
                int k = s.ss;
                if (eobrun == 0) {
                  while (k <= s.se) {
                    int sym = decode_huff(br, act);
                    if (sym < 0) { error = 1; return; }
                    int r = sym >> 4, sz = sym & 15;
                    int sval = 0;
                    if (sz == 0) {
                      if (r != 15) {
                        eobrun = 1L << r;
                        if (r) eobrun += br.get_bits(r);
                        break;
                      }
                    } else {
                      sval = br.get_bit() ? p1 : m1;
                    }
                    while (k <= s.se) {
                      int16_t* coefp = block + kNat[k];
                      if (*coefp != 0) {
                        if (br.get_bit() && (*coefp & p1) == 0)
                          *coefp += (int16_t)(*coefp >= 0 ? p1 : m1);
                      } else {
                        if (r == 0) break;
                        r--;
                      }
                      k++;
                    }
                    if (sz) {
                      if (k > s.se) { error = 1; return; }
                      block[kNat[k]] = (int16_t)sval;
                    }
                    k++;
                  }
                }
                if (eobrun > 0) {
                  while (k <= s.se) {
                    int16_t* coefp = block + kNat[k];
                    if (*coefp != 0) {
                      if (br.get_bit() && (*coefp & p1) == 0)
                        *coefp += (int16_t)(*coefp >= 0 ? p1 : m1);
                    }
                    k++;
                  }
                  eobrun--;
                }
              }
            }
          }
        }
      }
    }
    if (mcu < total) {
      const uint8_t* next = br.marker ? br.marker : br.p;
      br.init(skip_restart(next, s.data_end), s.data_end);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
  }
}

}  // namespace

extern "C" {

// Decode all scans; returns 0 on success. Caller frees coefs[i] with
// tic_free. blocks are MCU-grid padded, natural order within each 64.
int tic_jpeg_decode_coefficients(const uint8_t* data, size_t len,
                                 int16_t** coefs, int32_t* blocks_w,
                                 int32_t* blocks_h, int32_t* out_ncomp) {
  Decoder d;
  d.base = data;
  d.len = len;
  if (!d.parse_and_decode()) {
    for (int c = 0; c < 4; c++)
      if (d.comps[c].coef) free(d.comps[c].coef);
    return -1;
  }
  *out_ncomp = d.ncomp;
  for (int c = 0; c < d.ncomp; c++) {
    coefs[c] = d.comps[c].coef;
    blocks_w[c] = d.comps[c].bw;
    blocks_h[c] = d.comps[c].bh;
  }
  return 0;
}

// Batch-preallocation variant: decode directly into caller buffers whose
// geometry (MCU-padded blocks_w/h per component) was computed from a prior
// header parse. Zero-copy into the stacked [B, bh, bw, 64] batch array.
int tic_jpeg_decode_coefficients_into(const uint8_t* data, size_t len,
                                      int16_t** bufs, const int32_t* exp_bw,
                                      const int32_t* exp_bh,
                                      int32_t exp_ncomp) {
  Decoder d;
  d.base = data;
  d.len = len;
  for (int c = 0; c < exp_ncomp && c < 4; c++) d.ext_coef[c] = bufs[c];
  d.ext_bw = exp_bw;
  d.ext_bh = exp_bh;
  d.ext_ncomp = exp_ncomp;
  if (!d.parse_and_decode()) return -1;  // ext buffers are caller-owned
  if (d.ncomp != exp_ncomp) return -2;
  return 0;
}

// ROI decode: like tic_jpeg_decode_coefficients_into but only MCU rows
// [mcu_y0, mcu_y1) are materialized; entropy work below the ROI is skipped
// entirely and pre-ROI restart segments are skipped by marker scan
// (reference analog: nvjpeg ROI, extensions/nvjpeg/cuda_decoder.cpp:460-520).
int tic_jpeg_decode_coefficients_roi_into(const uint8_t* data, size_t len,
                                          int16_t** bufs,
                                          const int32_t* exp_bw,
                                          const int32_t* exp_bh,
                                          int32_t exp_ncomp, int32_t mcu_y0,
                                          int32_t mcu_y1) {
  Decoder d;
  d.base = data;
  d.len = len;
  for (int c = 0; c < exp_ncomp && c < 4; c++) d.ext_coef[c] = bufs[c];
  d.ext_bw = exp_bw;
  d.ext_bh = exp_bh;
  d.ext_ncomp = exp_ncomp;
  d.roi_y0 = mcu_y0 > 0 ? mcu_y0 : 0;
  d.roi_y1 = mcu_y1 >= 0 ? mcu_y1 : 0x7FFFFFFFL;
  if (!d.parse_and_decode()) return -1;
  if (d.ncomp != exp_ncomp) return -2;
  return 0;
}

void tic_free(void* p) { free(p); }

// Index scan for the on-device entropy path (baseline sequential scans
// WITHOUT restart markers): destuffs the scan into `dst` and records, at
// every rows_per_seg MCU-row boundary, the destuffed-stream bit offset and
// the running DC predictors (the per-lane seeds for the Huffman kernel).
// Returns nsegs > 0 on success; -1 malformed stream; -2 capacity;
// -3 unsupported stream shape (progressive / DRI / multi-scan).
// Batched index scan: all images of a geometry bucket in ONE call, fanned
// over internal work-stealing threads (the per-image ctypes + thread-pool
// future round trip costs ~25% of the scan itself at 2 cores).
// dsts/dst_offs: one shared destuff arena, image i owns
// [dst_offs[i], dst_offs[i+1]). bits: [n, max_segs] int64 rows;
// preds: [n, max_segs*4] int32 rows. nsegs_out[i]: segment count or <0.
int tic_jpeg_index_scan_batch(int32_t n, const uint8_t* const* datas,
                              const int64_t* lens, int32_t rows_per_seg,
                              uint8_t* dsts, const int64_t* dst_offs,
                              int64_t* dlens, int64_t* bits,
                              int32_t* preds, int32_t max_segs,
                              int32_t* nsegs_out, int32_t nthreads) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) break;
      Decoder d;
      d.base = datas[i];
      d.len = (size_t)lens[i];
      d.index_rows = rows_per_seg;
      d.index_dst = dsts + dst_offs[i];
      d.index_cap = dst_offs[i + 1] - dst_offs[i];
      d.index_bits = bits + (int64_t)i * max_segs;
      d.index_preds = preds + (int64_t)i * max_segs * 4;
      d.index_max_segs = max_segs;
      bool ok = d.parse_and_decode();
      if (!ok || d.index_nsegs <= 0) {
        nsegs_out[i] = d.error == -3 ? -3 : (d.error == -2 ? -2 : -1);
        continue;
      }
      dlens[i] = d.index_dlen;
      nsegs_out[i] = d.index_nsegs;
    }
  };
  int nt = nthreads < 1 ? 1 : (nthreads > n ? n : nthreads);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt - 1; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
  }
  return 0;
}

int tic_jpeg_index_scan(const uint8_t* data, size_t len,
                        int32_t rows_per_seg, uint8_t* dst, int64_t dst_cap,
                        int64_t* out_dlen, int64_t* split_bits,
                        int32_t* split_preds, int32_t max_segs) {
  Decoder d;
  d.base = data;
  d.len = len;
  d.index_rows = rows_per_seg;
  d.index_dst = dst;
  d.index_cap = dst_cap;
  d.index_bits = split_bits;
  d.index_preds = split_preds;
  d.index_max_segs = max_segs;
  bool ok = d.parse_and_decode();
  if (!ok || d.index_nsegs <= 0) {
    if (d.error == -3) return -3;
    if (d.error == -2) return -2;
    return -1;
  }
  *out_dlen = d.index_dlen;
  return d.index_nsegs;
}

// Pack index-scanned segments into the kernel's [W, S] column matrix:
// segment i's words start at the 32-bit word containing split_bits[i]
// (start_bits_out[i] = the bit offset within that word); words run to the
// next segment's start (plus the bit reader's 64-bit lookahead slack),
// zero-padded to max_words. Words are big-endian byte groups, matching the
// kernel's funnel shifter. Returns 0, or -1 if a segment needs more than
// max_words.
int tic_jpeg_pack_indexed(const uint8_t* destuffed, int64_t dlen,
                          const int64_t* split_bits, int32_t nsegs,
                          uint32_t* words, int64_t stride, int64_t col0,
                          int32_t max_words, int32_t* start_bits_out) {
  int64_t total_words = (dlen + 3) / 4;
  for (int i = 0; i < nsegs; i++) {
    int64_t w0 = split_bits[i] / 32;
    int64_t end_bit = (i + 1 < nsegs) ? split_bits[i + 1] : dlen * 8;
    // +96 bits: the funnel holds cur+nxt (64) and peeks 16 ahead
    int64_t w1 = (end_bit + 96 + 31) / 32;
    if (w1 > total_words) w1 = total_words;
    int64_t nw = w1 - w0;
    if (nw > max_words) return -1;
    uint32_t* col = words + col0 + i;
    const uint8_t* src = destuffed + w0 * 4;
    int64_t full = (dlen - w0 * 4) / 4;  // whole 4-byte groups available
    if (full > nw) full = nw;
    int64_t w = 0;
    for (; w < full; w++) {
      uint32_t v;
      memcpy(&v, src + w * 4, 4);
      col[w * stride] = __builtin_bswap32(v);
    }
    if (w < nw) {  // partial tail word, left-aligned
      uint32_t acc = 0;
      const uint8_t* q = src + w * 4;
      for (int b = 0; b < 4; b++)
        acc = (acc << 8) | (q + b < destuffed + dlen ? q[b] : 0);
      col[w * stride] = acc;
      w++;
    }
    for (; w < max_words; w++) col[w * stride] = 0;
    start_bits_out[i] = (int32_t)(split_bits[i] - w0 * 32);
  }
  return 0;
}

// Batched pack: images j=0..n-1 of a sub-bucket into columns j*nsegs of
// the [W, S] matrix in one call (internal threads). arena/offs as in
// tic_jpeg_index_scan_batch. rcs[j] = 0 ok / -1 overflow.
int tic_jpeg_pack_indexed(const uint8_t* destuffed, int64_t dlen,
                          const int64_t* split_bits, int32_t nsegs,
                          uint32_t* words, int64_t stride, int64_t col0,
                          int32_t max_words, int32_t* start_bits_out);

int tic_jpeg_pack_indexed_batch(int32_t n, const uint8_t* arena,
                                const int64_t* offs, const int64_t* dlens,
                                const int64_t* bits, int32_t max_segs,
                                int32_t nsegs, uint32_t* words,
                                int64_t stride, int32_t max_words,
                                int32_t* start_bits, int32_t* rcs,
                                int32_t nthreads) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t j = next.fetch_add(1, std::memory_order_relaxed);
      if (j >= n) break;
      rcs[j] = tic_jpeg_pack_indexed(
          arena + offs[j], dlens[j], bits + (int64_t)j * max_segs, nsegs,
          words, stride, (int64_t)j * nsegs, max_words,
          start_bits + (int64_t)j * nsegs);
    }
  };
  int nt = nthreads < 1 ? 1 : (nthreads > n ? n : nthreads);
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt - 1; t++) ts.emplace_back(worker);
    worker();
    for (auto& t : ts) t.join();
  }
  return 0;
}

// Split one image's entropy-coded scan into restart segments, destuff
// (0xFF00 -> 0xFF) and pack each segment into big-endian uint32 words laid
// out COLUMN-major for the device entropy kernel: words[w * stride + col0 +
// seg] = word w of segment seg. Feeds the restart-interval-parallel
// Huffman decoder (SURVEY.md §7: "host-side index scan for restart markers,
// then data-parallel per-segment decode").
// Returns the number of segments written, or -1 if a segment exceeds
// max_words capacity / -2 if there are more segments than max_segs.
int tic_jpeg_split_segments(const uint8_t* scan, int64_t scan_len,
                            uint32_t* words, int64_t stride, int64_t col0,
                            int32_t max_segs, int32_t max_words) {
  int seg = 0;
  const uint8_t* p = scan;
  const uint8_t* end = scan + scan_len;
  while (p < end) {
    if (seg >= max_segs) return -2;
    uint32_t acc = 0;
    int nb = 0;
    int64_t w = 0;
    uint32_t* col = words + col0 + seg;
    while (p < end) {
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          p += 2;  // stuffed data byte
        } else {
          break;  // marker terminates the segment
        }
      } else {
        p++;
      }
      acc = (acc << 8) | b;
      if (++nb == 4) {
        if (w >= max_words) return -1;
        col[w * stride] = acc;
        w++;
        acc = 0;
        nb = 0;
      }
    }
    if (nb) {  // flush the partial word, left-aligned, zero-padded
      acc <<= 8 * (4 - nb);
      if (w >= max_words) return -1;
      col[w * stride] = acc;
      w++;
    }
    // zero-fill the remainder so the bit reader sees padding zeros
    for (; w < max_words; w++) col[w * stride] = 0;
    seg++;
    // skip the restart marker (or EOI and trailing bytes)
    if (p < end && p[0] == 0xFF) {
      if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        continue;
      }
      break;  // EOI or other marker: done
    }
  }
  return seg;
}

}  // extern "C"
