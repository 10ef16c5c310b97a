// CCITT Group 3 / Group 4 fax decompressor (ITU-T T.4 / T.6; TIFF 6.0
// §10-11, compressions 2/3/4) — the bilevel-document compression class the
// reference's TIFF path inherits from libtiff
// (extensions/libtiff/libtiff_decoder.cpp hands compression to libtiff).
// Written from the T.4/T.6 specs; the run-length Huffman tables below are
// the normative code tables (T.4 tables 2/3, shared extended make-up
// codes), analogous data to the MQ Qe table in j2k_t1.cpp.
//
// Modes:
//   2 — "Modified Huffman": 1-D MH lines, each byte-aligned, no EOL
//   3 — T.4 G3: EOL-delimited lines; T4Options bit0 = 2-D lines allowed
//       (tag bit after EOL), bit2 = fill bits before EOL
//   4 — T.6 G4: pure 2-D MMR, imaginary all-white reference line, EOFB end
//
// Output: packed 1-bit rows, MSB-first, rowbytes = (w+7)/8, bit 1 = black
// (the TIFF PHOTOMETRIC_MINISWHITE convention the Python layer then maps
// through its white-is-zero handling).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct RunCode {
  uint16_t bits;  // left-aligned in `len` LSBs (i.e. value of the code)
  uint8_t len;
  uint16_t run;
};

// T.4 table 2 — white terminating codes (runs 0-63)
constexpr RunCode kWhiteTerm[64] = {
    {0x35, 8, 0},  {0x07, 6, 1},  {0x07, 4, 2},  {0x08, 4, 3},
    {0x0B, 4, 4},  {0x0C, 4, 5},  {0x0E, 4, 6},  {0x0F, 4, 7},
    {0x13, 5, 8},  {0x14, 5, 9},  {0x07, 5, 10}, {0x08, 5, 11},
    {0x08, 6, 12}, {0x03, 6, 13}, {0x34, 6, 14}, {0x35, 6, 15},
    {0x2A, 6, 16}, {0x2B, 6, 17}, {0x27, 7, 18}, {0x0C, 7, 19},
    {0x08, 7, 20}, {0x17, 7, 21}, {0x03, 7, 22}, {0x04, 7, 23},
    {0x28, 7, 24}, {0x2B, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27},
    {0x18, 7, 28}, {0x02, 8, 29}, {0x03, 8, 30}, {0x1A, 8, 31},
    {0x1B, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39},
    {0x29, 8, 40}, {0x2A, 8, 41}, {0x2B, 8, 42}, {0x2C, 8, 43},
    {0x2D, 8, 44}, {0x04, 8, 45}, {0x05, 8, 46}, {0x0A, 8, 47},
    {0x0B, 8, 48}, {0x52, 8, 49}, {0x53, 8, 50}, {0x54, 8, 51},
    {0x55, 8, 52}, {0x24, 8, 53}, {0x25, 8, 54}, {0x58, 8, 55},
    {0x59, 8, 56}, {0x5A, 8, 57}, {0x5B, 8, 58}, {0x4A, 8, 59},
    {0x4B, 8, 60}, {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63},
};

// T.4 table 2 — white make-up codes (64-1728)
constexpr RunCode kWhiteMakeup[27] = {
    {0x1B, 5, 64},    {0x12, 5, 128},   {0x17, 6, 192},  {0x37, 7, 256},
    {0x36, 8, 320},   {0x37, 8, 384},   {0x64, 8, 448},  {0x65, 8, 512},
    {0x68, 8, 576},   {0x67, 8, 640},   {0xCC, 9, 704},  {0xCD, 9, 768},
    {0xD2, 9, 832},   {0xD3, 9, 896},   {0xD4, 9, 960},  {0xD5, 9, 1024},
    {0xD6, 9, 1088},  {0xD7, 9, 1152},  {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344},  {0xDB, 9, 1408},  {0x98, 9, 1472}, {0x99, 9, 1536},
    {0x9A, 9, 1600},  {0x18, 6, 1664},  {0x9B, 9, 1728},
};

// T.4 table 3 — black terminating codes (runs 0-63)
constexpr RunCode kBlackTerm[64] = {
    {0x37, 10, 0},   {0x02, 3, 1},    {0x03, 2, 2},    {0x02, 2, 3},
    {0x03, 3, 4},    {0x03, 4, 5},    {0x02, 4, 6},    {0x03, 5, 7},
    {0x05, 6, 8},    {0x04, 6, 9},    {0x04, 7, 10},   {0x05, 7, 11},
    {0x07, 7, 12},   {0x04, 8, 13},   {0x07, 8, 14},   {0x18, 9, 15},
    {0x17, 10, 16},  {0x18, 10, 17},  {0x08, 10, 18},  {0x67, 11, 19},
    {0x68, 11, 20},  {0x6C, 11, 21},  {0x37, 11, 22},  {0x28, 11, 23},
    {0x17, 11, 24},  {0x18, 11, 25},  {0xCA, 12, 26},  {0xCB, 12, 27},
    {0xCC, 12, 28},  {0xCD, 12, 29},  {0x68, 12, 30},  {0x69, 12, 31},
    {0x6A, 12, 32},  {0x6B, 12, 33},  {0xD2, 12, 34},  {0xD3, 12, 35},
    {0xD4, 12, 36},  {0xD5, 12, 37},  {0xD6, 12, 38},  {0xD7, 12, 39},
    {0x6C, 12, 40},  {0x6D, 12, 41},  {0xDA, 12, 42},  {0xDB, 12, 43},
    {0x54, 12, 44},  {0x55, 12, 45},  {0x56, 12, 46},  {0x57, 12, 47},
    {0x64, 12, 48},  {0x65, 12, 49},  {0x52, 12, 50},  {0x53, 12, 51},
    {0x24, 12, 52},  {0x37, 12, 53},  {0x38, 12, 54},  {0x27, 12, 55},
    {0x28, 12, 56},  {0x58, 12, 57},  {0x59, 12, 58},  {0x2B, 12, 59},
    {0x2C, 12, 60},  {0x5A, 12, 61},  {0x66, 12, 62},  {0x67, 12, 63},
};

// T.4 table 3 — black make-up codes (64-1728)
constexpr RunCode kBlackMakeup[27] = {
    {0x0F, 10, 64},   {0xC8, 12, 128},  {0xC9, 12, 192},  {0x5B, 12, 256},
    {0x33, 12, 320},  {0x34, 12, 384},  {0x35, 12, 448},  {0x6C, 13, 512},
    {0x6D, 13, 576},  {0x4A, 13, 640},  {0x4B, 13, 704},  {0x4C, 13, 768},
    {0x4D, 13, 832},  {0x72, 13, 896},  {0x73, 13, 960},  {0x74, 13, 1024},
    {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536},
    {0x5B, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728},
};

// Extended make-up codes, shared by both colours (1792-2560)
constexpr RunCode kExtMakeup[13] = {
    {0x08, 11, 1792},  {0x0C, 11, 1856},  {0x0D, 11, 1920},
    {0x12, 12, 1984},  {0x13, 12, 2048},  {0x14, 12, 2112},
    {0x15, 12, 2176},  {0x16, 12, 2240},  {0x17, 12, 2304},
    {0x1C, 12, 2368},  {0x1D, 12, 2432},  {0x1E, 12, 2496},
    {0x1F, 12, 2560},
};

// 13-bit prefix LUT per colour: value -> (run | IS_MAKEUP, code length).
// Built once; a run entry of 0xFFFF marks an invalid prefix.
struct LutEntry {
  uint16_t run;
  uint8_t len;
  uint8_t makeup;  // 1 = make-up code (keep accumulating same colour)
};

struct RunLut {
  LutEntry e[1 << 13];
};

void fill_lut(RunLut& lut, const RunCode* codes, int n, bool makeup) {
  for (int i = 0; i < n; ++i) {
    const RunCode& c = codes[i];
    int shift = 13 - c.len;
    uint32_t base = (uint32_t)c.bits << shift;
    for (uint32_t j = 0; j < (1u << shift); ++j)
      lut.e[base + j] = {c.run, c.len, (uint8_t)(makeup ? 1 : 0)};
  }
}

const RunLut* white_lut() {
  static RunLut lut = [] {
    RunLut l;
    for (auto& x : l.e) x = {0xFFFF, 0, 0};
    fill_lut(l, kWhiteTerm, 64, false);
    fill_lut(l, kWhiteMakeup, 27, true);
    fill_lut(l, kExtMakeup, 13, true);
    return l;
  }();
  return &lut;
}

const RunLut* black_lut() {
  static RunLut lut = [] {
    RunLut l;
    for (auto& x : l.e) x = {0xFFFF, 0, 0};
    fill_lut(l, kBlackTerm, 64, false);
    fill_lut(l, kBlackMakeup, 27, true);
    fill_lut(l, kExtMakeup, 13, true);
    return l;
  }();
  return &lut;
}

struct BitReader {
  const uint8_t* p;
  int64_t len;
  int64_t pos = 0;  // bit position
  bool overrun = false;

  uint32_t peek(int n) {
    // MSB-first peek of up to 24 bits; bits past the end read as 0
    uint32_t v = 0;
    int64_t byte = pos >> 3;
    int off = pos & 7;
    for (int got = 0; got < n + off; got += 8) {
      v = (v << 8) | (byte < len ? p[byte] : 0);
      byte++;
    }
    int total = ((n + off + 7) / 8) * 8;
    return (v >> (total - off - n)) & ((1u << n) - 1);
  }

  void skip(int n) {
    pos += n;
    if (pos > len * 8) overrun = true;
  }

  bool exhausted() const { return pos >= len * 8; }

  void align_byte() { pos = (pos + 7) & ~7LL; }
};

constexpr uint32_t kEol = 0x001;  // 000000000001 (12 bits)

// Decode one run of `white` colour; returns total run length or -1.
int decode_run(BitReader& br, bool white) {
  const RunLut* lut = white ? white_lut() : black_lut();
  int total = 0;
  for (int guard = 0; guard < 64; ++guard) {  // >= 2624/64 make-ups allowed
    uint32_t v = br.peek(13);
    const LutEntry& e = lut->e[v];
    if (e.run == 0xFFFF || br.exhausted()) return -1;
    br.skip(e.len);
    total += e.run;
    if (!e.makeup) return total;
  }
  return -1;
}

// Decode one 1-D (MH) line into transition positions (ascending, colour
// flips at each; line starts white). Returns 0 ok, -1 error, 1 = hit EOL
// before the line was complete (short line; caller pads white).
int decode_1d_line(BitReader& br, int w, std::vector<int>& tr) {
  tr.clear();
  int pos = 0;
  bool white = true;
  while (pos < w) {
    if (br.peek(12) == kEol) return 1;
    int run = decode_run(br, white);
    if (run < 0) return -1;
    pos += run;
    if (pos > w) return -1;
    if (pos < w || !white) tr.push_back(pos < w ? pos : w);
    white = !white;
  }
  return 0;
}

// Find b1/b2 for the 2-D coder: ref transitions (ascending, first =
// white->black), a0 current position, colour = current coding colour.
// b1 = first ref transition > a0 whose new colour != current colour's
// continuation, i.e. index parity: even index starts black.
void find_b1_b2(const std::vector<int>& ref, int a0, bool white, int w,
                int* b1, int* b2) {
  size_t i = 0;
  // skip transitions <= a0
  while (i < ref.size() && ref[i] <= a0) i++;
  // need parity: white coding -> b1 is white->black transition (even idx)
  size_t want = white ? 0 : 1;
  if ((i & 1) != want) i++;
  *b1 = i < ref.size() ? ref[i] : w;
  *b2 = (i + 1) < ref.size() ? ref[i + 1] : w;
}

// Decode one 2-D line against `ref`; fills `cur`. Returns 0 ok, -1 error.
int decode_2d_line(BitReader& br, int w, const std::vector<int>& ref,
                   std::vector<int>& cur) {
  cur.clear();
  int a0 = -1;
  bool white = true;
  while (a0 < w) {
    int b1, b2;
    find_b1_b2(ref, a0, white, w, &b1, &b2);
    uint32_t v7 = br.peek(7);
    if (br.exhausted() && v7 == 0) return -1;
    if (v7 >> 6) {  // 1 — V0
      br.skip(1);
      if (b1 < w || !white) cur.push_back(b1 < w ? b1 : w);
      a0 = b1;
      white = !white;
    } else if ((v7 >> 4) == 0x1) {  // 001 — horizontal
      br.skip(3);
      int r1 = decode_run(br, white);
      if (r1 < 0) return -1;
      int r2 = decode_run(br, !white);
      if (r2 < 0) return -1;
      int s = a0 < 0 ? 0 : a0;
      int a1 = s + r1, a2 = a1 + r2;
      if (a2 > w || a1 > w) {
        if (a1 > w) return -1;
        a2 = w;
      }
      if (a0 >= 0 && a2 <= a0) return -1;  // no progress: malformed
      cur.push_back(a1);
      if (a2 < w) cur.push_back(a2);
      else if (!white) cur.push_back(w);
      a0 = a2;
    } else if ((v7 >> 3) == 0x1) {  // 0001 — pass
      br.skip(4);
      a0 = b2;
      if (a0 > w) return -1;
    } else if ((v7 >> 4) == 0x3) {  // 011 — VR1
      br.skip(3);
      int a1 = b1 + 1;
      if (a1 > w) return -1;
      cur.push_back(a1 > w ? w : a1);
      a0 = a1;
      white = !white;
    } else if ((v7 >> 4) == 0x2) {  // 010 — VL1
      br.skip(3);
      int a1 = b1 - 1;
      if (a1 < 0 || a1 <= a0) return -1;
      if (a1 < w || !white) cur.push_back(a1);
      a0 = a1;
      white = !white;
    } else if ((v7 >> 1) == 0x3) {  // 000011 — VR2
      br.skip(6);
      int a1 = b1 + 2;
      if (a1 > w) return -1;
      cur.push_back(a1);
      a0 = a1;
      white = !white;
    } else if ((v7 >> 1) == 0x2) {  // 000010 — VL2
      br.skip(6);
      int a1 = b1 - 2;
      if (a1 < 0 || a1 <= a0) return -1;
      cur.push_back(a1);
      a0 = a1;
      white = !white;
    } else if (v7 == 0x3) {  // 0000011 — VR3
      br.skip(7);
      int a1 = b1 + 3;
      if (a1 > w) return -1;
      cur.push_back(a1);
      a0 = a1;
      white = !white;
    } else if (v7 == 0x2) {  // 0000010 — VL3
      br.skip(7);
      int a1 = b1 - 3;
      if (a1 < 0 || a1 <= a0) return -1;
      cur.push_back(a1);
      a0 = a1;
      white = !white;
    } else {
      return -1;  // EOL / extension / garbage mid-line
    }
    if (br.overrun) return -1;
  }
  // drop a trailing transition exactly at w duplicated by V-coding
  while (cur.size() >= 2 && cur[cur.size() - 1] == w &&
         cur[cur.size() - 2] == w)
    cur.pop_back();
  return 0;
}

// Render transitions to one packed MSB-first row (1 = black).
void render_row(const std::vector<int>& tr, int w, uint8_t* row) {
  int rowbytes = (w + 7) / 8;
  std::memset(row, 0, rowbytes);
  for (size_t i = 0; i + 1 <= tr.size(); i += 2) {
    int x0 = tr[i];
    int x1 = (i + 1) < tr.size() ? tr[i + 1] : w;
    if (x0 >= w) break;
    if (x1 > w) x1 = w;
    for (int x = x0; x < x1; ++x) row[x >> 3] |= (uint8_t)(0x80u >> (x & 7));
  }
}

// Scan forward to the next EOL (tolerating fill zero-bits); consume it.
// Returns true if found within a sane window.
bool sync_eol(BitReader& br) {
  int64_t limit = br.len * 8;
  while (br.pos + 12 <= limit) {
    if (br.peek(12) == kEol) {
      br.skip(12);
      return true;
    }
    if (br.peek(1) != 0) return false;  // non-fill bit that isn't EOL start
    br.skip(1);
  }
  return false;
}

}  // namespace

extern "C" {

// mode: 2 = MH, 3 = G3 (opts = T4Options: bit0 2-D, bit2 fill), 4 = G4.
// dst: h rows of (w+7)/8 packed bytes, bit 1 = black. Rows the stream
// doesn't cover are left white. Returns number of rows decoded, or -1.
int32_t tic_tiff_fax_decode(const uint8_t* src, int64_t srclen, int32_t w,
                            int32_t h, int32_t mode, int32_t opts,
                            uint8_t* dst) {
  if (w <= 0 || h <= 0 || srclen < 0) return -1;
  int rowbytes = (w + 7) / 8;
  std::memset(dst, 0, (size_t)rowbytes * h);
  BitReader br{src, srclen};
  std::vector<int> ref, cur;
  ref.clear();  // imaginary all-white line: no transitions
  int rows = 0;
  bool two_d_allowed = (mode == 3) && (opts & 1);

  for (int y = 0; y < h; ++y) {
    bool line_2d = (mode == 4);
    if (mode == 2) {
      br.align_byte();
      if (br.exhausted()) break;
    } else if (mode == 3) {
      // EOL before every line (first included per T.4; tolerate absent
      // leading EOL from lenient writers)
      if (y == 0) {
        if (br.peek(12) == kEol) br.skip(12);
        else if (br.peek(1) == 0 && !sync_eol(br)) return rows;
      } else if (!sync_eol(br)) {
        break;  // RTC / truncation: remaining rows stay white
      }
      if (two_d_allowed) {
        line_2d = br.peek(1) == 0;
        br.skip(1);
      }
    }
    int rc;
    if (line_2d) {
      rc = decode_2d_line(br, w, ref, cur);
    } else {
      rc = decode_1d_line(br, w, cur);
      if (rc == 1) rc = 0;  // short line: rest is white
    }
    if (rc != 0 || br.overrun) return rows > 0 ? rows : -1;
    render_row(cur, w, dst + (size_t)y * rowbytes);
    ref = cur;
    rows++;
    if (mode == 4 && br.peek(12) == kEol && br.peek(24) == ((kEol << 12) | kEol))
      break;  // EOFB
  }
  return rows;
}

}  // extern "C"
