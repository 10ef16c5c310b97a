// HTJ2K (ITU-T T.814) block coder: HT Cleanup + HT SigProp + HT MagRef,
// decode and encode. Counterpart of the HTJ2K support the
// reference gets from closed nvjpeg2k (reference:
// extensions/nvjpeg2k/cuda_decoder.cpp:178 "nvjpeg2kStreamGetImageInfo...
// HT"; README.md:38 "High Throughput JPEG2000").
//
// Written from the T.814 algorithm structure; every bit-level rule
// (stream framing, MEL/VLC/UVLC/MagSgn interleave, eqn-1/eqn-2 context
// formation, kappa, EMB semantics, stuffing disciplines, SigProp grouping,
// MagRef backward stream, bitplane/reconstruction law) was pinned down and
// validated bit-exactly against the system openjpeg 2.5 HT decoder as a
// black-box conformance oracle (tools/ht_probe.py, 150/150 random blocks).
// The CxtVLC code tables are normative ITU-T spec constants (T.814 Annex C).
//
// Bitstream layout of a cleanup segment (length Lcup):
//   [MagSgn: forward, LSB-first, 0xFF->7-bit stuffing]
//   [MEL: forward, MSB-first, 0xFF->7-bit stuffing]
//   [VLC: backward from Lcup-2's high nibble, LSB-first, >0x8F/0x7F stuff]
//   Scup = (D[Lcup-1] << 4) | (D[Lcup-2] & 15), suffix = MEL+VLC bytes.
// Refinement segment (length Lref): [SigProp forward] ... [MagRef backward
// from the end, initial unstuff armed].

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

// ----------------------------------------------------------- spec tables
// ITU-T T.814 CxtVLC tables (Annex C) - normative spec constants.
// Row packing: ctx[0:3] cwd[3:10] len[10:13] rho[13:17] u_off[17] e1[18:22]
// ek[22:26]
#include "j2k_ht_tables.inc"

struct VlcEntry {  // decoder LUT entry
    uint8_t len, rho, u_off, e1, ek;
};

struct VlcTables {
    VlcEntry dec[2][8][128];          // [tbl][ctx][7 peeked bits]
    // encoder: row list indices per (tbl, ctx, rho, u_off)
    struct Row { uint8_t cwd, len, e1, ek; };
    std::vector<Row> enc[2][8][16][2];

    VlcTables() {
        memset(dec, 0, sizeof(dec));
        const uint32_t* tabs[2] = {kVlcRows0, kVlcRows1};
        const int sizes[2] = {
            int(sizeof(kVlcRows0) / sizeof(uint32_t)),
            int(sizeof(kVlcRows1) / sizeof(uint32_t))};
        for (int t = 0; t < 2; ++t) {
            for (int i = 0; i < sizes[t]; ++i) {
                uint32_t v = tabs[t][i];
                int ctx = v & 7, cwd = (v >> 3) & 0x7F, len = (v >> 10) & 7;
                int rho = (v >> 13) & 15, uo = (v >> 17) & 1;
                int e1 = (v >> 18) & 15, ek = (v >> 22) & 15;
                for (int fill = cwd; fill < 128; fill += (1 << len)) {
                    dec[t][ctx][fill] = {uint8_t(len), uint8_t(rho),
                                         uint8_t(uo), uint8_t(e1),
                                         uint8_t(ek)};
                }
                enc[t][ctx][rho][uo].push_back(
                    {uint8_t(cwd), uint8_t(len), uint8_t(e1), uint8_t(ek)});
            }
            // prefer rows with more EMB bits (shorter MagSgn)
            for (int c = 0; c < 8; ++c)
                for (int r = 0; r < 16; ++r)
                    for (int u = 0; u < 2; ++u) {
                        auto& v = enc[t][c][r][u];
                        for (size_t a = 0; a < v.size(); ++a)
                            for (size_t b = a + 1; b < v.size(); ++b)
                                if (__builtin_popcount(v[b].ek) >
                                    __builtin_popcount(v[a].ek)) {
                                    auto tmp = v[a];
                                    v[a] = v[b];
                                    v[b] = tmp;
                                }
                    }
        }
    }
};

const VlcTables& vlc_tables() {
    static VlcTables t;
    return t;
}

// ------------------------------------------------------------ bit readers
// MEL: forward, MSB-first, a byte following 0xFF carries 7 bits.
struct MelDec {
    const uint8_t* d;
    int size, pos = 0, bits = 0, k = 0;
    int zeros = 0, pending_one = 0;
    uint8_t cur = 0;
    bool prev_ff = false;
    static constexpr int E[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

    MelDec(const uint8_t* p, int n) : d(p), size(n) {}
    int bit() {
        if (bits == 0) {
            uint8_t b = pos < size ? d[pos] : 0xFF;
            ++pos;
            bits = prev_ff ? 7 : 8;
            prev_ff = (b == 0xFF);
            cur = b;
        }
        --bits;
        return (cur >> bits) & 1;
    }
    // one binary event: 1 = "significant"/"both u>2"
    int event() {
        while (zeros == 0 && !pending_one) {
            int e = E[k];
            if (bit()) {  // full run of 2^e zero-events, no terminator
                zeros = 1 << e;
                k = k < 12 ? k + 1 : 12;
            } else {  // partial run of r zero-events, then a 1-event
                int r = 0;
                for (int i = 0; i < e; ++i) r = (r << 1) | bit();
                zeros = r;
                pending_one = 1;
                k = k > 0 ? k - 1 : 0;
            }
        }
        if (zeros) {
            --zeros;
            return 0;
        }
        pending_one = 0;
        return 1;
    }
};

// VLC: backward, starts at the high nibble of D[Lcup-2].
struct RevDec {
    const uint8_t* d;   // suffix base
    int pos;            // next byte index to read (descending)
    uint64_t tmp = 0;
    int bits = 0;
    bool unstuff;

    RevDec(const uint8_t* suffix, int scup) {
        d = suffix;
        pos = scup - 2;
        uint8_t b = pos >= 0 ? d[pos] : 0;
        --pos;
        tmp = b >> 4;
        bits = 4 - ((tmp & 7) == 7);  // 3 data bits if low three are ones
        unstuff = (b | 0xF) > 0x8F;
    }
    void fill() {
        // fast path: 8 in-bounds bytes none of which can trigger the
        // backward unstuff rule (no byte in {0x7F, 0xFF}) — append as many
        // whole bytes as fit in one bswapped load
        if (!unstuff && pos >= 7) {
            uint64_t v;
            std::memcpy(&v, d + pos - 7, 8);
            // any byte with low 7 bits all ones?
            uint64_t x = (v & 0x7F7F7F7F7F7F7F7Full) ^ 0x7F7F7F7F7F7F7F7Full;
            bool risky = ((x - 0x0101010101010101ull) & ~x &
                          0x8080808080808080ull) != 0;
            if (!risky) {
                v = __builtin_bswap64(v);  // d[pos] becomes the low byte
                int nbytes = (64 - bits) >> 3;
                tmp |= v << bits;
                // unstuff for the NEXT fill depends on the last byte taken
                unstuff = uint8_t(v >> (8 * (nbytes - 1))) > 0x8F;
                pos -= nbytes;
                bits += 8 * nbytes;
                return;
            }
        }
        while (bits < 32 && pos >= -4) {
            uint8_t b = pos >= 0 ? d[pos] : 0;
            --pos;
            int nb = (unstuff && (b & 0x7F) == 0x7F) ? 7 : 8;
            tmp |= uint64_t(b) << bits;
            bits += nb;
            unstuff = b > 0x8F;
        }
    }
    uint32_t peek() {
        if (bits < 32) fill();
        return uint32_t(tmp);
    }
    void advance(int n) {
        tmp >>= n;
        bits -= n;
    }
};

// MagSgn / SigProp: forward, LSB-first, byte after 0xFF carries 7 bits.
template <uint8_t PAD>
struct FwdDec {
    const uint8_t* d;
    int size, pos = 0;
    uint64_t tmp = 0;
    int bits = 0;
    bool prev_ff = false;

    FwdDec(const uint8_t* p, int n) : d(p), size(n) {}
    static inline bool has_ff(uint64_t v) {
        // any byte == 0xFF  <=>  any byte of ~v == 0x00
        uint64_t x = ~v;
        return ((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull)
               != 0;
    }
    void fill() {
        // fast path: 8 raw in-bounds bytes with no 0xFF anywhere — append
        // as many whole bytes as fit in one shot (the MagSgn stream is the
        // bulk of an HT cleanup segment; the per-byte stuffing loop below
        // was its hottest edge)
        if (!prev_ff && pos + 8 <= size) {
            uint64_t v;
            std::memcpy(&v, d + pos, 8);
            if (!has_ff(v)) {
                int nbytes = (64 - bits) >> 3;
                tmp |= v << bits;  // high bytes shift out naturally
                pos += nbytes;
                bits += 8 * nbytes;
                return;
            }
        }
        while (bits <= 56) {
            uint8_t b = pos < size ? d[pos] : PAD;
            ++pos;
            int nb = prev_ff ? 7 : 8;
            tmp |= uint64_t(b & (prev_ff ? 0x7F : 0xFF)) << bits;
            bits += nb;
            prev_ff = (b == 0xFF);
        }
    }
    uint32_t get(int n) {
        if (bits < n) fill();
        uint32_t v = uint32_t(tmp & ((n == 32) ? 0xFFFFFFFFu
                                                : ((1ull << n) - 1)));
        tmp >>= n;
        bits -= n;
        return v;
    }
};

// MagRef: backward from segment end, initial unstuff armed.
struct RevMrp {
    const uint8_t* d;
    int pos;
    uint64_t tmp = 0;
    int bits = 0;
    bool unstuff = true;  // armed at init (probed vs openjpeg)

    RevMrp(const uint8_t* seg, int len) : d(seg), pos(len - 1) {}
    void fill() {
        while (bits < 32 && pos >= -4) {
            uint8_t b = pos >= 0 ? d[pos] : 0;
            --pos;
            int nb = (unstuff && (b & 0x7F) == 0x7F) ? 7 : 8;
            tmp |= uint64_t(b) << bits;
            bits += nb;
            unstuff = b > 0x8F;
        }
    }
    int bit() {
        if (bits < 1) fill();
        int v = tmp & 1;
        tmp >>= 1;
        --bits;
        return v;
    }
};

// ------------------------------------------------------------ bit writers
struct MelEnc {
    std::vector<uint8_t> bits;  // raw bit list
    int k = 0, run = 0;
    static constexpr int E[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

    void event(int b) {
        if (b == 0) {
            if (++run == (1 << E[k])) {
                bits.push_back(1);
                k = k < 12 ? k + 1 : 12;
                run = 0;
            }
        } else {
            bits.push_back(0);
            for (int i = E[k] - 1; i >= 0; --i)
                bits.push_back((run >> i) & 1);
            k = k > 0 ? k - 1 : 0;
            run = 0;
        }
    }
    std::vector<uint8_t> flush() {
        if (run > 0) bits.push_back(1);
        std::vector<uint8_t> out;
        int acc = 0, n = 0, cap = 8;
        for (uint8_t b : bits) {
            acc = (acc << 1) | b;
            if (++n == cap) {
                out.push_back(uint8_t(acc));
                cap = (acc == 0xFF) ? 7 : 8;
                acc = n = 0;
            }
        }
        if (n) {
            while (n < cap) {
                acc = (acc << 1) | 1;  // pad: claims unread full runs
                ++n;
            }
            if (cap == 8 && acc == 0xFF) acc = 0xFE;
            out.push_back(uint8_t(acc));
        }
        return out;
    }
};

// VLC bit collector -> backward-packed bytes (file order, nibble byte last;
// its low nibble is 0 for the caller to merge Scup's low 4 bits).
std::vector<uint8_t> pack_vlc(const std::vector<uint8_t>& bits) {
    std::vector<uint8_t> out;  // decode order
    size_t pos = 0;
    int nib = 0;
    size_t take = bits.size() < 3 ? bits.size() : 3;
    for (size_t i = 0; i < take; ++i) nib |= bits[pos + i] << i;
    pos += take;
    if ((nib & 7) != 7 && pos < bits.size()) {
        nib |= bits[pos] << 3;
        ++pos;
    }
    out.push_back(uint8_t(nib << 4));
    int prev = out[0];
    while (pos < bits.size()) {
        int b = 0;
        size_t t = bits.size() - pos < 7 ? bits.size() - pos : 7;
        for (size_t i = 0; i < t; ++i) b |= bits[pos + i] << i;
        if (prev > 0x8F && (b & 0x7F) == 0x7F) {
            pos += 7;  // MSB is a stuff 0
        } else {
            pos += t;
            if (pos < bits.size()) {
                b |= bits[pos] << 7;
                ++pos;
            }
        }
        out.push_back(uint8_t(b));
        prev = b;
    }
    std::vector<uint8_t> rev(out.rbegin(), out.rend());
    return rev;
}

// forward LSB-first packer with 0xFF stuffing (MagSgn / SigProp)
struct FwdEnc {
    std::vector<uint8_t> out;
    int acc = 0, n = 0, cap = 8;
    void put(int b) {
        acc |= b << n;
        if (++n == cap) {
            out.push_back(uint8_t(acc));
            cap = (acc == 0xFF) ? 7 : 8;
            acc = n = 0;
        }
    }
    std::vector<uint8_t> flush() {
        if (n) out.push_back(uint8_t(acc));
        return out;
    }
};

// MagRef backward packer (emission order == decode order; reversed at end)
std::vector<uint8_t> pack_mrp(const std::vector<uint8_t>& bits) {
    std::vector<uint8_t> out;
    size_t pos = 0;
    int prev = 0xFF;  // reader starts with unstuff armed
    while (pos < bits.size()) {
        int b = 0;
        size_t t = bits.size() - pos < 7 ? bits.size() - pos : 7;
        for (size_t i = 0; i < t; ++i) b |= bits[pos + i] << i;
        if (prev > 0x8F && (b & 0x7F) == 0x7F) {
            pos += 7;
        } else {
            pos += t;
            if (pos < bits.size()) {
                b |= bits[pos] << 7;
                ++pos;
            }
        }
        out.push_back(uint8_t(b));
        prev = b;
    }
    std::vector<uint8_t> rev(out.rbegin(), out.rend());
    return rev;
}

// ------------------------------------------------------------------ UVLC
// prefix: u=1:'1'  u=2:'01'  u=3,4:'001'+1sfx  u=5..36:'000'+5sfx
void uvlc_emit(std::vector<uint8_t>& v, int u, bool prefix_only,
               bool suffix_only) {
    if (!suffix_only) {
        if (u == 1) {
            v.push_back(1);
        } else if (u == 2) {
            v.push_back(0);
            v.push_back(1);
        } else {
            v.push_back(0);
            v.push_back(0);
            v.push_back(u <= 4 ? 1 : 0);
        }
    }
    if (!prefix_only) {
        if (u == 3 || u == 4) {
            v.push_back(u - 3);
        } else if (u >= 5) {
            int s = u - 5;
            for (int i = 0; i < 5; ++i) v.push_back((s >> i) & 1);
        }
    }
}

struct UvlcPfx {
    int len, val, sfxlen;
};
UvlcPfx uvlc_read_prefix(RevDec& vlc) {
    uint32_t p = vlc.peek();
    if (p & 1) {
        vlc.advance(1);
        return {1, 1, 0};
    }
    if (p & 2) {
        vlc.advance(2);
        return {2, 2, 0};
    }
    if (p & 4) {
        vlc.advance(3);
        return {3, 3, 1};
    }
    vlc.advance(3);
    return {3, 5, 5};
}
int uvlc_read_suffix(RevDec& vlc, const UvlcPfx& pfx) {
    if (pfx.sfxlen == 0) return pfx.val;
    uint32_t s = vlc.peek() & ((1u << pfx.sfxlen) - 1);
    vlc.advance(pfx.sfxlen);
    return pfx.val + int(s);
}

inline int exp_of_w(uint32_t w) {  // E = bitlen(w|1)
    return 32 - __builtin_clz(w | 1);
}

// Fused UVLC readers: prefix+suffix (and both quads of a pair) decoded
// from ONE peek window with a single advance, instead of 2-4 peek/advance
// round-trips through the backward VLC reader.
__attribute__((always_inline)) inline int uvlc_read_u(RevDec& vlc) {
    uint32_t w = vlc.peek();
    if (w & 1) { vlc.advance(1); return 1; }
    if (w & 2) { vlc.advance(2); return 2; }
    if (w & 4) { vlc.advance(4); return 3 + int((w >> 3) & 1); }
    vlc.advance(8);
    return 5 + int((w >> 3) & 31);
}

// both-prefixes-then-both-suffixes order (tbl1 mode 3 / tbl0 mode 4)
__attribute__((always_inline)) inline void uvlc_read_pair(RevDec& vlc,
                                                          int& u0, int& u1) {
    uint32_t w = vlc.peek();
    int l0, v0, s0;
    if (w & 1) { l0 = 1; v0 = 1; s0 = 0; }
    else if (w & 2) { l0 = 2; v0 = 2; s0 = 0; }
    else if (w & 4) { l0 = 3; v0 = 3; s0 = 1; }
    else { l0 = 3; v0 = 5; s0 = 5; }
    uint32_t w1 = w >> l0;
    int l1, v1, s1;
    if (w1 & 1) { l1 = 1; v1 = 1; s1 = 0; }
    else if (w1 & 2) { l1 = 2; v1 = 2; s1 = 0; }
    else if (w1 & 4) { l1 = 3; v1 = 3; s1 = 1; }
    else { l1 = 3; v1 = 5; s1 = 5; }
    uint32_t sfx = w1 >> l1;
    u0 = v0 + int(sfx & ((1u << s0) - 1));
    u1 = v1 + int((sfx >> s0) & ((1u << s1) - 1));
    vlc.advance(l0 + l1 + s0 + s1);
}

#ifdef HT_SECTION_PROF
}  // namespace
unsigned long long g_ht_sec[4];  // vlc, uvlc, magsgn, other
namespace {
#define HT_TSC() __builtin_ia32_rdtsc()
#define HT_SEC(i, t0) g_ht_sec[i] += HT_TSC() - (t0)
#else
#define HT_TSC() 0ull
#define HT_SEC(i, t0) (void)(t0)
#endif

// Branch-free UVLC LUTs: the 3-bit prefix chains collapse into one table
// load (single u: prefix+suffix from the low 8 peeked bits; a quad PAIR's
// two prefixes from the low 6 bits).
struct UvlcLut {
    uint16_t single[256];  // (consumed_len << 8) | u
    uint16_t pair[64];     // pl | v0<<3 | s0<<6 | v1<<9 | s1<<12
    uint8_t pfx[8];        // (l << 6) | (v << 3) | s  for one prefix
};

const UvlcLut& uvlc_lut() {
    static const UvlcLut L = [] {
        UvlcLut t{};
        auto pfx1 = [](uint32_t w, int& l, int& v, int& s) {
            if (w & 1) { l = 1; v = 1; s = 0; }
            else if (w & 2) { l = 2; v = 2; s = 0; }
            else if (w & 4) { l = 3; v = 3; s = 1; }
            else { l = 3; v = 5; s = 5; }
        };
        for (uint32_t b = 0; b < 256; ++b) {
            int l, v, s;
            pfx1(b, l, v, s);
            int u = v + int((b >> l) & ((1u << s) - 1));
            t.single[b] = uint16_t(((l + s) << 8) | u);
        }
        for (uint32_t b = 0; b < 64; ++b) {
            int l0, v0, s0, l1, v1, s1;
            pfx1(b, l0, v0, s0);
            pfx1(b >> l0, l1, v1, s1);
            t.pair[b] = uint16_t((l0 + l1) | (v0 << 3) | (s0 << 6) |
                                 (v1 << 9) | (s1 << 12));
        }
        for (uint32_t b = 0; b < 8; ++b) {
            int l, v, s;
            pfx1(b, l, v, s);
            t.pfx[b] = uint8_t((l << 6) | (v << 3) | s);
        }
        return t;
    }();
    return L;
}

// Cleanup-only decode specialized for the dominant case (lossless HT
// streams carry a single cleanup pass per block): final signed
// reconstruction values are written straight into the caller's (zeroed,
// strided) destination at MagSgn time — no mu/sg/sig planes, no separate
// reconstruction sweep, no per-block heap traffic (line state lives in
// thread-local buffers), and the West quad context comes from the previous
// quad's rho instead of a significance plane. The quad-row loop is
// specialized on INIT (initial row vs context rows: drops the per-quad tbl
// branches) and SB ("small B": Ucap+B <= 29, reconstruction fits int32 —
// the common 8/12-bit case drops all 64-bit value math).
template <bool SB>
int ht_cleanup_fast_t(const uint8_t* cup, int lcup, int scup, int w, int h,
                      int B, int Ucap, int32_t* out, int64_t stride) {
    const VlcTables& T = vlc_tables();
    const UvlcLut& UL = uvlc_lut();
    MelDec mel(cup + lcup - scup, scup);
    RevDec vlc(cup + lcup - scup, scup);
    FwdDec<0xFF> mag(cup, lcup - scup);

    const int QW = (w + 1) >> 1, QH = (h + 1) >> 1;
    const int p = B - 1;
    const int64_t half = p > 0 ? int64_t(1) << (p - 1) : 0;
    const uint32_t half32 = uint32_t(half);

    static thread_local std::vector<uint8_t> lines;
    lines.assign(2 * (size_t(w) + 8), 0);
    uint8_t* Eline = lines.data();          // prev bottom-row exps, idx x+1
    uint8_t* nEline = Eline + (w + 8);
    // significance of a bottom-row sample ⟺ its Eline entry is nonzero
    // (exp_of_w(wv) >= 1 whenever written), so there is no separate sig line

    int rc = 0;
    auto run_row = [&](auto init_tag, int qy) -> int {
        constexpr bool INIT = decltype(init_tag)::value;
        constexpr int tbl = INIT ? 0 : 1;
        const int y0 = 2 * qy;
        int c_q = 0;
        int prevrho = 0;  // rho of the quad to the West (this quad row)
        std::memset(nEline, 0, size_t(w) + 8);
        int32_t* const orow0 = out + int64_t(y0) * stride;
        int32_t* const orow1 = orow0 + stride;
        const int vbase = 1 | ((y0 + 1 < h) ? 2 : 0);
        for (int qx0 = 0; qx0 < QW; qx0 += 2) {
            unsigned long long t_vlc = HT_TSC();
            int rho[2] = {0, 0}, uoff[2] = {0, 0}, e1[2] = {0, 0},
                ek[2] = {0, 0}, kap[2] = {1, 1};
            const int npair = (qx0 + 1 < QW) ? 2 : 1;
            for (int j = 0; j < npair; ++j) {
                const int x0 = 2 * (qx0 + j);
                uint32_t ew = 0;
                if (!INIT) {
                    std::memcpy(&ew, Eline + x0, 4);  // NW,N0,N1,NE exps
                    int sW = ((prevrho & 0xC) != 0) ? 1 : 0;
                    c_q = ((ew & 0xFFFFu) ? 1 : 0) | (sW << 1) |
                          ((ew >> 16) ? 4 : 0);
                }
                int significant = 1;
                if (c_q == 0) significant = mel.event();
                if (significant) {
                    uint32_t peek7 = vlc.peek() & 0x7F;
                    const VlcEntry& e = T.dec[tbl][c_q][peek7];
                    if (e.len == 0) return -5;
                    vlc.advance(e.len);
                    rho[j] = e.rho;
                    uoff[j] = e.u_off;
                    e1[j] = e.e1;
                    ek[j] = e.ek;
                }
                if (!INIT) {
                    int emax = int(ew & 0xFF);
                    int e1b = int((ew >> 8) & 0xFF);
                    int e2b = int((ew >> 16) & 0xFF);
                    int e3b = int(ew >> 24);
                    if (e1b > emax) emax = e1b;
                    if (e2b > emax) emax = e2b;
                    if (e3b > emax) emax = e3b;
                    int gamma = (rho[j] & (rho[j] - 1)) ? 1 : 0;
                    kap[j] = gamma * (emax - 1);
                    if (kap[j] < 1) kap[j] = 1;
                }
                // reject rho bits addressing outside the block (partial
                // right/bottom quads)
                int vmask = vbase | ((x0 + 1 < w) ? (4 | (vbase & 2) << 2)
                                                  : 0);
                if (rho[j] & ~vmask) return -6;
                prevrho = rho[j];
                if (INIT) {  // eqn 1: next quad's context, initial row
                    c_q = ((rho[j] & 3) ? 1 : 0) | (((rho[j] >> 2) & 1) << 1)
                          | (((rho[j] >> 3) & 1) << 2);
                }
            }
            HT_SEC(0, t_vlc);
            unsigned long long t_uvlc = HT_TSC();
            // ---- UVLC (same rules as the general path, LUT readers)
            int U[2] = {kap[0], kap[1]};
            int mode = uoff[0] | (uoff[1] << 1);
            if (INIT) {
                if (mode == 3) mode += mel.event();
                if (mode == 1 || mode == 2) {
                    uint16_t sg = UL.single[vlc.peek() & 0xFF];
                    vlc.advance(sg >> 8);
                    U[mode - 1] = 1 + int(sg & 0xFF);
                } else if (mode == 3) {
                    // special initial-row order: prefix0, u1 bit, suffix0
                    uint32_t w0 = vlc.peek();
                    uint8_t pe = UL.pfx[w0 & 7];
                    int l0 = pe >> 6, v0 = (pe >> 3) & 7, s0 = pe & 7;
                    if (v0 >= 3) {
                        int u1 = int((w0 >> l0) & 1) + 1;
                        U[0] = 1 + v0 +
                               int((w0 >> (l0 + 1)) & ((1u << s0) - 1));
                        U[1] = 1 + u1;
                        vlc.advance(l0 + 1 + s0);
                    } else {
                        U[0] = 1 + v0;
                        uint16_t sg = UL.single[(vlc.peek() >> l0) & 0xFF];
                        vlc.advance(l0 + (sg >> 8));
                        U[1] = 1 + int(sg & 0xFF);
                    }
                } else if (mode == 4) {
                    uint32_t w0 = vlc.peek();
                    uint16_t pe = UL.pair[w0 & 63];
                    int pl = pe & 7, v0 = (pe >> 3) & 7, s0 = (pe >> 6) & 7;
                    int v1 = (pe >> 9) & 7, s1 = (pe >> 12) & 7;
                    uint32_t sfx = w0 >> pl;
                    U[0] = 3 + v0 + int(sfx & ((1u << s0) - 1));
                    U[1] = 3 + v1 + int((sfx >> s0) & ((1u << s1) - 1));
                    vlc.advance(pl + s0 + s1);
                }
            } else {
                if (mode == 1 || mode == 2) {
                    uint16_t sg = UL.single[vlc.peek() & 0xFF];
                    vlc.advance(sg >> 8);
                    U[mode - 1] = kap[mode - 1] + int(sg & 0xFF);
                } else if (mode == 3) {
                    uint32_t w0 = vlc.peek();
                    uint16_t pe = UL.pair[w0 & 63];
                    int pl = pe & 7, v0 = (pe >> 3) & 7, s0 = (pe >> 6) & 7;
                    int v1 = (pe >> 9) & 7, s1 = (pe >> 12) & 7;
                    uint32_t sfx = w0 >> pl;
                    U[0] = kap[0] + v0 + int(sfx & ((1u << s0) - 1));
                    U[1] = kap[1] + v1 + int((sfx >> s0) & ((1u << s1) - 1));
                    vlc.advance(pl + s0 + s1);
                }
            }
            if (U[0] > Ucap || U[1] > Ucap) return -7;
            HT_SEC(1, t_uvlc);
            unsigned long long t_ms = HT_TSC();
            // ---- MagSgn: all four samples of a quad are sliced out of one
            // 64-bit window (one fill + four shift/mask extracts) instead of
            // four guarded bit-reader calls; final values go straight to the
            // destination rows
            for (int j = 0; j < npair; ++j) {
                const int r = rho[j];
                if (!r) continue;
                const int x0 = 2 * (qx0 + j);
                const int Uj = U[j], ekj = ek[j], e1j = e1[j];
                const int k0 = ekj & 1, k1 = (ekj >> 1) & 1,
                          k2 = (ekj >> 2) & 1, k3 = (ekj >> 3) & 1;
                const int m0 = (r & 1) ? Uj - k0 : 0;
                const int m1 = (r & 2) ? Uj - k1 : 0;
                const int m2 = (r & 4) ? Uj - k2 : 0;
                const int m3 = (r & 8) ? Uj - k3 : 0;
                const int p1 = m0, p2 = m0 + m1, p3 = m0 + m1 + m2;
                const int total = p3 + m3;
                uint32_t w0, w1, w2, w3;
                if (total <= 56) {
                    if (mag.bits < total) mag.fill();
                    // independent shifts (prefix-sum positions) rather than
                    // a serial t >>= chain: 4 extracts run in parallel
                    uint64_t t = mag.tmp;
                    w0 = uint32_t(t & ((1ull << m0) - 1));
                    w1 = uint32_t((t >> p1) & ((1ull << m1) - 1));
                    w2 = uint32_t((t >> p2) & ((1ull << m2) - 1));
                    w3 = uint32_t((t >> p3) & ((1ull << m3) - 1));
                    mag.tmp = t >> total;
                    mag.bits -= total;
                } else {  // > 56 bits in one quad: rare deep-bitplane case
                    w0 = m0 ? mag.get(m0) : 0;
                    w1 = m1 ? mag.get(m1) : 0;
                    w2 = m2 ? mag.get(m2) : 0;
                    w3 = m3 ? mag.get(m3) : 0;
                }
                auto val = [&](uint32_t wv) -> int32_t {
                    if (SB) {
                        uint32_t v = (((wv >> 1) + 1) << p) + half32;
                        return (wv & 1) ? -int32_t(v) : int32_t(v);
                    }
                    int64_t v = ((int64_t(wv >> 1) + 1) << p) + half;
                    return (wv & 1) ? int32_t(-v) : int32_t(v);
                };
                if (r == 15) {  // all-significant quad (the busy-image
                                // common case): straight-line, no per-bit
                                // branches
                    uint32_t v0 = w0 | ((k0 & (e1j & 1)) ? 1u << m0 : 0u);
                    uint32_t v1 = w1 | ((k1 & ((e1j >> 1) & 1)) ? 1u << m1
                                                               : 0u);
                    uint32_t v2 = w2 | ((k2 & ((e1j >> 2) & 1)) ? 1u << m2
                                                               : 0u);
                    uint32_t v3 = w3 | ((k3 & ((e1j >> 3) & 1)) ? 1u << m3
                                                               : 0u);
                    orow0[x0] = val(v0);
                    orow0[x0 + 1] = val(v2);
                    orow1[x0] = val(v1);
                    orow1[x0 + 1] = val(v3);
                    nEline[x0 + 1] = uint8_t(exp_of_w(v1));
                    nEline[x0 + 2] = uint8_t(exp_of_w(v3));
                    continue;
                }
                if (r & 1)
                    orow0[x0] = val(w0 | ((k0 & (e1j & 1)) ? 1u << m0 : 0u));
                if (r & 2) {
                    uint32_t wv = w1 | ((k1 & ((e1j >> 1) & 1)) ? 1u << m1
                                                               : 0u);
                    orow1[x0] = val(wv);
                    nEline[x0 + 1] = uint8_t(exp_of_w(wv));
                }
                if (r & 4)
                    orow0[x0 + 1] =
                        val(w2 | ((k2 & ((e1j >> 2) & 1)) ? 1u << m2 : 0u));
                if (r & 8) {
                    uint32_t wv = w3 | ((k3 & ((e1j >> 3) & 1)) ? 1u << m3
                                                               : 0u);
                    orow1[x0 + 1] = val(wv);
                    nEline[x0 + 2] = uint8_t(exp_of_w(wv));
                }
            }
            HT_SEC(2, t_ms);
        }
        return 0;
    };

    for (int qy = 0; qy < QH; ++qy) {
        rc = qy == 0
                 ? run_row(std::integral_constant<bool, true>{}, qy)
                 : run_row(std::integral_constant<bool, false>{}, qy);
        if (rc) return rc;
        std::swap(Eline, nEline);
    }
    return 0;
}

int ht_cleanup_decode_fast(const uint8_t* cup, int lcup, int w, int h,
                           int B, int Ucap, int32_t* out, int64_t stride) {
    int scup = (int(cup[lcup - 1]) << 4) | (cup[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079) return -4;
    if (Ucap + B <= 29)
        return ht_cleanup_fast_t<true>(cup, lcup, scup, w, h, B, Ucap, out,
                                       stride);
    return ht_cleanup_fast_t<false>(cup, lcup, scup, w, h, B, Ucap, out,
                                    stride);
}

}  // namespace

extern "C" {

// Decode one HT code-block.
//   cup/lcup: cleanup segment; ref/lref: refinement segment (may be null).
//   num_passes in 1..3; B = Mb - zero_bitplanes (cleanup plane p = B-1).
//   out: w*h int32, row-major, signed reconstruction at plane 0 with
//   mid-bin rounding for planes not (yet) decoded — matches openjpeg.
// Returns 0 on success, negative on malformed stream.
int tic_ht_decode_block(const uint8_t* cup, int32_t lcup, const uint8_t* ref,
                        int32_t lref, int32_t num_passes, int32_t w,
                        int32_t h, int32_t B, int32_t Ucap, int32_t* out) {
    if (w <= 0 || h <= 0 || w > 1024 || h > 1024 || B < 1 || B > 37)
        return -1;
    if (Ucap < 1 || Ucap > 37) Ucap = 37;
    if (lcup < 2) return -2;
    if (num_passes < 1 || num_passes > 3) return -3;
    int scup = (int(cup[lcup - 1]) << 4) | (cup[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079) return -4;

    if (num_passes == 1) {  // dominant (lossless) case: specialized path
        std::memset(out, 0, sizeof(int32_t) * size_t(w) * h);
        return ht_cleanup_decode_fast(cup, lcup, w, h, B, Ucap, out, w);
    }

    const VlcTables& T = vlc_tables();
    MelDec mel(cup + lcup - scup, scup);
    RevDec vlc(cup + lcup - scup, scup);
    FwdDec<0xFF> mag(cup, lcup - scup);

    const int QW = (w + 1) >> 1, QH = (h + 1) >> 1;
    std::vector<uint32_t> mu(size_t(w) * h, 0);   // cleanup magnitudes
    std::vector<uint8_t> sg(size_t(w) * h, 0);    // sign bits
    std::vector<uint8_t> sig(size_t(w) * h, 0);   // significance
    // per-sample E of the previous quad row's bottom line, padded
    std::vector<uint8_t> Eline(size_t(w) + 4, 0);  // index x+1
    std::vector<uint8_t> sline(size_t(w) + 4, 0);

    int p = B - 1;

    for (int qy = 0; qy < QH; ++qy) {
        const int tbl = qy == 0 ? 0 : 1;
        const int y0 = 2 * qy;
        int c_q = 0;
        std::vector<uint8_t> nEline(size_t(w) + 4, 0);
        std::vector<uint8_t> nsline(size_t(w) + 4, 0);
        for (int qx0 = 0; qx0 < QW; qx0 += 2) {
            // ---- decode up to two quads' VLC info
            int rho[2] = {0, 0}, uoff[2] = {0, 0}, e1[2] = {0, 0},
                ek[2] = {0, 0}, kap[2] = {1, 1};
            int npair = (qx0 + 1 < QW) ? 2 : 1;
            for (int j = 0; j < npair; ++j) {
                int qx = qx0 + j;
                int x0 = 2 * qx;
                if (tbl == 1) {
                    int sW =
                        x0 > 0 ? (sig[size_t(y0) * w + (x0 - 1)] |
                                  (y0 + 1 < h
                                       ? sig[size_t(y0 + 1) * w + (x0 - 1)]
                                       : 0))
                               : 0;
                    int sNW = sline[x0], sN0 = sline[x0 + 1],
                        sN1 = sline[x0 + 2], sNE = sline[x0 + 3];
                    c_q = (sNW | sN0) | (sW << 1) | ((sN1 | sNE) << 2);
                }
                int significant = 1;
                if (c_q == 0) significant = mel.event();
                if (significant) {
                    uint32_t peek7 = vlc.peek() & 0x7F;
                    const VlcEntry& e = T.dec[tbl][c_q][peek7];
                    if (e.len == 0) return -5;
                    vlc.advance(e.len);
                    rho[j] = e.rho;
                    uoff[j] = e.u_off;
                    e1[j] = e.e1;
                    ek[j] = e.ek;
                }
                if (tbl == 1) {
                    int emax = Eline[x0];
                    if (Eline[x0 + 1] > emax) emax = Eline[x0 + 1];
                    if (Eline[x0 + 2] > emax) emax = Eline[x0 + 2];
                    if (Eline[x0 + 3] > emax) emax = Eline[x0 + 3];
                    int gamma = (rho[j] & (rho[j] - 1)) ? 1 : 0;
                    kap[j] = gamma * (emax - 1);
                    if (kap[j] < 1) kap[j] = 1;
                }
                // bounds check + mark significance NOW (the next quad's
                // eqn-2 West context reads it before MagSgn runs)
                for (int n = 0; n < 4; ++n) {
                    if (!((rho[j] >> n) & 1)) continue;
                    int x = x0 + (n >> 1), y = y0 + (n & 1);
                    if (x >= w || y >= h) return -6;
                    sig[size_t(y) * w + x] = 1;
                }
                // eqn 1: context for the next quad on the initial row
                if (tbl == 0) {
                    c_q = ((rho[j] & 3) ? 1 : 0) | (((rho[j] >> 2) & 1) << 1) |
                          (((rho[j] >> 3) & 1) << 2);
                }
            }
            // ---- UVLC
            int U[2] = {kap[0], kap[1]};
            int mode = uoff[0] | (uoff[1] << 1);
            if (tbl == 0) {
                if (mode == 3) mode += mel.event();
                if (mode == 1 || mode == 2) {
                    UvlcPfx px = uvlc_read_prefix(vlc);
                    int u = uvlc_read_suffix(vlc, px);
                    U[mode - 1] = 1 + u;
                } else if (mode == 3) {
                    UvlcPfx p0 = uvlc_read_prefix(vlc);
                    if (p0.val >= 3) {
                        int u1 = int(vlc.peek() & 1) + 1;
                        vlc.advance(1);
                        U[0] = 1 + uvlc_read_suffix(vlc, p0);
                        U[1] = 1 + u1;
                    } else {
                        U[0] = 1 + p0.val;
                        UvlcPfx p1 = uvlc_read_prefix(vlc);
                        U[1] = 1 + uvlc_read_suffix(vlc, p1);
                    }
                } else if (mode == 4) {
                    UvlcPfx p0 = uvlc_read_prefix(vlc);
                    UvlcPfx p1 = uvlc_read_prefix(vlc);
                    U[0] = 1 + 2 + uvlc_read_suffix(vlc, p0);
                    U[1] = 1 + 2 + uvlc_read_suffix(vlc, p1);
                }
            } else {
                if (mode == 1 || mode == 2) {
                    UvlcPfx px = uvlc_read_prefix(vlc);
                    int u = uvlc_read_suffix(vlc, px);
                    U[mode - 1] = kap[mode - 1] + u;
                } else if (mode == 3) {
                    UvlcPfx p0 = uvlc_read_prefix(vlc);
                    UvlcPfx p1 = uvlc_read_prefix(vlc);
                    U[0] = kap[0] + uvlc_read_suffix(vlc, p0);
                    U[1] = kap[1] + uvlc_read_suffix(vlc, p1);
                }
            }
            if (U[0] > Ucap || U[1] > Ucap) return -7;
            // ---- MagSgn
            for (int j = 0; j < npair; ++j) {
                int x0 = 2 * (qx0 + j);
                for (int n = 0; n < 4; ++n) {
                    if (!((rho[j] >> n) & 1)) continue;
                    int x = x0 + (n >> 1), y = y0 + (n & 1);
                    int kn = (ek[j] >> n) & 1;
                    int m = U[j] - kn;
                    uint32_t ms = m ? mag.get(m) : 0;
                    uint32_t wv = ms;
                    if (kn && ((e1[j] >> n) & 1)) wv |= 1u << m;
                    size_t idx = size_t(y) * w + x;
                    sg[idx] = wv & 1;
                    mu[idx] = (wv >> 1) + 1;
                    // line state from the quad's BOTTOM row (y = y0+1)
                    if ((n & 1) == 1) {
                        nEline[x + 1] = uint8_t(exp_of_w(wv));
                        nsline[x + 1] = 1;
                    }
                }
            }
        }
        Eline.swap(nEline);
        sline.swap(nsline);
    }

    // ---- refinement passes
    std::vector<uint8_t> newsig;
    int q = p;  // plane after all decoded passes
    if (num_passes >= 2) {
        if (p < 1 || !ref || lref <= 0) {
            if (p < 1) return -8;
            // zero-length refinement: treat as absent
        } else {
            q = p - 1;
            newsig.assign(size_t(w) * h, 0);
            FwdDec<0> spp(ref, lref);
            std::vector<uint8_t> st(sig);
            for (int ys = 0; ys < h; ys += 4) {
                int ye = ys + 4 < h ? ys + 4 : h;
                for (int xg = 0; xg < w; xg += 4) {
                    int xe = xg + 4 < w ? xg + 4 : w;
                    int gx[16], gy[16], gn = 0;
                    for (int x = xg; x < xe; ++x) {
                        for (int y = ys; y < ye; ++y) {
                            size_t idx = size_t(y) * w + x;
                            if (st[idx]) continue;
                            bool member = false;
                            for (int dy = -1; dy <= 1 && !member; ++dy)
                                for (int dx = -1; dx <= 1; ++dx) {
                                    if (!dx && !dy) continue;
                                    int xx = x + dx, yy = y + dy;
                                    if (xx >= 0 && xx < w && yy >= 0 &&
                                        yy < h &&
                                        st[size_t(yy) * w + xx]) {
                                        member = true;
                                        break;
                                    }
                                }
                            if (!member) continue;
                            if (spp.get(1)) {
                                st[idx] = 1;
                                newsig[idx] = 1;
                                gx[gn] = x;
                                gy[gn] = y;
                                ++gn;
                            }
                        }
                    }
                    for (int i = 0; i < gn; ++i)
                        sg[size_t(gy[i]) * w + gx[i]] = uint8_t(spp.get(1));
                }
            }
            if (num_passes >= 3) {
                RevMrp mrp(ref, lref);
                for (int ys = 0; ys < h; ys += 4) {
                    int ye = ys + 4 < h ? ys + 4 : h;
                    for (int x = 0; x < w; ++x)
                        for (int y = ys; y < ye; ++y) {
                            size_t idx = size_t(y) * w + x;
                            if (sig[idx])
                                mu[idx] = 2 * mu[idx] + uint32_t(mrp.bit());
                        }
                }
            }
        }
    }

    // ---- reconstruction (plane-0 integers, mid-bin for missing planes)
    bool refined = num_passes >= 3 && q == p - 1;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            size_t idx = size_t(y) * w + x;
            int64_t v = 0;
            if (sig[idx]) {
                int plane = refined ? q : p;
                v = int64_t(mu[idx]) << plane;
                if (plane > 0) v += int64_t(1) << (plane - 1);
            } else if (!newsig.empty() && newsig[idx]) {
                v = int64_t(1) << q;
                if (q > 0) v += int64_t(1) << (q - 1);
            }
            out[idx] = int32_t(sg[idx] ? -v : v);
        }
    return 0;
}

// Strided decode straight into a subband array (out points at the block's
// top-left sample; rows `stride` int32 apart, region pre-zeroed). The
// cleanup-only case decodes in place with no scratch; refinement streams
// fall back to the dense path through a thread-local block buffer.
int tic_ht_decode_block_strided(const uint8_t* cup, int32_t lcup,
                                const uint8_t* ref, int32_t lref,
                                int32_t num_passes, int32_t w, int32_t h,
                                int32_t B, int32_t Ucap, int32_t* out,
                                int64_t stride) {
    if (w <= 0 || h <= 0 || w > 1024 || h > 1024 || B < 1 || B > 37)
        return -1;
    if (Ucap < 1 || Ucap > 37) Ucap = 37;
    if (lcup < 2) return -2;
    if (num_passes < 1 || num_passes > 3) return -3;
    if (num_passes == 1) {
        int scup = (int(cup[lcup - 1]) << 4) | (cup[lcup - 2] & 0xF);
        if (scup < 2 || scup > lcup || scup > 4079) return -4;
        return ht_cleanup_decode_fast(cup, lcup, w, h, B, Ucap, out, stride);
    }
    static thread_local std::vector<int32_t> scratch;
    scratch.assign(size_t(w) * h, 0);
    int rc = tic_ht_decode_block(cup, lcup, ref, lref, num_passes, w, h, B,
                                 Ucap, scratch.data());
    if (rc) return rc;
    for (int y = 0; y < h; ++y)
        std::memcpy(out + int64_t(y) * stride, scratch.data() + size_t(y) * w,
                    sizeof(int32_t) * w);
    return 0;
}

// Encode one HT code-block from signed plane-0 coefficients.
//   num_passes: 1 (cleanup-only lossless, B = Emax) or 3 (cleanup at p=1 +
//   SigProp + MagRef; lossless except samples below plane 1 with no
//   significant neighbor in SigProp scan order).
//   out receives cleanup || refinement; *lcup / *lref the segment lengths;
//   *B the required (Mb - zero_bitplanes) to signal.
// Returns 0, or negative on error (-10: out_cap too small).
int tic_ht_encode_block(const int32_t* coef, int32_t w, int32_t h,
                        int32_t num_passes, uint8_t* out, int32_t out_cap,
                        int32_t* lcup, int32_t* lref, int32_t* Bout,
                        int32_t* Umax_out) {
    if (w <= 0 || h <= 0 || w > 1024 || h > 1024) return -1;
    if (num_passes != 1 && num_passes != 3) return -2;
    const int p = num_passes == 1 ? 0 : 1;
    const VlcTables& T = vlc_tables();

    const int QW = (w + 1) >> 1, QH = (h + 1) >> 1;
    MelEnc mel;
    std::vector<uint8_t> vbits;
    FwdEnc msenc;

    std::vector<uint8_t> sig(size_t(w) * h, 0);
    std::vector<uint8_t> Eline(size_t(w) + 4, 0), sline(size_t(w) + 4, 0);
    int maxE = 1;

    for (int qy = 0; qy < QH; ++qy) {
        const int tbl = qy == 0 ? 0 : 1;
        const int y0 = 2 * qy;
        int c_q = 0;
        std::vector<uint8_t> nEline(size_t(w) + 4, 0),
            nsline(size_t(w) + 4, 0);
        struct QInfo {
            int rho = 0, uoff = 0, U = 1, kap = 1, ek = 0;
            uint32_t wv[4] = {0, 0, 0, 0};
            int E[4] = {0, 0, 0, 0};
        };
        for (int qx0 = 0; qx0 < QW; qx0 += 2) {
            int npair = (qx0 + 1 < QW) ? 2 : 1;
            QInfo qi[2];
            for (int j = 0; j < npair; ++j) {
                int qx = qx0 + j, x0 = 2 * qx;
                QInfo& Q = qi[j];
                int emax = 0;
                for (int n = 0; n < 4; ++n) {
                    int x = x0 + (n >> 1), y = y0 + (n & 1);
                    if (x >= w || y >= h) continue;
                    int32_t v = coef[size_t(y) * w + x];
                    uint32_t m = uint32_t(v < 0 ? -int64_t(v) : v) >> p;
                    if (!m) continue;
                    Q.rho |= 1 << n;
                    Q.wv[n] = 2 * (m - 1) + (v < 0 ? 1 : 0);
                    Q.E[n] = exp_of_w(Q.wv[n]);
                    if (Q.E[n] > emax) emax = Q.E[n];
                    sig[size_t(y) * w + x] = 1;
                }
                if (tbl == 1) {
                    int sW =
                        x0 > 0 ? (sig[size_t(y0) * w + (x0 - 1)] |
                                  (y0 + 1 < h
                                       ? sig[size_t(y0 + 1) * w + (x0 - 1)]
                                       : 0))
                               : 0;
                    int sNW = sline[x0], sN0 = sline[x0 + 1],
                        sN1 = sline[x0 + 2], sNE = sline[x0 + 3];
                    c_q = (sNW | sN0) | (sW << 1) | ((sN1 | sNE) << 2);
                    int em = Eline[x0];
                    if (Eline[x0 + 1] > em) em = Eline[x0 + 1];
                    if (Eline[x0 + 2] > em) em = Eline[x0 + 2];
                    if (Eline[x0 + 3] > em) em = Eline[x0 + 3];
                    int gamma = (Q.rho & (Q.rho - 1)) ? 1 : 0;
                    Q.kap = gamma * (em - 1);
                    if (Q.kap < 1) Q.kap = 1;
                }
                Q.uoff = emax > Q.kap ? 1 : 0;
                Q.U = Q.uoff ? emax : Q.kap;
                if (Q.U > maxE) maxE = Q.U;
                if (c_q == 0) mel.event(Q.rho ? 1 : 0);
                if (Q.rho || c_q != 0) {
                    // pick a valid VLC row: each EMB bit must match the
                    // known MSB of that sample's U-bit word
                    const auto& rows = T.enc[tbl][c_q][Q.rho][Q.uoff];
                    const VlcTables::Row* best = nullptr;
                    for (const auto& r : rows) {
                        bool ok = true;
                        for (int n = 0; n < 4 && ok; ++n) {
                            if (!((r.ek >> n) & 1)) continue;
                            int msb = (Q.E[n] == Q.U)
                                          ? int((Q.wv[n] >> (Q.U - 1)) & 1)
                                          : 0;
                            if (Q.E[n] > Q.U || msb != ((r.e1 >> n) & 1))
                                ok = false;
                        }
                        if (ok) {
                            best = &r;
                            break;
                        }
                    }
                    if (!best) return -3;
                    for (int i = 0; i < best->len; ++i)
                        vbits.push_back((best->cwd >> i) & 1);
                    Q.ek = best->ek;
                }
                if (tbl == 0) {
                    c_q = ((Q.rho & 3) ? 1 : 0) |
                          (((Q.rho >> 2) & 1) << 1) |
                          (((Q.rho >> 3) & 1) << 2);
                }
                // bottom-row line state for the next quad row
                for (int n = 1; n < 4; n += 2) {
                    int x = x0 + (n >> 1), y = y0 + 1;
                    if (x >= w || y >= h) continue;
                    if ((Q.rho >> n) & 1) {
                        nsline[x + 1] = 1;
                        nEline[x + 1] = uint8_t(Q.E[n]);
                    }
                }
            }
            // UVLC
            int u0 = qi[0].U - qi[0].kap, u1 = qi[1].U - qi[1].kap;
            int mode = qi[0].uoff | (qi[1].uoff << 1);
            if (tbl == 0) {
                if (mode == 3) {
                    bool both = u0 > 2 && u1 > 2;
                    mel.event(both ? 1 : 0);
                    if (both) {
                        uvlc_emit(vbits, u0 - 2, true, false);
                        uvlc_emit(vbits, u1 - 2, true, false);
                        uvlc_emit(vbits, u0 - 2, false, true);
                        uvlc_emit(vbits, u1 - 2, false, true);
                    } else if (u0 > 2) {
                        uvlc_emit(vbits, u0, true, false);
                        vbits.push_back(uint8_t(u1 - 1));
                        uvlc_emit(vbits, u0, false, true);
                    } else {
                        uvlc_emit(vbits, u0, false, false);
                        uvlc_emit(vbits, u1, false, false);
                    }
                } else if (mode == 1) {
                    uvlc_emit(vbits, u0, false, false);
                } else if (mode == 2) {
                    uvlc_emit(vbits, u1, false, false);
                }
            } else {
                if (mode == 3) {
                    uvlc_emit(vbits, u0, true, false);
                    uvlc_emit(vbits, u1, true, false);
                    uvlc_emit(vbits, u0, false, true);
                    uvlc_emit(vbits, u1, false, true);
                } else if (mode == 1) {
                    uvlc_emit(vbits, u0, false, false);
                } else if (mode == 2) {
                    uvlc_emit(vbits, u1, false, false);
                }
            }
            // MagSgn
            for (int j = 0; j < npair; ++j) {
                QInfo& Q = qi[j];
                for (int n = 0; n < 4; ++n) {
                    if (!((Q.rho >> n) & 1)) continue;
                    int m = Q.U - ((Q.ek >> n) & 1);
                    for (int i = 0; i < m; ++i)
                        msenc.put((Q.wv[n] >> i) & 1);
                }
            }
        }
        Eline.swap(nEline);
        sline.swap(nsline);
    }

    std::vector<uint8_t> ms = msenc.flush();
    std::vector<uint8_t> melb = mel.flush();
    std::vector<uint8_t> vlcb = pack_vlc(vbits);
    int scup = int(melb.size() + vlcb.size()) + 1;
    if (scup < 2 || scup > 4079) return -4;
    int Lcup = int(ms.size()) + scup;
    if (Lcup > out_cap) return -10;
    memcpy(out, ms.data(), ms.size());
    memcpy(out + ms.size(), melb.data(), melb.size());
    memcpy(out + ms.size() + melb.size(), vlcb.data(), vlcb.size());
    out[Lcup - 2] |= uint8_t(scup & 0xF);
    out[Lcup - 1] = uint8_t(scup >> 4);
    *lcup = Lcup;
    // B is fixed by the pass structure: the cleanup plane is p = B - 1,
    // so zero_bitplanes must be signaled as Mb - (p + 1). The caller must
    // pick Mb >= Umax + p (decoders check U_q <= zero_bitplanes + 1).
    *Bout = p + 1;
    *Umax_out = maxE;

    // refinement passes (num_passes == 3)
    *lref = 0;
    if (num_passes == 3) {
        FwdEnc spp;
        std::vector<uint8_t> mrpbits;
        std::vector<uint8_t> st(sig);
        for (int ys = 0; ys < h; ys += 4) {
            int ye = ys + 4 < h ? ys + 4 : h;
            for (int xg = 0; xg < w; xg += 4) {
                int xe = xg + 4 < w ? xg + 4 : w;
                int gx[16], gy[16], gn = 0;
                for (int x = xg; x < xe; ++x)
                    for (int y = ys; y < ye; ++y) {
                        size_t idx = size_t(y) * w + x;
                        if (st[idx]) continue;
                        bool member = false;
                        for (int dy = -1; dy <= 1 && !member; ++dy)
                            for (int dx = -1; dx <= 1; ++dx) {
                                if (!dx && !dy) continue;
                                int xx = x + dx, yy = y + dy;
                                if (xx >= 0 && xx < w && yy >= 0 && yy < h &&
                                    st[size_t(yy) * w + xx]) {
                                    member = true;
                                    break;
                                }
                            }
                        if (!member) continue;
                        int32_t v = coef[idx];
                        uint32_t m = uint32_t(v < 0 ? -int64_t(v) : v);
                        int b = (m >> (p - 1)) == 1 ? 1 : 0;
                        spp.put(b);
                        if (b) {
                            st[idx] = 1;
                            gx[gn] = x;
                            gy[gn] = y;
                            ++gn;
                        }
                    }
                for (int i = 0; i < gn; ++i) {
                    int32_t v = coef[size_t(gy[i]) * w + gx[i]];
                    spp.put(v < 0 ? 1 : 0);
                }
            }
        }
        for (int ys = 0; ys < h; ys += 4) {
            int ye = ys + 4 < h ? ys + 4 : h;
            for (int x = 0; x < w; ++x)
                for (int y = ys; y < ye; ++y) {
                    size_t idx = size_t(y) * w + x;
                    if (!sig[idx]) continue;
                    int32_t v = coef[idx];
                    uint32_t m = uint32_t(v < 0 ? -int64_t(v) : v);
                    mrpbits.push_back(uint8_t((m >> (p - 1)) & 1));
                }
        }
        std::vector<uint8_t> sppb = spp.flush();
        std::vector<uint8_t> mrpb = pack_mrp(mrpbits);
        int Lref = int(sppb.size() + mrpb.size());
        if (Lcup + Lref > out_cap) return -10;
        memcpy(out + Lcup, sppb.data(), sppb.size());
        memcpy(out + Lcup + sppb.size(), mrpb.data(), mrpb.size());
        *lref = Lref;
    }
    return 0;
}

}  // extern "C"
