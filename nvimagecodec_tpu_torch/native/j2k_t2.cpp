// Native JPEG2000 Tier-2 packet-header parser (ITU-T T.800 B.9-B.12) and
// the code-block rows Tier-1 reads.
//
// One context a tile holds every precinct-band's tag trees and, for every
// code-block, its rectangle (laid out from the band, precinct and
// code-block sizes as codestream.py's cblk_grid_precinct does), inclusion,
// zero bit-planes, passes, Lblock and codeword segments across layers. A
// segment is kept as (offset, length) ranges of the tile data (the body
// stream under PPT/PPM): a continuation adjacent to the range before it
// extends that range, any other is a range of its own, joined to the rest
// when the rows are written. The progression order stays in Python, which
// hands the tile's packets over in one call (`tic_t2_read_packets`);
// `tic_t2_rows` then writes the row of every code-block Tier-1 decodes, so
// no step a code-block or a segment runs in the interpreter.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitRd {
    const uint8_t* d;
    int64_t len, pos;
    uint32_t acc;
    int n;
    bool prev_ff;

    void init(const uint8_t* data, int64_t l, int64_t p) {
        d = data; len = l; pos = p; acc = 0; n = 0; prev_ff = false;
    }
    int bit() {
        if (n == 0) {
            uint8_t b = pos < len ? d[pos] : 0;
            pos++;
            n = prev_ff ? 7 : 8;  // stuffed byte's MSB is 0 by construction
            prev_ff = (b == 0xFF);
            acc = b;
        }
        n--;
        return (acc >> n) & 1;
    }
    uint32_t bits(int k) {
        uint32_t v = 0;
        while (k--) v = (v << 1) | (uint32_t)bit();
        return v;
    }
    void align() {
        n = 0;
        if (prev_ff) { pos++; prev_ff = false; }
    }
};

// A tile's tag-tree nodes: each node's lower bound and whether it is
// coded, every tree's nodes in one run.
struct TagNodes {
    std::vector<int32_t> low;
    std::vector<uint8_t> coded;
};

// T.800 B.10.2 tag tree, decoder side (mirrors tagtree.py exactly); its
// nodes are `base` on in the tile's TagNodes, level by level from the
// leaves.
struct TagT {
    int w = 1, nlev = 0;
    int offs[32], lws[32];
    int64_t base = 0;

    void init(int W, int H, TagNodes& nodes) {
        w = W;
        nlev = 0;
        int lw = W, lh = H, acc = 0;
        for (;;) {
            offs[nlev] = acc;
            lws[nlev++] = lw;
            acc += lw * lh;
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        base = (int64_t)nodes.low.size();
        nodes.low.resize(nodes.low.size() + acc, 0);
        nodes.coded.resize(nodes.coded.size() + acc, 0);
    }
    // returns true iff leaf value < threshold
    bool decode(BitRd& br, int x, int y, int threshold, TagNodes& nodes) {
        int32_t* low = nodes.low.data() + base;
        uint8_t* coded = nodes.coded.data() + base;
        int32_t lo = 0;
        int idx = 0;
        for (int level = nlev - 1; level >= 0; level--) {
            int lx = x >> level, ly = y >> level;
            idx = offs[level] + ly * lws[level] + lx;
            if (low[idx] < lo) low[idx] = lo;
            while (!coded[idx] && low[idx] < threshold) {
                if (br.bit()) coded[idx] = 1;
                else low[idx]++;
            }
            lo = low[idx];
        }
        return coded[idx] && lo < threshold;
    }
    int32_t leaf(int x, int y, const TagNodes& nodes) const {
        return nodes.low[base + y * w + x];
    }
};

// One range of a codeword segment; `first` starts a segment. A block's
// ranges are a list through `next` (-1 ends it) in the context's pool.
struct Piece {
    int64_t off, len;
    int32_t next;
    bool first;
};

struct CbState {
    uint8_t included = 0;
    int32_t zero_bps = 0;
    int32_t num_passes = 0;
    int32_t lblock = 3;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int32_t head = -1, tail = -1;  // its first and last range
};

struct PrecBand {
    TagT incl, zbp;
    int nx, ny;
    int cb_base;  // global code-block id of (0,0)
};

struct T2Ctx {
    std::vector<PrecBand> bands;
    std::vector<CbState> cbs;
    TagNodes nodes;             // every precinct-band's two trees
    std::vector<Piece> pieces;  // every block's ranges
    std::vector<int64_t> body;  // a packet's length fields, reused
    std::vector<Piece> scratch;  // one block's ranges in order, reused
    std::vector<uint8_t> side;   // the rows' side area
};

// a / b rounded up and down, b > 0 (Python's -(-a // b) and a // b)
static inline int64_t ceil_div(int64_t a, int64_t b) {
    return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

static inline int64_t floor_div(int64_t a, int64_t b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

static int npasses_read(BitRd& br) {
    if (!br.bit()) return 1;
    if (!br.bit()) return 2;
    uint32_t v = br.bits(2);
    if (v < 3) return 3 + (int)v;
    v = br.bits(5);
    if (v < 31) return 6 + (int)v;
    return 37 + (int)br.bits(7);
}

static inline int floor_log2(int n) {
    int r = -1;
    while (n) { r++; n >>= 1; }
    return r;
}

// Part-1 selective-bypass raw passes: pass p (0-based, cumulative) is
// raw-coded when BYPASS (0x01) is on, p >= 10 and p is not a cleanup pass.
static inline bool t2_pass_is_raw(int style, int p) {
    return (style & 0x01) && p >= 10 && (p % 3) != 0;
}

// A codeword-segment termination occurs after pass p under TERMALL (0x04)
// always, and under BYPASS at every MQ<->raw coder switch (T.800 B.10.7.2).
static inline bool t2_terminated_after(int style, int p) {
    if (style & 0x04) return true;
    if (!(style & 0x01)) return false;
    return t2_pass_is_raw(style, p) != t2_pass_is_raw(style, p + 1);
}

// The native Tier-1 decoder's check of a TERMALL/BYPASS blob
// (native/j2k_t1.cpp): [i32 count 1..112][i32 lengths][the segments],
// every length within what follows.
static bool blob_ok(const uint8_t* b, int64_t len) {
    if (len < 4) return false;
    int32_t ns;
    std::memcpy(&ns, b, 4);
    if (ns < 1 || ns > 112 || len < 4 + 4 * (int64_t)ns) return false;
    int64_t remain = len - 4 - 4 * (int64_t)ns;
    for (int i = 0; i < ns; i++) {
        int32_t sl;
        std::memcpy(&sl, b + 4 + 4 * i, 4);
        if (sl < 0 || sl > remain) return false;
        remain -= sl;
    }
    return true;
}

// That decoder's other rules on a part-1 row (ops/j2k_t1.py ROW: segment
// offset and length, w, h, band | style << 8, bit-planes, passes, stride).
static bool dims_ok(const int32_t* row) {
    return row[2] >= 1 && row[2] <= 4096 && row[3] >= 1 && row[3] <= 4096 &&
           row[5] >= 0 && row[5] <= 31 && row[6] >= 0 && row[7] >= row[2];
}

// Writes the n pieces of a code-block's segments to `o`: their bytes
// joined, or, as a blob, [i32 count][i32 lengths][the segments] (one empty
// segment where there is none). Returns the bytes written.
static int64_t put_segments(const Piece* p, size_t n, const uint8_t* data,
                            uint8_t* o, bool blob) {
    uint8_t* const start = o;
    if (blob) {
        int32_t ns = 0;
        for (size_t i = 0; i < n; i++) ns += p[i].first;
        if (ns == 0) {
            const int32_t empty[2] = {1, 0};
            std::memcpy(o, empty, 8);
            return 8;
        }
        std::memcpy(o, &ns, 4);
        int32_t l = 0;
        int k = 0;
        for (size_t i = 0; i < n; i++) {
            if (p[i].first && i > 0) {
                std::memcpy(o + 4 + 4 * k++, &l, 4);
                l = 0;
            }
            l += (int32_t)p[i].len;
        }
        std::memcpy(o + 4 + 4 * k, &l, 4);
        o += 4 + 4 * (int64_t)ns;
    }
    for (size_t i = 0; i < n; i++) {
        std::memcpy(o, data + p[i].off, (size_t)p[i].len);
        o += p[i].len;
    }
    return o - start;
}

// A segment as a row gives it: offset (from the start of the caller's
// data) and length.
struct Placed {
    int64_t off, len;
};

}  // namespace

extern "C" {

void* tic_t2_create() { return new T2Ctx(); }

void tic_t2_free(void* h) { delete (T2Ctx*)h; }

// Registers one precinct-band: the band's rectangle `b` (x0, y0, x1, y1)
// at resolution r with precinct exponents PPx, PPy, the precinct's
// rectangle `pr` in resolution coordinates and the code-block size cw x
// ch. Lays out its code-blocks (T.800 B.7, as codestream.py's
// cblk_grid_precinct: the precinct mapped into the band, halved above
// r = 0, and the code-block grid anchored at 0 with sides of
// min(code-block, precinct-in-band)).
static void add_precband(T2Ctx* c, const int32_t* b, int r, int ppx,
                         int ppy, const int64_t* pr, int cw, int ch) {
    const int s = r == 0 ? 0 : 1;
    int64_t ecw = cw, ech = ch;
    const int64_t pw = int64_t(1) << (ppx > s ? ppx - s : 0);
    const int64_t ph = int64_t(1) << (ppy > s ? ppy - s : 0);
    if (pw < ecw) ecw = pw;
    if (ph < ech) ech = ph;
    int64_t bx0 = pr[0] >> s, by0 = pr[1] >> s;
    int64_t bx1 = ceil_div(pr[2], int64_t(1) << s);
    int64_t by1 = ceil_div(pr[3], int64_t(1) << s);
    if (bx0 < b[0]) bx0 = b[0];
    if (by0 < b[1]) by0 = b[1];
    if (bx1 > b[2]) bx1 = b[2];
    if (by1 > b[3]) by1 = b[3];
    int nx = 0, ny = 0;
    int64_t gx0 = 0, gy0 = 0;
    if (bx1 > bx0 && by1 > by0) {
        gx0 = floor_div(bx0, ecw) * ecw;
        gy0 = floor_div(by0, ech) * ech;
        nx = (int)ceil_div(bx1 - gx0, ecw);
        ny = (int)ceil_div(by1 - gy0, ech);
    }
    PrecBand pb;
    pb.incl.init(nx > 0 ? nx : 1, ny > 0 ? ny : 1, c->nodes);
    pb.zbp.init(nx > 0 ? nx : 1, ny > 0 ? ny : 1, c->nodes);
    pb.nx = nx;
    pb.ny = ny;
    pb.cb_base = (int)c->cbs.size();
    c->cbs.resize(c->cbs.size() + size_t(nx) * ny);
    for (int j = 0; j < ny; j++)
        for (int i = 0; i < nx; i++) {
            CbState& cb = c->cbs[pb.cb_base + j * nx + i];
            const int64_t x0 = gx0 + i * ecw, y0 = gy0 + j * ech;
            cb.x0 = (int32_t)(x0 > bx0 ? x0 : bx0);
            cb.y0 = (int32_t)(y0 > by0 ? y0 : by0);
            cb.x1 = (int32_t)(x0 + ecw < bx1 ? x0 + ecw : bx1);
            cb.y1 = (int32_t)(y0 + ech < by1 ? y0 + ech : by1);
        }
    c->bands.push_back(pb);
}

// Registers the precinct-bands of n resolutions, a tile's in (component,
// resolution) order, 22 int32 each: the resolution's rectangle (x0, y0,
// x1, y1), r, the precinct exponents PPx and PPy, the code-block width and
// height, its band count (1 or 3) and each band's rectangle. A
// resolution's precincts (T.800 B.6: a grid of 2^PPx x 2^PPy anchored at
// 0, clipped to the resolution, as codestream.py's precinct_rect) go in
// raster order, each with its bands in order. The ids of the
// precinct-bands follow from 0 in that order.
void tic_t2_add_resolutions(void* h, int n, const int32_t* g) {
    T2Ctx* c = (T2Ctx*)h;
    for (int k = 0; k < n; k++, g += 22) {
        const int ppx = g[5], ppy = g[6];
        int64_t npx = 0, npy = 0;
        if (g[2] > g[0] && g[3] > g[1]) {
            npx = ceil_div(g[2], int64_t(1) << ppx) - (g[0] >> ppx);
            npy = ceil_div(g[3], int64_t(1) << ppy) - (g[1] >> ppy);
        }
        for (int64_t p = 0; p < npx * npy; p++) {
            const int64_t gx = ((g[0] >> ppx) + p % npx) << ppx;
            const int64_t gy = ((g[1] >> ppy) + p / npx) << ppy;
            const int64_t pr[4] = {
                gx > g[0] ? gx : g[0], gy > g[1] ? gy : g[1],
                gx + (int64_t(1) << ppx) < g[2] ? gx + (int64_t(1) << ppx)
                                                : g[2],
                gy + (int64_t(1) << ppy) < g[3] ? gy + (int64_t(1) << ppy)
                                                : g[3]};
            for (int bi = 0; bi < g[9]; bi++)
                add_precband(c, g + 10 + 4 * bi, g[4], ppx, ppy, pr, g[7],
                             g[8]);
        }
    }
}

// Parses one packet at *pos and keeps its codeword segments. band_ids: the
// packet's precinct-bands in band order. ht_style: the code-block style
// bits 0x45 (0x40 the HT two-segment rule, 0x05 part-1 TERMALL/BYPASS
// terminations). Returns the length fields read (>= 0) or a negative
// error:
//   -1 runaway zero-bitplane tree, -2 runaway Lblock,
//   -3 absurd segment length, -4 body past end, -5 more length fields than
//   a packet of these code-blocks carries (2 a block, 110 under
//   TERMALL/BYPASS, and 8).
// flags: bit 0 = SOP markers may precede packets (Scod bit 1),
//        bit 1 = EPH marker terminates every packet header (Scod bit 2)
// body/body_len/body_pos: when non-NULL, packet headers come from `data`
// (a PPT packed-header buffer) while the codeword segments live in the
// separate body stream (T.800 A.7.5); otherwise bodies follow the header.
// A segment's offset counts from the start of the stream it lies in. After
// an error the context is part-way through a packet: the tile's decode
// ends there.
static int read_packet(T2Ctx* c, const uint8_t* data, int64_t len,
                       int64_t* pos, int layer, const int32_t* band_ids,
                       int nbands, int ht_style, int flags,
                       const uint8_t* bodyd, int64_t body_len,
                       int64_t* body_pos) {
    if (flags & 1) {  // SOP precedes the packet in the BODY stream
        const uint8_t* sd = bodyd ? bodyd : data;
        int64_t slen = bodyd ? body_len : len;
        int64_t* sp = bodyd ? body_pos : pos;
        if (*sp + 6 <= slen && sd[*sp] == 0xFF && sd[*sp + 1] == 0x91)
            *sp += 6;  // SOP: FF91 Lsop(=4) Nsop(2) — optional per packet
    }
    BitRd br;
    br.init(data, len, *pos);
    if (!br.bit()) {  // empty packet
        br.align();
        *pos = br.pos;
        if ((flags & 2) && *pos + 2 <= len && data[*pos] == 0xFF &&
            data[*pos + 1] == 0x92)
            *pos += 2;  // EPH after the (empty) packet header
        return 0;
    }
    // (cb_id | continuation << 62, seg_len) body reads, order preserved
    std::vector<int64_t>& body = c->body;
    body.clear();
    int64_t ncb_all = 0;
    for (int b = 0; b < nbands; b++) {
        PrecBand& pb = c->bands[band_ids[b]];
        int ncb = pb.nx * pb.ny;
        ncb_all += ncb;
        for (int idx = 0; idx < ncb; idx++) {
            CbState& cb = c->cbs[pb.cb_base + idx];
            int x = pb.nx > 0 ? idx % pb.nx : 0;
            int y = pb.nx > 0 ? idx / pb.nx : 0;
            bool inc;
            if (!cb.included)
                inc = pb.incl.decode(br, x, y, layer + 1, c->nodes);
            else
                inc = br.bit() != 0;
            if (!inc) continue;
            if (!cb.included) {
                // one walk to the leaf reads the bits that thresholds 1,
                // 2, ... would (each node's until it is coded); a value
                // of 64 or more is a runaway tree
                if (!pb.zbp.decode(br, x, y, 64, c->nodes)) return -1;
                cb.zero_bps = pb.zbp.leaf(x, y, c->nodes);
                cb.included = 1;
            }
            int npasses = npasses_read(br);
            while (br.bit()) {
                if (++cb.lblock > 32) return -2;
            }
            // Segment grouping: HT (0x40) uses the T.814 two-segment
            // rule; part-1 TERMALL/BYPASS (0x05) starts a new codeword
            // segment after every termination; plain MQ is one segment.
            int groups[176];
            bool cont_flag[176] = {false};
            int ngroups;
            if ((ht_style & 0x40) && cb.num_passes == 0 && npasses > 1) {
                groups[0] = 1; groups[1] = npasses - 1; ngroups = 2;
            } else if (ht_style & 0x05) {
                // one length field per termination-delimited group of the
                // NEW passes; a group whose first pass does not follow a
                // termination continues the segment from a prior layer
                ngroups = 0;
                int cnt = 0;
                int last = cb.num_passes + npasses - 1;
                for (int pp = cb.num_passes; pp <= last; pp++) {
                    cnt++;
                    if (pp == last || t2_terminated_after(ht_style, pp)) {
                        if (ngroups >= 176) return -3;
                        int start = pp - cnt + 1;
                        bool cont = start > 0 &&
                            !t2_terminated_after(ht_style, start - 1);
                        groups[ngroups] = cnt;
                        cont_flag[ngroups++] = cont;
                        cnt = 0;
                    }
                }
            } else {
                groups[0] = npasses; ngroups = 1;
            }
            for (int g = 0; g < ngroups; g++) {
                int nbits = cb.lblock + floor_log2(groups[g]);
                if (nbits > 32) return -3;
                uint32_t seg_len = br.bits(nbits);
                body.push_back((int64_t)(pb.cb_base + idx) |
                               (cont_flag[g] ? (int64_t)1 << 62 : 0));
                body.push_back((int64_t)seg_len);
            }
            cb.num_passes += npasses;
        }
    }
    br.align();
    const int64_t body_n = (int64_t)body.size() / 2;
    if (body_n > 8 + ((ht_style & 0x05) ? 110 : 2) * ncb_all) return -5;
    int64_t p = br.pos;
    if ((flags & 2) && p + 2 <= len && data[p] == 0xFF && data[p + 1] == 0x92)
        p += 2;  // EPH terminates the packet header
    if (bodyd) {
        *pos = p;  // header buffer position advances independently
        p = *body_pos;
        len = body_len;
    }
    int64_t end = p;
    for (int64_t i = 0; i < body_n; i++) {
        if (end + body[2 * i + 1] > len) return -4;
        end += body[2 * i + 1];
    }
    for (int64_t i = 0; i < body_n; i++) {
        const int64_t id = body[2 * i] & (((int64_t)1 << 62) - 1);
        const bool cont = (body[2 * i] >> 62) & 1;
        const int64_t ln = body[2 * i + 1];
        CbState& cb = c->cbs[id];
        if (cont && cb.tail >= 0 &&
            c->pieces[cb.tail].off + c->pieces[cb.tail].len == p) {
            c->pieces[cb.tail].len += ln;
        } else {
            const bool first = !(cont && cb.tail >= 0);
            const int32_t k = (int32_t)c->pieces.size();
            c->pieces.push_back({p, ln, -1, first});
            if (cb.tail >= 0) c->pieces[cb.tail].next = k;
            else cb.head = k;
            cb.tail = k;
        }
        p += ln;
    }
    if (bodyd) *body_pos = p;
    else *pos = p;
    return (int)body_n;
}

// Reads a tile's n packets in progression order, 4 int32 each: the
// layer, the first of its precinct-bands' ids (the others follow), their
// count and the code-block style bits 0x45. data/len: the tile data, or,
// with a body stream (PPT/PPM), the packed headers. Returns 0, a negative
// error of read_packet, or -6 where a packet starts past the end of the
// headers. A segment's offset counts from the start of the tile data (the
// body stream).
int tic_t2_read_packets(void* h, const uint8_t* data, int64_t len,
                        const uint8_t* body, int64_t body_len,
                        const int32_t* pk, int n, int flags) {
    T2Ctx* c = (T2Ctx*)h;
    int64_t pos = 0, body_pos = 0;
    std::vector<int32_t> ids;
    for (int i = 0; i < n; i++, pk += 4) {
        if (pos > len) return -6;
        ids.resize(pk[2]);
        for (int b = 0; b < pk[2]; b++) ids[b] = pk[1] + b;
        const int rc = read_packet(c, data, len, &pos, pk[0], ids.data(),
                                   pk[2], pk[3], flags, body, body_len,
                                   body ? &body_pos : nullptr);
        if (rc < 0) return rc;
    }
    return 0;
}

// The tile's code-blocks: the most rows of each kind `tic_t2_rows` writes.
int64_t tic_t2_blocks(void* h) { return (int64_t)((T2Ctx*)h)->cbs.size(); }

// Copies the side area the last `tic_t2_rows` wrote to dst.
void tic_t2_side(void* h, uint8_t* dst) {
    T2Ctx* c = (T2Ctx*)h;
    std::memcpy(dst, c->side.data(), c->side.size());
}

// The row of every code-block with a pass that Tier-1 decodes, band after
// band, each band's precinct-bands in turn, each in raster order. specs:
// nspecs bands, 16 int64 each: kind (0 part-1, 1 HT), the element offset
// of the band's plane and its row stride, the band type, Mb (the band's
// magnitude bit-planes), the code-block style (with 0x80, a 9/7 band's
// mid-interval reconstruction, native/j2k_t1.cpp), the band's x0 and y0, a
// region flag and the region (y0, x0, y1, x1; a block wholly outside it is
// left out), the band's first precinct-band id, their count and the step
// between their ids. data/len: the tile data (or body stream), which the
// caller's data holds at `base`, followed at base + len by the side area
// (`tic_t2_side`).
//   t1: a part-1 block's row, 10 int32 (ops/j2k_t1.py ROW): segment offset
//     and length, w, h, band | style << 8, bit-planes, passes, the row
//     stride, the destination's element offset (low, high 32 bits). The
//     segment is a range of the tile where the block has one of one range,
//     else its segments joined in the side area, or, under TERMALL/BYPASS,
//     their blob [i32 count][i32 lengths][the segments] there.
//   ht: an HT block's row, 12 int32: its cleanup segment and the others
//     joined (offset and length each, placed as above), passes, w, h, B,
//     Ucap, the stride and the destination.
// out: [part-1 rows, HT rows, side bytes, the first part-1 row the native
// decoder would refuse or whose range leaves the tile (-1 none)]. t1 and
// ht hold tic_t2_blocks rows each.
void tic_t2_rows(void* h, const uint8_t* data, int64_t len, int64_t base,
                 const int64_t* specs, int nspecs, int32_t* t1, int32_t* ht,
                 int64_t* out) {
    T2Ctx* c = (T2Ctx*)h;
    int64_t n1 = 0, n2 = 0, bad = -1;
    std::vector<uint8_t>& side = c->side;
    side.clear();
    const int64_t side_base = base + len;
    // a segment of one range stays in the tile; any other goes to `side`
    auto put = [&](const Piece* q, size_t n, bool as_blob) -> Placed {
        if (n == 1 && !as_blob) return {base + q[0].off, q[0].len};
        int64_t need = as_blob ? 8 + 4 * (int64_t)n : 0;
        for (size_t i = 0; i < n; i++) need += q[i].len;
        const int64_t at = (int64_t)side.size();
        side.resize(at + need);
        const int64_t w = put_segments(q, n, data, side.data() + at, as_blob);
        side.resize(at + w);
        return {side_base + at, w};
    };
    for (int s = 0; s < nspecs; s++) {
        const int64_t* sp = specs + 16 * s;
        const int64_t plane = sp[1], stride = sp[2];
        const int btype = (int)sp[3], mb = (int)sp[4];
        // the part-1 mode switches and the mid-interval bit of a 9/7 block
        const int style = (int)sp[5] & 0xAF;
        const bool blob = (style & 0x05) != 0;
        for (int64_t k = 0; k < sp[14]; k++) {
            const PrecBand& pb = c->bands[sp[13] + k * sp[15]];
            for (int i = 0; i < pb.nx * pb.ny; i++) {
                const CbState& cb = c->cbs[pb.cb_base + i];
                if (!cb.included || cb.num_passes == 0) continue;
                if (sp[8] && (cb.y1 <= sp[9] || cb.x1 <= sp[10] ||
                              cb.y0 >= sp[11] || cb.x0 >= sp[12]))
                    continue;
                const int64_t dest = plane + (cb.y0 - sp[7]) * stride +
                                     (cb.x0 - sp[6]);
                std::vector<Piece>& q = c->scratch;
                q.clear();
                for (int32_t k = cb.head; k >= 0; k = c->pieces[k].next)
                    q.push_back(c->pieces[k]);
                const Piece* p = q.data();
                const size_t np = q.size();
                int32_t* row;
                if (sp[0] == 1) {
                    size_t e1 = np;  // the cleanup segment's pieces end
                    for (size_t j = 1; j < np; j++)
                        if (p[j].first) { e1 = j; break; }
                    const Placed cup = put(p, e1, false);
                    const Placed ref = put(p + e1, np - e1, false);
                    row = ht + 12 * n2++;
                    row[0] = (int32_t)cup.off; row[1] = (int32_t)cup.len;
                    row[2] = (int32_t)ref.off; row[3] = (int32_t)ref.len;
                    row[4] = cb.num_passes;
                    row[5] = cb.x1 - cb.x0; row[6] = cb.y1 - cb.y0;
                    row[7] = mb - cb.zero_bps; row[8] = cb.zero_bps + 1;
                    row[9] = (int32_t)stride;
                    std::memcpy(row + 10, &dest, 8);
                    continue;
                }
                const Placed seg = put(p, np, blob);
                row = t1 + 10 * n1;
                row[0] = (int32_t)seg.off; row[1] = (int32_t)seg.len;
                row[2] = cb.x1 - cb.x0; row[3] = cb.y1 - cb.y0;
                row[4] = btype | (style << 8);
                row[5] = mb - cb.zero_bps > 0 ? mb - cb.zero_bps : 0;
                row[6] = cb.num_passes;
                row[7] = (int32_t)stride;
                std::memcpy(row + 8, &dest, 8);
                bool ok = dims_ok(row) && row[7] == stride;
                if (blob)
                    ok = ok && blob_ok(side.data() + (seg.off - side_base),
                                       seg.len);
                else if (np == 1)
                    ok = ok && p[0].off >= 0 && p[0].len >= 0 &&
                         p[0].off + p[0].len <= len;
                if (!ok && bad < 0) bad = n1;
                n1++;
            }
        }
    }
    out[0] = n1;
    out[1] = n2;
    out[2] = (int64_t)side.size();
    out[3] = bad;
}

// The first of n part-1 rows (ops/j2k_t1.py ROW) the native decoder would
// refuse or whose segment leaves `data` (len bytes); -1 for none.
int64_t tic_t1_rows_check(const int32_t* rows, int64_t n,
                          const uint8_t* data, int64_t len) {
    for (int64_t i = 0; i < n; i++) {
        const int32_t* row = rows + 10 * i;
        bool ok = dims_ok(row) && row[0] >= 0 && row[1] >= 0 &&
                  (int64_t)row[0] + row[1] <= len;
        if (ok && ((row[4] >> 8) & 0x05)) ok = blob_ok(data + row[0], row[1]);
        if (!ok) return i;
    }
    return -1;
}

}  // extern "C"

// ----------------------------------------------------------- encoder side
// Native packet-header WRITER (T.800 B.10) — the symmetric move to the
// reader above: tag-tree emission + lblock/npasses signaling were ~25% of
// encode wall time in Python. State (tag trees, inclusion, lblock)
// persists in the context across layers exactly like PacketEncoder's.

namespace {

struct BitWr {
    std::vector<uint8_t> out;
    uint32_t acc = 0;
    int n = 0, limit = 8;

    void bit(int b) {
        acc = (acc << 1) | (uint32_t)(b & 1);
        if (++n == limit) {
            out.push_back((uint8_t)acc);
            limit = out.back() == 0xFF ? 7 : 8;
            acc = 0;
            n = 0;
        }
    }
    void bits(uint32_t v, int k) {
        while (k--) bit((int)((v >> k) & 1));
    }
    void flush() {
        while (n) bit(0);
        if (!out.empty() && out.back() == 0xFF) out.push_back(0);
    }
};

// Tag tree, encoder side (mirrors tagtree.py TagTree exactly)
struct TagTE {
    int w = 1, h = 1;
    std::vector<int> offs, lws, lhs;
    std::vector<int32_t> value, low;
    std::vector<uint8_t> coded;

    void init(int W, int H, const int32_t* leaves) {
        w = W; h = H;
        offs.clear(); lws.clear(); lhs.clear();
        int lw = W, lh = H, acc = 0;
        for (;;) {
            offs.push_back(acc);
            lws.push_back(lw);
            lhs.push_back(lh);
            acc += lw * lh;
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        value.assign(acc, 0);
        low.assign(acc, 0);
        coded.assign(acc, 0);
        for (int i = 0; i < W * H; i++) value[i] = leaves[i];
        for (size_t level = 1; level < offs.size(); level++) {
            int pw = lws[level - 1], ph = lhs[level - 1];
            int cw = lws[level], ch = lhs[level];
            for (int y = 0; y < ch; y++)
                for (int x = 0; x < cw; x++) {
                    int32_t best = INT32_MAX;
                    for (int dy = 0; dy < 2; dy++)
                        for (int dx = 0; dx < 2; dx++) {
                            int cx = 2 * x + dx, cy = 2 * y + dy;
                            if (cx < pw && cy < ph) {
                                int32_t v =
                                    value[offs[level - 1] + cy * pw + cx];
                                if (v < best) best = v;
                            }
                        }
                    value[offs[level] + y * cw + x] =
                        best == INT32_MAX ? 0 : best;
                }
        }
    }

    void encode(BitWr& bw, int x, int y, int threshold) {
        int nlev = (int)offs.size();
        int32_t lo = 0;
        for (int level = nlev - 1; level >= 0; level--) {
            int lx = x >> level, ly = y >> level;
            int i = offs[level] + ly * lws[level] + lx;
            if (low[i] < lo) low[i] = lo;
            int32_t v = value[i];
            while (!coded[i] && low[i] < threshold) {
                if (low[i] == v) {
                    coded[i] = 1;
                    bw.bit(1);
                } else {
                    bw.bit(0);
                    low[i]++;
                }
            }
            lo = coded[i] ? (low[i] > v ? low[i] : v) : low[i];
        }
    }

    bool leaf_coded(int x, int y) const { return coded[y * w + x] != 0; }
};

struct CbEState {
    uint8_t included = 0;
    int32_t lblock = 3;
};

struct EPrecBand {
    TagTE incl, zbp;
    int nx, ny;
    std::vector<CbEState> cbs;
};

struct T2ECtx {
    std::vector<EPrecBand> bands;
};

static void npasses_write(BitWr& bw, int n) {
    if (n == 1) bw.bit(0);
    else if (n == 2) bw.bits(0b10, 2);
    else if (n <= 5) { bw.bits(0b11, 2); bw.bits((uint32_t)(n - 3), 2); }
    else if (n <= 36) { bw.bits(0b1111, 4); bw.bits((uint32_t)(n - 6), 5); }
    else { bw.bits(0b111111111, 9); bw.bits((uint32_t)(n - 37), 7); }
}

static inline int bit_length(int n) {
    int r = 0;
    while (n) { r++; n >>= 1; }
    return r;
}

}  // namespace

extern "C" {

void* tic_t2e_create() { return new T2ECtx(); }

void tic_t2e_free(void* h) { delete (T2ECtx*)h; }

// Register one (component, resolution, precinct, band) grid; tag trees are
// seeded with the per-code-block first-inclusion layer and zero-bitplane
// counts (raster order). Returns the band id.
int tic_t2e_add_precband(void* h, int nx, int ny,
                         const int32_t* first_layer,
                         const int32_t* zero_bps) {
    T2ECtx* ctx = (T2ECtx*)h;
    ctx->bands.emplace_back();
    EPrecBand& pb = ctx->bands.back();
    pb.nx = nx > 0 ? nx : 1;
    pb.ny = ny > 0 ? ny : 1;
    int n = pb.nx * pb.ny;
    if (nx * ny > 0) {
        pb.incl.init(pb.nx, pb.ny, first_layer);
        pb.zbp.init(pb.nx, pb.ny, zero_bps);
    }
    pb.cbs.assign((size_t)(n > 0 ? n : 1), CbEState());
    return (int)ctx->bands.size() - 1;
}

// Write one packet header. band_ids: the precinct's bands in order.
// meta: per code-block, raster order across those bands, 7 int32s:
//   [contributes, npasses, nsegs, len0, np0, len1, np1]
// ncbs_per_band: code-block count per band (nx*ny, 0 allowed).
// out/cap: header bytes. Returns header length, or -1 on overflow.
int tic_t2e_write_packet(void* h, const int32_t* band_ids, int nbands,
                         const int32_t* ncbs_per_band, int layer,
                         const int32_t* meta, uint8_t* out, int cap) {
    T2ECtx* ctx = (T2ECtx*)h;
    BitWr bw;
    bw.out.reserve(256);
    int total = 0;
    for (int b = 0; b < nbands; b++) total += ncbs_per_band[b];
    bool any = false;
    for (int i = 0; i < total; i++)
        if (meta[7 * i]) { any = true; break; }
    if (!any) {
        bw.bit(0);
        bw.flush();
        if ((int)bw.out.size() > cap) return -1;
        std::memcpy(out, bw.out.data(), bw.out.size());
        return (int)bw.out.size();
    }
    bw.bit(1);
    const int32_t* m = meta;
    for (int b = 0; b < nbands; b++) {
        EPrecBand& pb = ctx->bands[band_ids[b]];
        int ncb = ncbs_per_band[b];
        for (int idx = 0; idx < ncb; idx++, m += 7) {
            int x = idx % pb.nx, y = idx / pb.nx;
            int contributes = m[0];
            CbEState& st = pb.cbs[idx];
            if (!st.included) {
                pb.incl.encode(bw, x, y, layer + 1);
                if (!contributes) continue;
                for (int k = 1;; k++) {
                    pb.zbp.encode(bw, x, y, k);
                    if (pb.zbp.leaf_coded(x, y)) break;
                }
                st.included = 1;
            } else {
                bw.bit(contributes);
                if (!contributes) continue;
            }
            npasses_write(bw, m[1]);
            int nsegs = m[2];
            int need = 1;
            for (int sgi = 0; sgi < nsegs; sgi++) {
                int len = m[3 + 2 * sgi];
                int np = m[4 + 2 * sgi];
                int nb = bit_length(len > 1 ? len : 1) - floor_log2(np);
                if (nb > need) need = nb;
            }
            while (st.lblock < need) {
                bw.bit(1);
                st.lblock++;
            }
            bw.bit(0);
            for (int sgi = 0; sgi < nsegs; sgi++) {
                int len = m[3 + 2 * sgi];
                int np = m[4 + 2 * sgi];
                bw.bits((uint32_t)len, st.lblock + floor_log2(np));
            }
        }
    }
    bw.flush();
    if ((int)bw.out.size() > cap) return -1;
    std::memcpy(out, bw.out.data(), bw.out.size());
    return (int)bw.out.size();
}

}  // extern "C"
