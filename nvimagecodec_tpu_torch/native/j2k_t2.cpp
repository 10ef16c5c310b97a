// Native JPEG2000 Tier-2 packet-header parser (ITU-T T.800 B.9-B.12).
//
// Port of the bit-level half of codecs/jpeg2000/t2.py's PacketDecoder
// (tag trees, inclusion, zero-bitplanes, pass counts, Lblock, segment
// lengths) — semantics kept bit-identical; the progression-order packet
// ITERATION and all geometry stay in Python. Profiling showed the
// Python header parse at ~40% of HTJ2K decode wall time (88k tag-tree
// node visits per 1024x1024 image); the reference hands this to
// nvjpeg2k's internal parser, this is the host analog.
//
// Handle-based: one context per tile holds every precinct-band's tag
// trees and per-code-block state across layers.

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

// T.800 B.10.2 tag tree, decoder side (mirrors tagtree.py exactly).
struct TagT {
    int w = 1, h = 1;
    std::vector<int> offs, lws;
    std::vector<int32_t> low;
    std::vector<uint8_t> coded;

    void init(int W, int H) {
        w = W; h = H;
        offs.clear(); lws.clear();
        int lw = W, lh = H, acc = 0;
        for (;;) {
            offs.push_back(acc);
            lws.push_back(lw);
            acc += lw * lh;
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        low.assign(acc, 0);
        coded.assign(acc, 0);
    }
    // returns true iff leaf value < threshold
    bool decode(BitRd& br, int x, int y, int threshold) {
        int nlev = (int)offs.size();
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
    int32_t leaf(int x, int y) const { return low[y * w + x]; }
};

struct CbState {
    uint8_t included = 0;
    int32_t zero_bps = 0;
    int32_t num_passes = 0;
    int32_t lblock = 3;
};

struct PrecBand {
    TagT incl, zbp;
    int nx, ny;
    int cb_base;  // global code-block id of (0,0)
};

struct T2Ctx {
    std::vector<PrecBand> bands;
    std::vector<CbState> cbs;
};

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

}  // namespace

extern "C" {

void* tic_t2_create() { return new T2Ctx(); }

void tic_t2_free(void* h) { delete (T2Ctx*)h; }

// Register one precinct-band (nx x ny code-blocks; nx/ny may be 0).
// Returns its band id.
int tic_t2_add_precband(void* h, int nx, int ny) {
    T2Ctx* c = (T2Ctx*)h;
    PrecBand pb;
    pb.incl.init(nx > 0 ? nx : 1, ny > 0 ? ny : 1);
    pb.zbp.init(nx > 0 ? nx : 1, ny > 0 ? ny : 1);
    pb.nx = nx;
    pb.ny = ny;
    pb.cb_base = (int)c->cbs.size();
    c->cbs.resize(c->cbs.size() + size_t(nx > 0 ? nx : 0) * (ny > 0 ? ny : 0));
    c->bands.push_back(std::move(pb));
    return (int)c->bands.size() - 1;
}

// Parse one packet at *pos. band_ids: the packet's precinct-bands in band
// order. ht_style: nonzero when the HT (T.814) two-segment rule applies.
// out: triples (global_cb_id, seg_off, seg_len) per codeword segment.
// Returns #triples (>= 0) or a negative error:
//   -1 runaway zero-bitplane tree, -2 runaway Lblock,
//   -3 absurd segment length, -4 body past end, -5 out capacity.
// flags: bit 0 = SOP markers may precede packets (Scod bit 1),
//        bit 1 = EPH marker terminates every packet header (Scod bit 2)
// body/body_len/body_pos: when non-NULL, packet headers come from `data`
// (a PPT packed-header buffer) while the codeword segments live in the
// separate body stream (T.800 A.7.5); otherwise bodies follow the header.
int tic_t2_read_packet_split(void* h, const uint8_t* data, int64_t len,
                             int64_t* pos, int layer,
                             const int32_t* band_ids, int nbands,
                             int ht_style, int64_t* out, int out_cap,
                             int flags, const uint8_t* bodyd,
                             int64_t body_len, int64_t* body_pos) {
    T2Ctx* c = (T2Ctx*)h;
    if (flags & 1) {  // SOP precedes the packet in the BODY stream
        const uint8_t* sd = bodyd ? bodyd : data;
        int64_t slen = bodyd ? body_len : len;
        int64_t* sp = bodyd ? body_pos : pos;
        if (*sp + 6 <= slen && sd[*sp] == 0xFF && sd[*sp + 1] == 0x91)
            *sp += 6;  // SOP: FF91 Lsop(=4) Nsop(2) — optional per packet
    }
    BitRd br;
    br.init(data, len, *pos);
    int nout = 0;
    if (!br.bit()) {  // empty packet
        br.align();
        *pos = br.pos;
        if ((flags & 2) && *pos + 2 <= len && data[*pos] == 0xFF &&
            data[*pos + 1] == 0x92)
            *pos += 2;  // EPH after the (empty) packet header
        return 0;
    }
    // (cb_id, seg_len) body reads, order preserved
    int body_n = 0;
    std::vector<int64_t> body;  // pairs
    for (int b = 0; b < nbands; b++) {
        PrecBand& pb = c->bands[band_ids[b]];
        int ncb = pb.nx * pb.ny;
        for (int idx = 0; idx < ncb; idx++) {
            CbState& cb = c->cbs[pb.cb_base + idx];
            int x = pb.nx > 0 ? idx % pb.nx : 0;
            int y = pb.nx > 0 ? idx / pb.nx : 0;
            bool inc;
            if (!cb.included)
                inc = pb.incl.decode(br, x, y, layer + 1);
            else
                inc = br.bit() != 0;
            if (!inc) continue;
            if (!cb.included) {
                int k = 1;
                while (!pb.zbp.decode(br, x, y, k)) {
                    if (++k > 64) return -1;
                }
                cb.zero_bps = pb.zbp.leaf(x, y);
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
                // (flagged via bit 62 of the cb_id so the consumer
                // concatenates instead of starting a new segment)
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
                body_n++;
            }
            cb.num_passes += npasses;
        }
    }
    br.align();
    if (body_n > out_cap) return -5;
    int64_t p = br.pos;
    if ((flags & 2) && p + 2 <= len && data[p] == 0xFF && data[p + 1] == 0x92)
        p += 2;  // EPH terminates the packet header
    if (bodyd) {
        *pos = p;  // header buffer position advances independently
        p = *body_pos;
        len = body_len;
    }
    for (int i = 0; i < body_n; i++) {
        int64_t cb_id = body[2 * i], seg_len = body[2 * i + 1];
        if (p + seg_len > len) return -4;
        out[3 * nout + 0] = cb_id;
        out[3 * nout + 1] = p;
        out[3 * nout + 2] = seg_len;
        nout++;
        p += seg_len;
    }
    if (bodyd) *body_pos = p;
    else *pos = p;
    return nout;
}

int tic_t2_read_packet(void* h, const uint8_t* data, int64_t len,
                       int64_t* pos, int layer, const int32_t* band_ids,
                       int nbands, int ht_style, int64_t* out,
                       int out_cap, int flags) {
    return tic_t2_read_packet_split(h, data, len, pos, layer, band_ids,
                                    nbands, ht_style, out, out_cap, flags,
                                    nullptr, 0, nullptr);
}

// Dump accumulated per-code-block state for a band id range [b0, b1):
// per cb (in registration order): included, zero_bps, num_passes.
void tic_t2_dump(void* h, int band_id, int32_t* incl, int32_t* zbps,
                 int32_t* npasses) {
    T2Ctx* c = (T2Ctx*)h;
    PrecBand& pb = c->bands[band_id];
    int ncb = pb.nx * pb.ny;
    for (int i = 0; i < ncb; i++) {
        CbState& cb = c->cbs[pb.cb_base + i];
        incl[i] = cb.included;
        zbps[i] = cb.zero_bps;
        npasses[i] = cb.num_passes;
    }
}

}  // extern "C"\n
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
