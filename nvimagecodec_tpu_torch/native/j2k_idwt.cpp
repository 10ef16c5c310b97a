// Native multi-level inverse 5/3 DWT (ITU-T T.800 Annex F) for the
// reversible J2K host decode path — the torch lifting in ops/dwt.py is
// the device path; this is the host-CPU fast path.
//
// Layout matches ops/dwt.py: bands finest-first (HL, LH, HH per level),
// LL coarsest; per-level sizes and parities derive from the absolute
// tile-component origin (oy, ox) — see ops/dwt.py subband_dims /
// _level_parity. Horizontal synthesis first on the (L,H) row pairs, then
// vertical interleave, identical operation order to idwt2d_level (the
// integer lifting is order-sensitive; outputs are bit-identical).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// split sizes of a length-n segment starting at parity p:
// low band = absolute-even positions.
static inline int nlow(int n, int p) { return p ? n / 2 : (n + 1) / 2; }

// 1D inverse 5/3 on one row: L[nl], H[nh] -> out[n], segment start parity p.
// Interior loops are contiguous and branch-free (boundary clamps peeled)
// so the compiler vectorizes them; the interleaved final store is a
// stride-2 pattern gcc emits shuffled vector stores for.
static void inv53_row(const int32_t* L, const int32_t* H, int32_t* out,
                      int n, int p) {
    if (n <= 0) return;  // odd-origin length-1 parents have empty children
    int nl = nlow(n, p), nh = n - nl;
    if (nh == 0) { out[0] = L[0]; return; }
    if (nl == 0) { out[0] = H[0] >> 1; return; }
    static thread_local std::vector<int32_t> scratch;
    if (int(scratch.size()) < n + 2) scratch.resize(n + 2);
    int32_t* e = scratch.data();       // low-band lifted values
    int32_t* o = e + nl + 1;           // high-band lifted values
    if (!p) {
        // even[k] = L[k] - ((H[k-1] + H[k] + 2) >> 2), clamp both ends
        e[0] = L[0] - ((2 * H[0] + 2) >> 2);
        const int ke = nl < nh ? nl : nh;  // ks.t. k-1 and k in range
        for (int k = 1; k < ke; k++)
            e[k] = L[k] - ((H[k - 1] + H[k] + 2) >> 2);
        for (int k = ke > 1 ? ke : 1; k < nl; k++)  // nh < k < nl tail
            e[k] = L[k] - ((2 * H[nh - 1] + 2) >> 2);
        // odd[k] = H[k] + ((even[k] + even[k+1]) >> 1)
        for (int k = 0; k < nh - 1; k++)
            o[k] = H[k] + ((e[k] + e[k + 1]) >> 1);
        {
            int k = nh - 1;
            int32_t er = e[k + 1 < nl ? k + 1 : nl - 1];
            o[k] = H[k] + ((e[k] + er) >> 1);
        }
        const int np_ = nl < nh ? nl : nh;
        for (int k = 0; k < np_; k++) {
            out[2 * k] = e[k];
            out[2 * k + 1] = o[k];
        }
        if (nl > nh) out[2 * nl - 2] = e[nl - 1];
    } else {
        // low at local odd slots: low[k] = L[k] - ((H[k] + H[k+1] + 2) >> 2)
        const int ke = nl < nh - 1 ? nl : nh - 1;
        for (int k = 0; k < ke; k++)
            e[k] = L[k] - ((H[k] + H[k + 1] + 2) >> 2);
        for (int k = ke > 0 ? ke : 0; k < nl; k++)
            e[k] = L[k] - ((2 * H[nh - 1] + 2) >> 2);
        // high at local even: high[k] = H[k] + ((low[k-1] + low[k]) >> 1)
        o[0] = H[0] + ((e[0] + e[0]) >> 1);
        const int kh = nh < nl + 1 ? nh : nl + 1;
        for (int k = 1; k < kh; k++) {
            int32_t lc = e[k < nl ? k : nl - 1];
            o[k] = H[k] + ((e[k - 1] + lc) >> 1);
        }
        for (int k = kh; k < nh; k++)
            o[k] = H[k] + ((e[nl - 1] + e[nl - 1]) >> 1);
        const int np_ = nl < nh ? nl : nh;
        for (int k = 0; k < np_; k++) {
            out[2 * k] = o[k];
            out[2 * k + 1] = e[k];
        }
        if (nh > nl) out[2 * nh - 2] = o[nh - 1];
    }
}

static inline int ceildiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Multi-level inverse 5/3. bands: 3*levels pointers, finest-first
// (HL, LH, HH per level); LL: coarsest low band. out: th*tw int32.
// (oy, ox): absolute tile-component origin (drives per-level sizes and
// lifting parities). Returns 0.
int tic_idwt53(const int32_t* LL, const int32_t* const* bands, int levels,
               int th, int tw, int oy, int ox, int32_t* out) {
    if (levels == 0) {
        memcpy(out, LL, sizeof(int32_t) * size_t(th) * tw);
        return 0;
    }
    int y1 = oy + th, x1 = ox + tw;
    // per-scale segment dims: level s occupies [ceil(c0/2^s), ceil(c1/2^s))
    std::vector<int> hs(levels + 1), ws(levels + 1), py(levels + 1),
        px(levels + 1);
    for (int s = 0; s <= levels; s++) {
        int d = 1 << s;
        int yy0 = ceildiv(oy, d), xx0 = ceildiv(ox, d);
        hs[s] = ceildiv(y1, d) - yy0;
        ws[s] = ceildiv(x1, d) - xx0;
        py[s] = yy0 & 1;
        px[s] = xx0 & 1;
    }
    std::vector<int32_t> cur(LL, LL + size_t(hs[levels]) * ws[levels]);
    std::vector<int32_t> nxt, ring;
    for (int lev = levels - 1; lev >= 0; lev--) {
        int h = hs[lev], w = ws[lev];
        int hl = nlow(h, py[lev]);
        int hh = h - hl;
        int wl = nlow(w, px[lev]);
        int wh = w - wl;
        const int px_ = px[lev];
        const int32_t* HL = bands[3 * lev + 0];
        const int32_t* LH = bands[3 * lev + 1];
        const int32_t* HH = bands[3 * lev + 2];
        int32_t* dst;
        if (lev == 0) {
            dst = out;
        } else {
            nxt.resize(size_t(h) * w);
            dst = nxt.data();
        }
        // STREAMING vertical synthesis fused with on-demand horizontal
        // rows: the full-plane Ly/Hy intermediates (2 extra sweeps of
        // main-memory traffic per level) are replaced by a 3-row ring —
        // each horizontal row is produced right before the vertical
        // lifting consumes it, and even (E) rows are read back from dst
        // while still cache-hot. Bit-identical operation order.
        ring.resize(3 * size_t(w));
        int32_t* rowL = ring.data();
        int32_t* Hp = rowL + w;   // H row k (prev/current)
        int32_t* Hn = Hp + w;     // H row k+1 (lookahead, p==1 only)
        auto synthL = [&](int k, int32_t* o) {
            inv53_row(cur.data() + size_t(k) * wl, HL + size_t(k) * wh, o,
                      w, px_);
        };
        auto synthH = [&](int k, int32_t* o) {
            inv53_row(LH + size_t(k) * wl, HH + size_t(k) * wh, o, w, px_);
        };
        if (hh == 0) {            // single L row (h == 1, even parity)
            for (int k = 0; k < hl; k++) synthL(k, dst + size_t(k) * w);
        } else if (hl == 0) {     // single H row (h == 1, odd parity)
            synthH(0, Hp);
            for (int x = 0; x < w; x++) dst[x] = Hp[x] >> 1;
        } else if (!py[lev]) {
            synthH(0, Hp);
            synthL(0, rowL);
            int32_t* Eprev = dst;  // E_0 at dst row 0
            for (int x = 0; x < w; x++)
                Eprev[x] = rowL[x] - ((2 * Hp[x] + 2) >> 2);
            for (int k = 1; k < hl; k++) {
                int32_t* Hk = Hp;
                if (k < hh) {
                    synthH(k, Hn);
                    Hk = Hn;
                }  // else clamp: H_k := H_{hh-1} (== Hp)
                synthL(k, rowL);
                int32_t* Ek = dst + size_t(2 * k) * w;
                for (int x = 0; x < w; x++)
                    Ek[x] = rowL[x] - ((Hp[x] + Hk[x] + 2) >> 2);
                int32_t* O = dst + size_t(2 * k - 1) * w;  // O_{k-1}
                for (int x = 0; x < w; x++)
                    O[x] = Hp[x] + ((Eprev[x] + Ek[x]) >> 1);
                if (k < hh) std::swap(Hp, Hn);
                Eprev = Ek;
            }
            if (hh == hl) {  // O_{hh-1}: er clamps to E_{hl-1}
                int32_t* O = dst + size_t(2 * hh - 1) * w;
                for (int x = 0; x < w; x++)
                    O[x] = Hp[x] + ((Eprev[x] + Eprev[x]) >> 1);
            }
        } else {
            // odd start parity: low rows at local odd slots, E_k needs a
            // one-row H lookahead
            synthH(0, Hp);
            int32_t* Eprev = nullptr;
            for (int k = 0; k < hl; k++) {
                int32_t* Hnx = Hp;
                if (k + 1 < hh) {
                    synthH(k + 1, Hn);
                    Hnx = Hn;
                }  // else clamp: H_{k+1} := H_{hh-1}
                synthL(k, rowL);
                int32_t* Ek = dst + size_t(2 * k + 1) * w;
                for (int x = 0; x < w; x++)
                    Ek[x] = rowL[x] - ((Hp[x] + Hnx[x] + 2) >> 2);
                int32_t* O = dst + size_t(2 * k) * w;  // O_k (ll: E_{k-1})
                const int32_t* ll = Eprev ? Eprev : Ek;
                for (int x = 0; x < w; x++)
                    O[x] = Hp[x] + ((ll[x] + Ek[x]) >> 1);
                if (k + 1 < hh) std::swap(Hp, Hn);
                Eprev = Ek;
            }
            if (hh > hl) {  // trailing high row O_{hl}: both clamps E_{hl-1}
                int32_t* O = dst + size_t(2 * hl) * w;
                for (int x = 0; x < w; x++)
                    O[x] = Hp[x] + ((Eprev[x] + Eprev[x]) >> 1);
            }
        }
        if (lev != 0) cur.swap(nxt);
    }
    return 0;
}

}  // extern "C"

// ----------------------------------------------------------------- forward
namespace {

// 1D forward 5/3 on one row: in[n] -> L[nl], H[nh], start parity p.
// Mirrors ops/dwt._fwd_lift_53 exactly (including its boundary clamps).
// Deinterleaves into contiguous scratch first so the lifting loops are
// branch-free and contiguous (vectorizable); boundary clamps peeled.
static void fwd53_row(const int32_t* in, int32_t* L, int32_t* H, int n,
                      int p) {
    if (n <= 0) return;
    int nl = nlow(n, p), nh = n - nl;
    if (n == 1) {
        if (p) H[0] = in[0] * 2;
        else L[0] = in[0];
        return;
    }
    static thread_local std::vector<int32_t> scratch;
    if (int(scratch.size()) < n + 2) scratch.resize(n + 2);
    int32_t* a = scratch.data();       // even-index samples in[2k]
    int32_t* b = a + (n + 1) / 2 + 1;  // odd-index samples in[2k+1]
    const int na = (n + 1) / 2, nb = n / 2;
    for (int k = 0; k < nb; k++) {
        a[k] = in[2 * k];
        b[k] = in[2 * k + 1];
    }
    if (na > nb) a[na - 1] = in[2 * (na - 1)];
    if (!p) {
        // H[k] = x[2k+1] - ((x[2k] + x[2k+2]) >> 1), right clamp
        for (int k = 0; k < nh - 1; k++)
            H[k] = b[k] - ((a[k] + a[k + 1]) >> 1);
        {
            int k = nh - 1;
            int32_t lr = a[k + 1 < nl ? k + 1 : nl - 1];
            H[k] = b[k] - ((a[k] + lr) >> 1);
        }
        L[0] = a[0] + ((2 * H[0] + 2) >> 2);
        const int ke = nl < nh ? nl : nh;
        for (int k = 1; k < ke; k++)
            L[k] = a[k] + ((H[k - 1] + H[k] + 2) >> 2);
        for (int k = ke > 1 ? ke : 1; k < nl; k++)
            L[k] = a[k] + ((2 * H[nh - 1] + 2) >> 2);
    } else {
        // low at local odd slots, high at local even (a = high positions)
        H[0] = a[0] - ((b[0] + b[0]) >> 1);
        for (int k = 1; k < nl; k++)
            H[k] = a[k] - ((b[k - 1] + b[k]) >> 1);
        for (int k = nl > 1 ? nl : 1; k < nh; k++)
            H[k] = a[k] - ((2 * b[nl - 1]) >> 1);
        const int ke = nl < nh - 1 ? nl : nh - 1;
        for (int k = 0; k < ke; k++)
            L[k] = b[k] + ((H[k] + H[k + 1] + 2) >> 2);
        for (int k = ke > 0 ? ke : 0; k < nl; k++)
            L[k] = b[k] + ((2 * H[nh - 1] + 2) >> 2);
    }
}

}  // namespace

extern "C" {

// Multi-level forward 5/3: in [th, tw] int32; bands: 3*levels pointers,
// finest-first (HL, LH, HH); LL: coarsest low band. (oy, ox): absolute
// tile-component origin (per-level sizes + parities, same convention as
// tic_idwt53). Column pass first, then rows — the T.800-normative order
// ops/dwt.dwt2d_level uses; outputs are bit-identical to it.
int tic_fdwt53(const int32_t* in, int levels, int th, int tw, int oy,
               int ox, int32_t* LL, int32_t* const* bands) {
    if (levels == 0) {
        memcpy(LL, in, sizeof(int32_t) * size_t(th) * tw);
        return 0;
    }
    int y1 = oy + th, x1 = ox + tw;
    std::vector<int> hs(levels + 1), ws(levels + 1), py(levels + 1),
        px(levels + 1);
    for (int s = 0; s <= levels; s++) {
        int d = 1 << s;
        int yy0 = ceildiv(oy, d), xx0 = ceildiv(ox, d);
        hs[s] = ceildiv(y1, d) - yy0;
        ws[s] = ceildiv(x1, d) - xx0;
        py[s] = yy0 & 1;
        px[s] = xx0 & 1;
    }
    std::vector<int32_t> cur(in, in + size_t(th) * tw);
    std::vector<int32_t> nxt, ring;
    for (int s = 0; s < levels; s++) {
        int h = hs[s], w = ws[s];
        int nly = nlow(h, py[s]), nhy = h - nly;
        int nlx = nlow(w, px[s]), nhx = w - nlx;
        int32_t* HL = (int32_t*)bands[3 * s + 0];
        int32_t* LH = (int32_t*)bands[3 * s + 1];
        int32_t* HH = (int32_t*)bands[3 * s + 2];
        nxt.resize(size_t(nly) * nlx);
        // STREAMING: vertical H/L rows are produced one at a time and
        // row-transformed immediately (mirror of the fused inverse above;
        // no full-plane Ly/Hy intermediates). Bit-identical op order.
        ring.resize(3 * size_t(w));
        int32_t* Hp = ring.data();       // vertical H row k-1 (or k)
        int32_t* Hc = Hp + w;            // vertical H row k (or k+1)
        int32_t* rowT = Hc + w;          // vertical L row scratch
        const int32_t* src = cur.data();
        auto inrow = [&](int r) { return src + size_t(r) * w; };
        auto emitL = [&](int k, const int32_t* row) {
            fwd53_row(row, nxt.data() + size_t(k) * nlx,
                      HL + size_t(k) * nhx, w, px[s]);
        };
        auto emitH = [&](int k, const int32_t* row) {
            fwd53_row(row, LH + size_t(k) * nlx, HH + size_t(k) * nhx, w,
                      px[s]);
        };
        if (h == 1) {
            if (py[s]) {
                for (int x = 0; x < w; x++) Hc[x] = src[x] * 2;
                emitH(0, Hc);
            } else {
                emitL(0, inrow(0));
            }
        } else if (!py[s]) {
            // H_k = x[2k+1] - ((x[2k] + x[2k+2 clamp]) >> 1);
            // L_k = x[2k] + ((H_{k-1} + H_{min(k, nhy-1)} + 2) >> 2)
            for (int k = 0; k < nly; k++) {
                if (k < nhy) {
                    const int32_t* lc = inrow(2 * k);
                    const int32_t* lr =
                        inrow(k + 1 < nly ? 2 * (k + 1) : 2 * (nly - 1));
                    const int32_t* xc = inrow(2 * k + 1);
                    for (int x = 0; x < w; x++)
                        Hc[x] = xc[x] - ((lc[x] + lr[x]) >> 1);
                    emitH(k, Hc);
                }
                const int32_t* hl = k > 0 ? Hp : Hc;
                const int32_t* hcr = k < nhy ? Hc : Hp;
                const int32_t* xc = inrow(2 * k);
                for (int x = 0; x < w; x++)
                    rowT[x] = xc[x] + ((hl[x] + hcr[x] + 2) >> 2);
                emitL(k, rowT);
                if (k < nhy) std::swap(Hp, Hc);
            }
        } else {
            // odd parity: H_k = x[2k] - ((x[2k-1 clamp] + x[2k+1 clamp])
            // >> 1); L_k = x[2k+1] + ((H_k + H_{min(k+1, nhy-1)} + 2) >> 2)
            auto calcH = [&](int k, int32_t* o) {
                const int32_t* ll = inrow(k > 0 ? 2 * (k - 1) + 1 : 1);
                const int32_t* lc =
                    inrow(k < nly ? 2 * k + 1 : 2 * (nly - 1) + 1);
                const int32_t* xc = inrow(2 * k);
                for (int x = 0; x < w; x++)
                    o[x] = xc[x] - ((ll[x] + lc[x]) >> 1);
            };
            calcH(0, Hp);
            emitH(0, Hp);
            for (int k = 0; k < nly; k++) {
                const int32_t* hr = Hp;
                if (k + 1 < nhy) {
                    calcH(k + 1, Hc);
                    emitH(k + 1, Hc);
                    hr = Hc;
                }
                const int32_t* xc = inrow(2 * k + 1);
                for (int x = 0; x < w; x++)
                    rowT[x] = xc[x] + ((Hp[x] + hr[x] + 2) >> 2);
                emitL(k, rowT);
                if (k + 1 < nhy) std::swap(Hp, Hc);
            }
        }
        cur.swap(nxt);
    }
    memcpy(LL, cur.data(), sizeof(int32_t) * cur.size());
    return 0;
}

}  // extern "C"
