// VP8 (lossy WebP) keyframe encoder — RFC 6386 from scratch.
// Counterpart of the lossy-WebP encode the reference gets
// from its OpenCV extension (reference:
// extensions/opencv/opencv_encoder.cpp, imencode(".webp", quality)).
//
// Intra-only keyframe: 16x16 luma prediction modes (DC/V/H/TM, chosen per
// macroblock by SSE) + 8x8 chroma modes, forward DCT/WHT, quantization via
// the normative quantizer tables, token coding with the DEFAULT coefficient
// probabilities (no updates signalled), one token partition, loop filter
// level 0. The encoder reconstructs every macroblock exactly the way the
// decoder will (quantize -> dequant -> inverse transforms -> predict+add),
// so intra prediction references match the decoder bit-for-bit and the
// output stream decodes identically in our native decoder and libwebp
// (validated in tests/test_webp.py).
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

namespace {

#include "webp_vp8_tables.inc"  // kDcQLookup/kAcQLookup/kCoeffProba0/
                                // kCoeffUpdateProba (RFC 6386 normative)

// ------------------------------------------------------------ bool encoder
// RFC 6386 section 7.3's arithmetic encoder: 32-bit `bottom`, carry
// propagated into already-emitted bytes, one byte out per 8 shifts.
struct BoolEnc {
    std::vector<uint8_t> out;
    uint32_t range = 255;
    uint32_t bottom = 0;
    int bit_count = 24;  // shifts until the next byte leaves `bottom`

    void add_one_carry() {  // propagate a carry into emitted bytes
        size_t i = out.size();
        while (i > 0 && out[i - 1] == 0xFF) out[--i] = 0;
        if (i > 0) out[i - 1]++;
    }
    void put(int bit, int prob) {
        uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
        if (bit) {
            bottom += split;
            range -= split;
        } else {
            range = split;
        }
        while (range < 128) {
            range <<= 1;
            if (bottom & (1u << 31)) add_one_carry();
            bottom <<= 1;
            if (!--bit_count) {
                out.push_back(uint8_t(bottom >> 24));
                bottom &= (1u << 24) - 1;
                bit_count = 8;
            }
        }
    }
    void put_bit(int b) { put(b, 128); }
    void literal(int v, int n) {
        for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1);
    }
    void flush() {  // RFC 6386 flush_bool_encoder
        int c = bit_count;
        uint32_t v = bottom;
        if (v & (1u << (32 - c))) add_one_carry();
        v <<= c & 7;
        c >>= 3;
        while (--c >= 0) v <<= 8;
        for (int i = 0; i < 4; ++i) {
            out.push_back(uint8_t(v >> 24));
            v <<= 8;
        }
    }
};

// tree writer: emit the bit path from root to leaf `v` (trees as in the
// decoder: tree[i] <= 0 is leaf ~value, > 0 is child node index)
bool tree_path(const int8_t* tree, int node, int v, uint8_t* bits,
               uint8_t* nodes, int depth, int* outlen) {
    for (int b = 0; b < 2; ++b) {
        int8_t t = tree[node + b];
        if (t <= 0) {
            if (~t == v) {
                bits[depth] = uint8_t(b);
                nodes[depth] = uint8_t(node >> 1);
                *outlen = depth + 1;
                return true;
            }
        } else if (tree_path(tree, t, v, bits, nodes, depth + 1, outlen)) {
            bits[depth] = uint8_t(b);
            nodes[depth] = uint8_t(node >> 1);
            return true;
        }
    }
    return false;
}

void tree_write(BoolEnc& be, const int8_t* tree, const uint8_t* probs,
                int v) {
    uint8_t bits[16], nodes[16];
    int n = 0;
    tree_path(tree, 0, v, bits, nodes, 0, &n);
    for (int i = 0; i < n; ++i) be.put(bits[i], probs[nodes[i]]);
}

// --------------------------------------------------------- trees (RFC)
const int8_t kKfYModeTree[8] = {~4, 2, 4, 6, ~0, ~1, ~2, ~3};
const uint8_t kKfYModeProbs[4] = {145, 156, 163, 128};
const int8_t kUVModeTree[6] = {~0, 2, ~1, 4, ~2, ~3};
const uint8_t kKfUVModeProbs[3] = {142, 114, 183};

const uint8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const uint8_t kZigzag[16] = {0, 1,  4,  8, 5, 2,  3,  6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCatProbs1[] = {159};
const uint8_t kCatProbs2[] = {165, 145};
const uint8_t kCatProbs3[] = {173, 148, 140};
const uint8_t kCatProbs4[] = {176, 155, 140, 135};
const uint8_t kCatProbs5[] = {180, 157, 141, 134, 130};
const uint8_t kCatProbs6[] = {254, 254, 243, 230, 196, 177,
                              153, 140, 133, 130, 129};
const uint8_t* kCatProbs[6] = {kCatProbs1, kCatProbs2, kCatProbs3,
                               kCatProbs4, kCatProbs5, kCatProbs6};
const int kCatBits[6] = {1, 2, 3, 4, 5, 11};
const int kCatBase[6] = {5, 7, 11, 19, 35, 67};

// ------------------------------------------------------- transforms
// Inverse transforms: IDENTICAL kernels to the decoder (RFC 14.3/14.4) —
// the encoder's reconstruction must match the decoder's bit-for-bit.
void idct4x4(const int16_t* in, int16_t* out) {
    const int c1 = 85627;   // 20091 + 65536 (RFC: cospi8sqrt2minus1 + 1)
    const int c2 = 35468;   // sinpi8sqrt2
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a = in[i] + in[8 + i];
        int b = in[i] - in[8 + i];
        int c = ((in[4 + i] * c2) >> 16) - ((in[12 + i] * c1) >> 16);
        int d = ((in[4 + i] * c1) >> 16) + ((in[12 + i] * c2) >> 16);
        tmp[i] = a + d;
        tmp[12 + i] = a - d;
        tmp[4 + i] = b + c;
        tmp[8 + i] = b - c;
    }
    for (int i = 0; i < 4; ++i) {
        int a = tmp[4 * i] + tmp[4 * i + 2];
        int b = tmp[4 * i] - tmp[4 * i + 2];
        int c = ((tmp[4 * i + 1] * c2) >> 16) - ((tmp[4 * i + 3] * c1) >> 16);
        int d = ((tmp[4 * i + 1] * c1) >> 16) + ((tmp[4 * i + 3] * c2) >> 16);
        out[4 * i] = int16_t((a + d + 4) >> 3);
        out[4 * i + 3] = int16_t((a - d + 4) >> 3);
        out[4 * i + 1] = int16_t((b + c + 4) >> 3);
        out[4 * i + 2] = int16_t((b - c + 4) >> 3);
    }
}

void iwht4x4(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a = in[i] + in[12 + i];
        int b = in[4 + i] + in[8 + i];
        int c = in[4 + i] - in[8 + i];
        int d = in[i] - in[12 + i];
        tmp[i] = a + b;
        tmp[4 + i] = d + c;
        tmp[8 + i] = a - b;
        tmp[12 + i] = d - c;
    }
    for (int i = 0; i < 4; ++i) {
        int a = tmp[4 * i] + tmp[4 * i + 3];
        int b = tmp[4 * i + 1] + tmp[4 * i + 2];
        int c = tmp[4 * i + 1] - tmp[4 * i + 2];
        int d = tmp[4 * i] - tmp[4 * i + 3];
        out[4 * i] = int16_t((a + b + 3) >> 3);
        out[4 * i + 1] = int16_t((d + c + 3) >> 3);
        out[4 * i + 2] = int16_t((a - b + 3) >> 3);
        out[4 * i + 3] = int16_t((d - c + 3) >> 3);
    }
}

// Forward transforms (encoder freedom; these are the classic fixed-point
// kernels matched to the inverse's 20091/35468 constants).
void fdct4x4(const int16_t* in /*row-major residual*/, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a0 = in[4 * i] + in[4 * i + 3];
        int a1 = in[4 * i + 1] + in[4 * i + 2];
        int a2 = in[4 * i + 1] - in[4 * i + 2];
        int a3 = in[4 * i] - in[4 * i + 3];
        tmp[4 * i] = (a0 + a1) * 8;
        tmp[4 * i + 2] = (a0 - a1) * 8;
        tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
        tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
    }
    for (int i = 0; i < 4; ++i) {
        int a0 = tmp[i] + tmp[12 + i];
        int a1 = tmp[4 + i] + tmp[8 + i];
        int a2 = tmp[4 + i] - tmp[8 + i];
        int a3 = tmp[i] - tmp[12 + i];
        out[i] = int16_t((a0 + a1 + 7) >> 4);
        out[8 + i] = int16_t((a0 - a1 + 7) >> 4);
        out[4 + i] = int16_t(((a2 * 2217 + a3 * 5352 + 12000) >> 16) +
                             (a3 != 0));
        out[12 + i] = int16_t((a3 * 2217 - a2 * 5352 + 51000) >> 16);
    }
}

void fwht4x4(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        int a0 = in[4 * i] + in[4 * i + 2];
        int a1 = in[4 * i + 1] + in[4 * i + 3];
        int a2 = in[4 * i + 1] - in[4 * i + 3];
        int a3 = in[4 * i] - in[4 * i + 2];
        tmp[4 * i] = a0 + a1;
        tmp[4 * i + 1] = a3 + a2;
        tmp[4 * i + 2] = a3 - a2;
        tmp[4 * i + 3] = a0 - a1;
    }
    for (int i = 0; i < 4; ++i) {
        int a0 = tmp[i] + tmp[8 + i];
        int a1 = tmp[4 + i] + tmp[12 + i];
        int a2 = tmp[4 + i] - tmp[12 + i];
        int a3 = tmp[i] - tmp[8 + i];
        int b0 = a0 + a1;
        int b1 = a3 + a2;
        int b2 = a3 - a2;
        int b3 = a0 - a1;
        out[i] = int16_t(b0 >> 1);
        out[4 + i] = int16_t(b1 >> 1);
        out[8 + i] = int16_t(b2 >> 1);
        out[12 + i] = int16_t(b3 >> 1);
    }
}

// ---------------------------------------------------------------- planes
struct Plane {
    uint8_t* base;
    int stride;
    inline uint8_t* row(int y) const { return base + int64_t(y) * stride; }
    inline uint8_t& at(int x, int y) const { return row(y)[x]; }
};

int clampq(int q) { return q < 0 ? 0 : (q > 127 ? 127 : q); }
inline uint8_t clip255(int v) {
    return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// prediction of an n x n block into pred[] (row-major), mirroring the
// decoder's DC/V/H/TM rules incl. the no-edge DC cases (RFC 12.2)
void predict(const Plane& P, int x0, int y0, int n, int mode,
             bool have_top, bool have_left, uint8_t* pred) {
    if (mode == 0) {  // DC
        int sum = 0, cnt = 0;
        if (have_top) {
            for (int i = 0; i < n; ++i) sum += P.at(x0 + i, y0 - 1);
            cnt += n;
        }
        if (have_left) {
            for (int i = 0; i < n; ++i) sum += P.at(x0 - 1, y0 + i);
            cnt += n;
        }
        int dc = cnt ? (sum + (cnt >> 1)) / cnt : 128;
        memset(pred, dc, size_t(n) * n);
    } else if (mode == 1) {  // V
        for (int y = 0; y < n; ++y)
            for (int x = 0; x < n; ++x) pred[y * n + x] = P.at(x0 + x, y0 - 1);
    } else if (mode == 2) {  // H
        for (int y = 0; y < n; ++y)
            memset(pred + y * n, P.at(x0 - 1, y0 + y), n);
    } else {  // TM
        int tl = P.at(x0 - 1, y0 - 1);
        for (int y = 0; y < n; ++y) {
            int l = P.at(x0 - 1, y0 + y);
            for (int x = 0; x < n; ++x)
                pred[y * n + x] = clip255(l + P.at(x0 + x, y0 - 1) - tl);
        }
    }
}

int64_t sse_block(const Plane& src, int x0, int y0, int n,
                  const uint8_t* pred) {
    int64_t s = 0;
    for (int y = 0; y < n; ++y) {
        const uint8_t* sr = src.row(y0 + y) + x0;
        const uint8_t* pr = pred + y * n;
        for (int x = 0; x < n; ++x) {
            int d = int(sr[x]) - int(pr[x]);
            s += d * d;
        }
    }
    return s;
}

struct MBData {
    uint8_t ymode, uvmode, skip;
    uint8_t bmodes[16];  // 4x4 modes (implied for 16x16 ymodes, RFC 11.3)
    int16_t lv[25][16];  // quantized levels, SCAN (zigzag) order: 16 Y
                         // (AC from 1 for 16x16 modes, 0 for B_PRED),
                         // 8 UV, Y2 at 24 (16x16 modes only)
};

const int8_t kBModeTree[18] = {~0, 2,  ~1, 4,  ~2, 6,  8,  12, ~3,
                               10, ~5, ~6, ~4, 14, ~7, 16, ~8, ~9};

// 4x4 intra prediction (RFC 12.3) — IDENTICAL to the decoder's pred_b.
void pred_b4(uint8_t mode, const uint8_t* A, const uint8_t* L, uint8_t TL,
             uint8_t out[4][4]) {
    auto avg3 = [](int a, int b, int c) {
        return uint8_t((a + 2 * b + c + 2) >> 2);
    };
    auto avg2 = [](int a, int b) { return uint8_t((a + b + 1) >> 1); };
    switch (mode) {
        case 0: {  // B_DC
            int s = 4;
            for (int i = 0; i < 4; ++i) s += A[i] + L[i];
            uint8_t dc = uint8_t(s >> 3);
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) out[y][x] = dc;
            break;
        }
        case 1:  // B_TM
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x)
                    out[y][x] = clip255(L[y] + A[x] - TL);
            break;
        case 2: {  // B_VE
            uint8_t r[4];
            r[0] = avg3(TL, A[0], A[1]);
            r[1] = avg3(A[0], A[1], A[2]);
            r[2] = avg3(A[1], A[2], A[3]);
            r[3] = avg3(A[2], A[3], A[4]);
            for (int y = 0; y < 4; ++y) memcpy(out[y], r, 4);
            break;
        }
        case 3:  // B_HE
            out[0][0] = out[0][1] = out[0][2] = out[0][3] =
                avg3(TL, L[0], L[1]);
            out[1][0] = out[1][1] = out[1][2] = out[1][3] =
                avg3(L[0], L[1], L[2]);
            out[2][0] = out[2][1] = out[2][2] = out[2][3] =
                avg3(L[1], L[2], L[3]);
            out[3][0] = out[3][1] = out[3][2] = out[3][3] =
                avg3(L[2], L[3], L[3]);
            break;
        case 4:  // B_LD
            out[0][0] = avg3(A[0], A[1], A[2]);
            out[0][1] = out[1][0] = avg3(A[1], A[2], A[3]);
            out[0][2] = out[1][1] = out[2][0] = avg3(A[2], A[3], A[4]);
            out[0][3] = out[1][2] = out[2][1] = out[3][0] =
                avg3(A[3], A[4], A[5]);
            out[1][3] = out[2][2] = out[3][1] = avg3(A[4], A[5], A[6]);
            out[2][3] = out[3][2] = avg3(A[5], A[6], A[7]);
            out[3][3] = avg3(A[6], A[7], A[7]);
            break;
        case 5:  // B_RD
            out[3][0] = avg3(L[3], L[2], L[1]);
            out[2][0] = out[3][1] = avg3(L[2], L[1], L[0]);
            out[1][0] = out[2][1] = out[3][2] = avg3(L[1], L[0], TL);
            out[0][0] = out[1][1] = out[2][2] = out[3][3] =
                avg3(L[0], TL, A[0]);
            out[0][1] = out[1][2] = out[2][3] = avg3(TL, A[0], A[1]);
            out[0][2] = out[1][3] = avg3(A[0], A[1], A[2]);
            out[0][3] = avg3(A[1], A[2], A[3]);
            break;
        case 6:  // B_VR
            out[3][0] = avg3(L[2], L[1], L[0]);
            out[2][0] = avg3(L[1], L[0], TL);
            out[1][0] = out[3][1] = avg3(L[0], TL, A[0]);
            out[0][0] = out[2][1] = avg2(TL, A[0]);
            out[1][1] = out[3][2] = avg3(TL, A[0], A[1]);
            out[0][1] = out[2][2] = avg2(A[0], A[1]);
            out[1][2] = out[3][3] = avg3(A[0], A[1], A[2]);
            out[0][2] = out[2][3] = avg2(A[1], A[2]);
            out[1][3] = avg3(A[1], A[2], A[3]);
            out[0][3] = avg2(A[2], A[3]);
            break;
        case 7:  // B_VL
            out[0][0] = avg2(A[0], A[1]);
            out[1][0] = avg3(A[0], A[1], A[2]);
            out[2][0] = out[0][1] = avg2(A[1], A[2]);
            out[1][1] = out[3][0] = avg3(A[1], A[2], A[3]);
            out[2][1] = out[0][2] = avg2(A[2], A[3]);
            out[3][1] = out[1][2] = avg3(A[2], A[3], A[4]);
            out[2][2] = out[0][3] = avg2(A[3], A[4]);
            out[3][2] = out[1][3] = avg3(A[3], A[4], A[5]);
            out[2][3] = avg3(A[4], A[5], A[6]);
            out[3][3] = avg3(A[5], A[6], A[7]);
            break;
        case 8:  // B_HD
            out[3][0] = avg2(L[3], L[2]);
            out[3][1] = avg3(L[3], L[2], L[1]);
            out[2][0] = out[3][2] = avg2(L[2], L[1]);
            out[2][1] = out[3][3] = avg3(L[2], L[1], L[0]);
            out[1][0] = out[2][2] = avg2(L[1], L[0]);
            out[1][1] = out[2][3] = avg3(L[1], L[0], TL);
            out[0][0] = out[1][2] = avg2(L[0], TL);
            out[0][1] = out[1][3] = avg3(L[0], TL, A[0]);
            out[0][2] = avg3(TL, A[0], A[1]);
            out[0][3] = avg3(A[0], A[1], A[2]);
            break;
        default:  // 9: B_HU
            out[0][0] = avg2(L[0], L[1]);
            out[0][1] = avg3(L[0], L[1], L[2]);
            out[0][2] = out[1][0] = avg2(L[1], L[2]);
            out[0][3] = out[1][1] = avg3(L[1], L[2], L[3]);
            out[1][2] = out[2][0] = avg2(L[2], L[3]);
            out[1][3] = out[2][1] = avg3(L[2], L[3], L[3]);
            out[2][2] = out[2][3] = out[3][0] = out[3][1] = out[3][2] =
                out[3][3] = L[3];
            break;
    }
}

inline int quantize(int v, int q) {
    int a = v < 0 ? -v : v;
    int r = (a + (q >> 1)) / q;
    if (r > 2047) r = 2047;  // token range guard (cat6 covers 2048+66)
    return v < 0 ? -r : r;
}

// tokenize one block's scan-order levels [first..15] with context ctx,
// through an emitter E: TokenWriter bool-encodes, TokenCounter collects
// per-node branch statistics (the adaptive-probability counting pass).
// Returns 1 if any coefficient was coded (nz), 0 for immediate EOB.
template <class E>
int emit_coeffs(E& e, int t, int ctx, int first, const int16_t* lv) {
    int last = -1;
    for (int i = first; i < 16; ++i)
        if (lv[i]) last = i;
    int n = first, bi = kBands[n], ri = ctx;
    if (last < first) {
        e.node(0, t, bi, ri, 0);  // EOB up front
        return 0;
    }
    bool can_eob = true;
    while (n <= last) {
        if (can_eob) e.node(1, t, bi, ri, 0);  // "not EOB"
        int v = lv[n];
        if (v == 0) {
            e.node(0, t, bi, ri, 1);
            ++n;
            bi = kBands[n < 16 ? n : 15];
            ri = 0;
            can_eob = false;
            continue;
        }
        e.node(1, t, bi, ri, 1);
        int a = v < 0 ? -v : v;
        int nctx;
        if (a == 1) {
            e.node(0, t, bi, ri, 2);
            nctx = 1;
        } else {
            e.node(1, t, bi, ri, 2);
            if (a <= 4) {
                e.node(0, t, bi, ri, 3);
                if (a == 2) {
                    e.node(0, t, bi, ri, 4);
                } else {
                    e.node(1, t, bi, ri, 4);
                    e.node(a - 3, t, bi, ri, 5);
                }
            } else {
                e.node(1, t, bi, ri, 3);
                if (a <= 10) {
                    e.node(0, t, bi, ri, 6);
                    if (a <= 6) {
                        e.node(0, t, bi, ri, 7);
                        e.fixed(a - 5, 159);
                    } else {
                        e.node(1, t, bi, ri, 7);
                        int x = a - 7;
                        e.fixed((x >> 1) & 1, 165);
                        e.fixed(x & 1, 145);
                    }
                } else {
                    e.node(1, t, bi, ri, 6);
                    int cat = a < kCatBase[3] ? 2
                              : a < kCatBase[4] ? 3
                              : a < kCatBase[5] ? 4 : 5;
                    if (cat <= 3) {
                        e.node(0, t, bi, ri, 8);
                        e.node(cat - 2, t, bi, ri, 9);
                    } else {
                        e.node(1, t, bi, ri, 8);
                        e.node(cat - 4, t, bi, ri, 10);
                    }
                    int x = a - kCatBase[cat];
                    const uint8_t* cp = kCatProbs[cat];
                    for (int i = 0; i < kCatBits[cat]; ++i)
                        e.fixed((x >> (kCatBits[cat] - 1 - i)) & 1, cp[i]);
                }
            }
            nctx = 2;
        }
        e.fixed(v < 0 ? 1 : 0, 128);
        ++n;
        bi = kBands[n < 16 ? n : 15];
        ri = nctx;
        can_eob = true;
    }
    if (n < 16) e.node(0, t, bi, ri, 0);  // EOB after the last nonzero
    return 1;
}

struct TokenWriter {
    BoolEnc& be;
    const uint8_t (*probs)[8][3][11];
    inline void node(int bit, int t, int b, int c, int i) {
        be.put(bit, probs[t][b][c][i]);
    }
    inline void fixed(int bit, int prob) { be.put(bit, prob); }
};

struct TokenCounter {
    uint32_t (*cnt)[8][3][11][2];  // [4][8][3][11][2]
    inline void node(int bit, int t, int b, int c, int i) {
        cnt[t][b][c][i][bit]++;
    }
    inline void fixed(int, int) {}
};

struct MBData;  // fwd (defined below)

// one full pass over all macroblocks' token streams with left/top nonzero
// context tracking — shared by the counting pass and the writing pass so
// their contexts (and therefore probability rows) agree exactly
template <class E, class MBVec>
void token_pass(E& e, MBVec& mbs, int mb_w, int mb_h) {
    std::vector<uint8_t> top_ctx(size_t(mb_w) * 9, 0);
    for (int my = 0; my < mb_h; ++my) {
        uint8_t left_ctx[9];
        memset(left_ctx, 0, sizeof(left_ctx));
        for (int mx = 0; mx < mb_w; ++mx) {
            auto& mb = mbs[size_t(my) * mb_w + mx];
            uint8_t* tctx = &top_ctx[size_t(mx) * 9];
            bool has_y2 = mb.ymode != 4;
            if (mb.skip) {
                // skipped MB: nonzero contexts clear; the Y2 context only
                // when the mode has a Y2 block (libwebp: nz_dc = 0 iff
                // !is_i4x4) — a skipped B_PRED MB leaves it untouched
                memset(left_ctx, 0, 8);
                memset(tctx, 0, 8);
                if (has_y2) left_ctx[8] = tctx[8] = 0;
                continue;
            }
            if (has_y2) {  // Y2
                int ctx = left_ctx[8] + tctx[8];
                int nz = emit_coeffs(e, 1, ctx, 0, mb.lv[24]);
                left_ctx[8] = tctx[8] = uint8_t(nz);
            }
            int ytype = has_y2 ? 0 : 3;
            int yfirst = has_y2 ? 1 : 0;
            for (int b = 0; b < 16; ++b) {
                int sx = b & 3, sy = b >> 2;
                int ctx = left_ctx[sy] + tctx[sx];
                int nz = emit_coeffs(e, ytype, ctx, yfirst, mb.lv[b]);
                left_ctx[sy] = tctx[sx] = uint8_t(nz);
            }
            for (int pl = 0; pl < 2; ++pl)
                for (int b = 0; b < 4; ++b) {
                    int sx = b & 1, sy = b >> 1;
                    int li = 4 + 2 * pl + sy, ti = 4 + 2 * pl + sx;
                    int ctx = left_ctx[li] + tctx[ti];
                    int nz = emit_coeffs(e, 2, ctx, 0,
                                         mb.lv[16 + 4 * pl + b]);
                    left_ctx[li] = tctx[ti] = uint8_t(nz);
                }
        }
    }
}

}  // namespace

extern "C" {

// Encode YUV420 planes as a WebP lossy (VP8 keyframe) stream.
// y: [h, w] (stride = w); u, v: [ceil(h/2), ceil(w/2)].
// qindex: 0 (finest) .. 127 (coarsest), the RFC 6386 y_ac_qi.
// flags: bit0 = disable B_PRED (16x16 modes only, for A/B tests).
// stats: optional int32[2] out — [0] B_PRED MB count, [1] total MBs.
// out: malloc'd stream (caller frees with free()); returns 0 ok.
int tic_vp8_encode(const uint8_t* ysrc, const uint8_t* usrc,
                   const uint8_t* vsrc, int w, int h, int qindex,
                   uint8_t** outbuf, uint64_t* outlen, int flags,
                   int32_t* stats) {
    if (w <= 0 || h <= 0 || w > 0x3FFF || h > 0x3FFF) return 1;
    qindex = clampq(qindex);
    const int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
    const int cw = (w + 1) >> 1, chh = (h + 1) >> 1;

    // quant factors (mirror the decoder's QuantMat, no deltas)
    int y1_dc = kDcQLookup[qindex];
    int y1_ac = kAcQLookup[qindex];
    int y2_dc = kDcQLookup[qindex] * 2;
    int y2_ac = kAcQLookup[qindex] * 155 / 100;
    if (y2_ac < 8) y2_ac = 8;
    int uv_dc = kDcQLookup[qindex];
    if (uv_dc > 132) uv_dc = 132;
    int uv_ac = kAcQLookup[qindex];

    // padded source (edge replication to MB grid) + recon planes with the
    // decoder's 1-px borders (top 127 / left 129)
    const int W16 = mb_w * 16, H16 = mb_h * 16;
    const int W8 = mb_w * 8, H8 = mb_h * 8;
    const int ys = W16 + 8, uvs = W8 + 8;
    std::vector<uint8_t> ysrcp(size_t(H16) * W16), usrcp(size_t(H8) * W8),
        vsrcp(size_t(H8) * W8);
    for (int y = 0; y < H16; ++y) {
        int sy = y < h ? y : h - 1;
        memcpy(&ysrcp[size_t(y) * W16], ysrc + size_t(sy) * w, w);
        memset(&ysrcp[size_t(y) * W16 + w], ysrc[size_t(sy) * w + w - 1],
               W16 - w);
    }
    for (int y = 0; y < H8; ++y) {
        int sy = y < chh ? y : chh - 1;
        memcpy(&usrcp[size_t(y) * W8], usrc + size_t(sy) * cw, cw);
        memset(&usrcp[size_t(y) * W8 + cw], usrc[size_t(sy) * cw + cw - 1],
               W8 - cw);
        memcpy(&vsrcp[size_t(y) * W8], vsrc + size_t(sy) * cw, cw);
        memset(&vsrcp[size_t(y) * W8 + cw], vsrc[size_t(sy) * cw + cw - 1],
               W8 - cw);
    }
    Plane SY{ysrcp.data(), W16}, SU{usrcp.data(), W8}, SV{vsrcp.data(), W8};

    std::vector<uint8_t> ybig(size_t(H16 + 1) * ys + 8, 0);
    std::vector<uint8_t> ubig(size_t(H8 + 1) * uvs + 8, 0);
    std::vector<uint8_t> vbig(size_t(H8 + 1) * uvs + 8, 0);
    Plane PY{ybig.data() + ys + 1, ys};
    Plane PU{ubig.data() + uvs + 1, uvs};
    Plane PV{vbig.data() + uvs + 1, uvs};
    memset(PY.row(-1) - 1, 127, ys);
    memset(PU.row(-1) - 1, 127, uvs);
    memset(PV.row(-1) - 1, 127, uvs);
    for (int y = 0; y < H16; ++y) PY.row(y)[-1] = 129;
    for (int y = 0; y < H8; ++y) {
        PU.row(y)[-1] = 129;
        PV.row(y)[-1] = 129;
    }

    std::vector<MBData> mbs(size_t(mb_w) * mb_h);

    // ---- pass A: mode decision + transform/quant + exact reconstruction
    uint8_t pred[256], predu[64], predv[64];
    for (int my = 0; my < mb_h; ++my) {
        for (int mx = 0; mx < mb_w; ++mx) {
            MBData& mb = mbs[size_t(my) * mb_w + mx];
            memset(mb.lv, 0, sizeof(mb.lv));
            bool have_top = my > 0, have_left = mx > 0;
            int x0 = mx * 16, y0 = my * 16;
            int cx0 = mx * 8, cy0 = my * 8;

            // luma mode by SSE over the four 16x16 predictors
            int best = 0;
            int64_t best_sse = -1;
            uint8_t cand[256];
            for (int m = 0; m < 4; ++m) {
                if ((m == 1 && !have_top) || (m == 2 && !have_left) ||
                    (m == 3 && !(have_top && have_left)))
                    continue;
                predict(PY, x0, y0, 16, m, have_top, have_left, cand);
                int64_t s = sse_block(SY, x0, y0, 16, cand);
                if (best_sse < 0 || s < best_sse) {
                    best_sse = s;
                    best = m;
                    memcpy(pred, cand, 256);
                }
            }
            mb.ymode = uint8_t(best);

            // chroma mode: joint SSE over U+V
            int bestc = 0;
            int64_t bestc_sse = -1;
            uint8_t cu[64], cvv[64];
            for (int m = 0; m < 4; ++m) {
                if ((m == 1 && !have_top) || (m == 2 && !have_left) ||
                    (m == 3 && !(have_top && have_left)))
                    continue;
                predict(PU, cx0, cy0, 8, m, have_top, have_left, cu);
                predict(PV, cx0, cy0, 8, m, have_top, have_left, cvv);
                int64_t s = sse_block(SU, cx0, cy0, 8, cu) +
                            sse_block(SV, cx0, cy0, 8, cvv);
                if (bestc_sse < 0 || s < bestc_sse) {
                    bestc_sse = s;
                    bestc = m;
                    memcpy(predu, cu, 64);
                    memcpy(predv, cvv, 64);
                }
            }
            mb.uvmode = uint8_t(bestc);

            // --- luma candidate 1 (16x16 mode): fDCTs, DC through the WHT
            int16_t res[16], coef[16], dcs[16], y2q[16];
            int16_t acde[16][16];  // dequantized AC (natural order)
            int16_t lv16[25][16];
            memset(lv16, 0, sizeof(lv16));
            for (int b = 0; b < 16; ++b) {
                int bx = (b & 3) * 4, by = (b >> 2) * 4;
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x)
                        res[y * 4 + x] = int16_t(
                            int(SY.at(x0 + bx + x, y0 + by + y)) -
                            int(pred[(by + y) * 16 + bx + x]));
                fdct4x4(res, coef);
                dcs[b] = coef[0];
                for (int n = 1; n < 16; ++n) {
                    int q = quantize(coef[kZigzag[n]], y1_ac);
                    lv16[b][n] = int16_t(q);
                    acde[b][kZigzag[n]] = int16_t(q * y1_ac);
                }
                acde[b][0] = 0;
            }
            int16_t wht[16];
            fwht4x4(dcs, wht);
            int16_t y2de[16];
            for (int n = 0; n < 16; ++n) {
                int q = quantize(wht[kZigzag[n]], n ? y2_ac : y2_dc);
                lv16[24][n] = int16_t(q);
                y2q[kZigzag[n]] = int16_t(q * (n ? y2_ac : y2_dc));
            }
            iwht4x4(y2q, y2de);  // decoder-side DC per luma block

            // reconstruct into r16 exactly as the decoder will
            uint8_t r16[16][16];
            int64_t sse16 = 0;
            for (int b = 0; b < 16; ++b) {
                int bx = (b & 3) * 4, by = (b >> 2) * 4;
                acde[b][0] = y2de[b];
                int16_t px[16];
                idct4x4(acde[b], px);
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x) {
                        uint8_t v = clip255(pred[(by + y) * 16 + bx + x] +
                                            px[y * 4 + x]);
                        r16[by + y][bx + x] = v;
                        int dd = int(v) - int(SY.at(x0 + bx + x, y0 + by + y));
                        sse16 += dd * dd;
                    }
            }

            // --- luma candidate 2 (B_PRED): per-4x4 mode search with
            // decoder-exact sequential reconstruction IN the frame plane
            // (subblock prediction reads earlier subblocks' recon)
            int16_t lv4[16][16];
            uint8_t bm4[16];
            int64_t sse4 = 0;
            for (int b = 0; b < 16; ++b) {
                int sxr = (b & 3), syr = (b >> 2);
                int sx = x0 + sxr * 4, sy = y0 + syr * 4;
                uint8_t A[8], L[4], TL;
                for (int i = 0; i < 4; ++i) {
                    L[i] = PY.at(sx - 1, sy + i);
                    A[i] = PY.at(sx + i, sy - 1);
                }
                TL = PY.at(sx - 1, sy - 1);
                bool right_col = sxr == 3;
                int ary = right_col ? y0 - 1 : sy - 1;
                int arx = sx + 4;
                bool last_mb = mx == mb_w - 1;
                for (int i = 0; i < 4; ++i) {
                    if (right_col && last_mb)
                        A[4 + i] = my > 0 ? PY.at(x0 + 15, y0 - 1) : 127;
                    else
                        A[4 + i] = PY.at(arx + i, ary);
                }
                // pick the min-SSE mode for this subblock
                uint8_t bp[4][4], bestp[4][4];
                int bmode = 0;
                int64_t bsse = -1;
                for (int m = 0; m < 10; ++m) {
                    pred_b4(uint8_t(m), A, L, TL, bp);
                    int64_t s = 0;
                    for (int y = 0; y < 4; ++y)
                        for (int x = 0; x < 4; ++x) {
                            int dd = int(SY.at(sx + x, sy + y)) - bp[y][x];
                            s += dd * dd;
                        }
                    if (bsse < 0 || s < bsse) {
                        bsse = s;
                        bmode = m;
                        memcpy(bestp, bp, 16);
                    }
                }
                bm4[b] = uint8_t(bmode);
                // residual: full 16-coefficient block (no Y2 for B_PRED)
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x)
                        res[y * 4 + x] = int16_t(
                            int(SY.at(sx + x, sy + y)) - bestp[y][x]);
                fdct4x4(res, coef);
                int16_t de[16];
                for (int n = 0; n < 16; ++n) {
                    int q = quantize(coef[kZigzag[n]], n ? y1_ac : y1_dc);
                    lv4[b][n] = int16_t(q);
                    de[kZigzag[n]] = int16_t(q * (n ? y1_ac : y1_dc));
                }
                int16_t px[16];
                idct4x4(de, px);
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x) {
                        uint8_t v = clip255(bestp[y][x] + px[y * 4 + x]);
                        PY.at(sx + x, sy + y) = v;
                        int dd = int(v) - int(SY.at(sx + x, sy + y));
                        sse4 += dd * dd;
                    }
            }

            // --- decide: B_PRED costs ~16 sub-mode symbols + denser tokens;
            // charge it a lambda-scaled bit penalty (step ~ y1_ac/8 pixels,
            // lambda ~ step^2 -> penalty = bits * y1_ac^2 / 64)
            int64_t penalty4 = int64_t(45) * y1_ac * y1_ac / 64;
            if ((flags & 1) || sse16 <= sse4 + penalty4) {
                // replay the 16x16 reconstruction over the B_PRED recon
                for (int y = 0; y < 16; ++y)
                    for (int x = 0; x < 16; ++x)
                        PY.at(x0 + x, y0 + y) = r16[y][x];
                memcpy(mb.lv, lv16, sizeof(lv16));
                static const uint8_t imp[4] = {0, 2, 3, 1};  // DC,V,H,TM
                memset(mb.bmodes, imp[mb.ymode], 16);
            } else {
                mb.ymode = 4;  // B_PRED
                memset(mb.lv, 0, sizeof(mb.lv));
                memcpy(mb.lv, lv4, sizeof(lv4));
                memcpy(mb.bmodes, bm4, 16);
            }

            // --- chroma residuals
            const uint8_t* cpred[2] = {predu, predv};
            Plane* cpl[2] = {&PU, &PV};
            Plane* csr[2] = {&SU, &SV};
            for (int pl = 0; pl < 2; ++pl) {
                for (int b = 0; b < 4; ++b) {
                    int bx = (b & 1) * 4, by = (b >> 1) * 4;
                    for (int y = 0; y < 4; ++y)
                        for (int x = 0; x < 4; ++x)
                            res[y * 4 + x] = int16_t(
                                int(csr[pl]->at(cx0 + bx + x, cy0 + by + y)) -
                                int(cpred[pl][(by + y) * 8 + bx + x]));
                    fdct4x4(res, coef);
                    int16_t de[16];
                    for (int n = 0; n < 16; ++n) {
                        int q = quantize(coef[kZigzag[n]],
                                         n ? uv_ac : uv_dc);
                        mb.lv[16 + 4 * pl + b][n] = int16_t(q);
                        de[kZigzag[n]] = int16_t(q * (n ? uv_ac : uv_dc));
                    }
                    int16_t px[16];
                    idct4x4(de, px);
                    for (int y = 0; y < 4; ++y)
                        for (int x = 0; x < 4; ++x)
                            cpl[pl]->at(cx0 + bx + x, cy0 + by + y) =
                                clip255(cpred[pl][(by + y) * 8 + bx + x] +
                                        px[y * 4 + x]);
                }
            }

            // skip = every level zero
            mb.skip = 1;
            for (int b = 0; b < 25 && mb.skip; ++b)
                for (int n = 0; n < 16; ++n)
                    if (mb.lv[b][n]) {
                        mb.skip = 0;
                        break;
                    }
        }
    }

    if (stats) {
        int nb = 0;
        for (auto& m : mbs) nb += (m.ymode == 4);
        stats[0] = nb;
        stats[1] = int32_t(mbs.size());
    }

    // skip probability: P(not skipped) per RFC 9.11 semantics is
    // prob_skip_false = P(skip flag == 1)… the flag is coded as
    // bool(prob_skip) with 1 = skipped, so pick the observed frequency
    int nskip = 0;
    for (auto& m : mbs) nskip += m.skip;
    int skip_prob = int((uint64_t(nskip) * 255 + mbs.size() / 2) /
                        (mbs.size() ? mbs.size() : 1));
    if (skip_prob < 1) skip_prob = 1;
    if (skip_prob > 254) skip_prob = 254;

    // ---- pass B1: partition 0 (frame header + per-MB modes)
    BoolEnc p0;
    p0.put_bit(0);        // color space
    p0.put_bit(0);        // clamping
    p0.put_bit(0);        // segmentation off
    // in-loop deblocking: a post-recon pass in every decoder (ours applies
    // it after all MBs, so intra prediction is unaffected) — signalling a
    // q-scaled level costs nothing here and deblocks the decoded output
    int filter_level = qindex >> 1;
    if (filter_level > 63) filter_level = 63;
    if (flags & 2) filter_level = 0;
    p0.put_bit(0);        // filter_type: normal
    p0.literal(filter_level, 6);
    p0.literal(0, 3);     // sharpness
    p0.put_bit(0);        // no lf deltas
    p0.literal(0, 2);     // log2(token partitions) = 0 → one partition
    p0.literal(qindex, 7);
    p0.put_bit(0);        // dq_y1_dc
    p0.put_bit(0);        // dq_y2_dc
    p0.put_bit(0);        // dq_y2_ac
    p0.put_bit(0);        // dq_uv_dc
    p0.put_bit(0);        // dq_uv_ac
    p0.put_bit(0);        // refresh entropy (ignored on keyframes)
    // --- adaptive coefficient probabilities: count every token's tree
    // branches (TokenCounter), then keep an update only where it saves
    // more token bits than its own header cost (flag + 8-bit literal)
    static_assert(sizeof(kCoeffProba0) == 4 * 8 * 3 * 11, "prob table");
    uint8_t probs_u[4][8][3][11];
    memcpy(probs_u, kCoeffProba0, sizeof(probs_u));
    {
        std::vector<uint32_t> counts(4 * 8 * 3 * 11 * 2, 0);
        TokenCounter tc{(uint32_t(*)[8][3][11][2])counts.data()};
        token_pass(tc, mbs, mb_w, mb_h);
        const uint8_t* defp = kCoeffProba0;
        const uint8_t* up = kCoeffUpdateProba;
        uint8_t* newp = &probs_u[0][0][0][0];
        for (int i = 0; i < 4 * 8 * 3 * 11; ++i) {
            uint32_t c0 = counts[2 * i], c1 = counts[2 * i + 1];
            if (!c0 && !c1) continue;
            int cand = int((255ull * c0 + (c0 + c1) / 2) / (c0 + c1));
            if (cand < 1) cand = 1;
            if (cand > 255) cand = 255;
            if (cand == defp[i]) continue;
            auto bits = [&](int p) {
                double b = 0.0;
                if (c0) b -= c0 * log2(p / 256.0);
                if (c1) b -= c1 * log2((256 - p) / 256.0);
                return b;
            };
            // header delta: flag 1 instead of 0 at prob up[i], + 8 bits
            double hdr = -log2((256 - up[i]) / 256.0) + log2(up[i] / 256.0)
                         + 8.0;
            if (bits(defp[i]) - bits(cand) > hdr) newp[i] = uint8_t(cand);
        }
        for (int i = 0; i < 4 * 8 * 3 * 11; ++i) {
            int upd = newp[i] != defp[i];
            p0.put(upd, up[i]);
            if (upd) p0.literal(newp[i], 8);
        }
    }
    p0.put_bit(1);        // mb_no_skip_coeff enabled
    p0.literal(skip_prob, 8);
    {
        // per-MB modes; B_PRED sub-modes code with the above/left 4x4
        // mode contexts (RFC 11.2, kKfBModesProba[above][left])
        std::vector<uint8_t> top_modes(size_t(mb_w) * 4, 0);
        for (int my = 0; my < mb_h; ++my) {
            uint8_t left_modes[4] = {0, 0, 0, 0};
            for (int mx = 0; mx < mb_w; ++mx) {
                MBData& m = mbs[size_t(my) * mb_w + mx];
                p0.put(m.skip, skip_prob);
                tree_write(p0, kKfYModeTree, kKfYModeProbs, m.ymode);
                if (m.ymode == 4) {
                    for (int sy = 0; sy < 4; ++sy)
                        for (int sx = 0; sx < 4; ++sx) {
                            int am = sy > 0 ? m.bmodes[(sy - 1) * 4 + sx]
                                            : top_modes[size_t(mx) * 4 + sx];
                            int lm = sx > 0 ? m.bmodes[sy * 4 + sx - 1]
                                            : left_modes[sy];
                            tree_write(
                                p0, kBModeTree,
                                &kKfBModesProba[(am * 10 + lm) * 9],
                                m.bmodes[sy * 4 + sx]);
                        }
                }
                for (int sy = 0; sy < 4; ++sy)
                    left_modes[sy] = m.bmodes[sy * 4 + 3];
                for (int sx = 0; sx < 4; ++sx)
                    top_modes[size_t(mx) * 4 + sx] = m.bmodes[12 + sx];
                tree_write(p0, kUVModeTree, kKfUVModeProbs, m.uvmode);
            }
        }
    }
    p0.flush();

    // ---- pass B2: token partition with left/top nonzero contexts
    BoolEnc tp;
    TokenWriter tw{tp, (const uint8_t(*)[8][3][11])probs_u};
    token_pass(tw, mbs, mb_w, mb_h);
    tp.flush();

    // ---- assemble: frame tag + start code + dims + partitions
    size_t part0 = p0.out.size();
    if (part0 >= (1u << 19)) return 2;
    uint64_t total = 10 + part0 + tp.out.size();
    uint8_t* buf = (uint8_t*)malloc(total);
    if (!buf) return 3;
    uint32_t tag = (0 /*keyframe*/) | (0 << 1) /*version*/ |
                   (1u << 4) /*show*/ | (uint32_t(part0) << 5);
    buf[0] = uint8_t(tag);
    buf[1] = uint8_t(tag >> 8);
    buf[2] = uint8_t(tag >> 16);
    buf[3] = 0x9d;
    buf[4] = 0x01;
    buf[5] = 0x2a;
    buf[6] = uint8_t(w);
    buf[7] = uint8_t(w >> 8);  // scale 0
    buf[8] = uint8_t(h);
    buf[9] = uint8_t(h >> 8);
    memcpy(buf + 10, p0.out.data(), part0);
    memcpy(buf + 10 + part0, tp.out.data(), tp.out.size());
    *outbuf = buf;
    *outlen = total;
    return 0;
}

}  // extern "C"
