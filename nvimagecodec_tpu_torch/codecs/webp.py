"""WebP decoders: native VP8L (lossless) implementation + plugin glue.

The reference decodes WebP only through its OpenCV CPU fallback
(extensions/opencv/opencv_decoder.cpp, opencv_ext.cpp:38-44). Here the
lossless format is implemented natively from the WebP Lossless Bitstream
Specification (RFC 9649): LSB-first bit reader, canonical prefix codes with
the code-length-code bootstrap, color cache, LZ77 backward references with
the 2-D distance mapping, meta-prefix tiling, and the four inverse
transforms (predictor / color / subtract-green / color-indexing with
sub-byte packing). Lossy VP8 is also native: the RFC 6386 keyframe decoder
lives in native/webp_vp8.cpp (bool decoder, mode/token trees, dequant,
inverse WHT/DCT, intra prediction, in-loop deblocking — bit-exact against
libwebp's YUV output), with libwebp-exact fancy upsampling + fixed-point
color conversion here, and the ALPH chunk (raw or lossless-coded alpha
with all four prediction filters) decodes natively as well. Animated
streams composite natively too (webp_anim.py); the system-libwebp plugin
(codecs/system_codecs.py) remains only as a lower-priority robustness
rung.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeResult,
    EncoderPlugin,
)
from ..core.types import BackendKind, Priority, ProcessingStatus

# order in which code-length code lengths are stored
_CLC_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]

# 2-D distance mapping: the first 120 distance values address a pixel
# neighborhood (dy 0..7, dx -8..8, above-or-left), ordered by squared
# euclidean distance, larger dy first on ties, +dx before -dx (the fixed
# table of RFC 9649 §4.2.2 follows exactly this rule).
def _neighborhood_offsets():
    cand = []
    for dy in range(0, 8):
        for dx in range(-8, 9):
            if dy == 0 and dx <= 0:
                continue
            cand.append((dx, dy))
    cand.sort(key=lambda p: (p[0] ** 2 + p[1] ** 2, -p[1], p[0] < 0))
    return cand[:120]


def _build_dist_map(xsize: int) -> np.ndarray:
    out = np.zeros(120, np.int64)
    for i, (dx, dy) in enumerate(_neighborhood_offsets()):
        d = dy * xsize + dx
        out[i] = d if d >= 1 else 1
    return out


class BitReader:
    """LSB-first bit reader over the VP8L payload."""

    __slots__ = ("data", "pos", "acc", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def bits(self, k: int) -> int:
        while self.n < k:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc |= b << self.n
            self.n += 8
        v = self.acc & ((1 << k) - 1)
        self.acc >>= k
        self.n -= k
        return v

    def bit(self) -> int:
        return self.bits(1)


class PrefixCode:
    """Canonical prefix code decoded MSB-of-code-first from LSB-first bits
    (each code bit is one read_bit)."""

    __slots__ = ("counts", "symbols", "maxlen", "simple")

    def __init__(self, lengths: List[int]):
        maxlen = max(lengths) if lengths else 0
        self.maxlen = maxlen
        # canonical assignment: sort symbols by (length, symbol)
        self.counts = [0] * (maxlen + 1)
        for l in lengths:
            if l:
                self.counts[l] += 1
        self.symbols = sorted(
            (s for s, l in enumerate(lengths) if l),
            key=lambda s: (lengths[s], s),
        )
        nz = [l for l in lengths if l]
        self.simple = self.symbols[0] if len(nz) == 1 else None

    def read(self, br: BitReader) -> int:
        if self.simple is not None:
            return self.simple
        code = 0
        first = 0  # first canonical code of this length
        index = 0  # symbols consumed by shorter lengths
        for l in range(1, self.maxlen + 1):
            code = (code << 1) | br.bit()
            count = self.counts[l]
            if code - first < count:
                return self.symbols[index + code - first]
            index += count
            first = (first + count) << 1
        raise ValueError("VP8L: invalid prefix code")


def _read_prefix_code(br: BitReader, alphabet_size: int) -> PrefixCode:
    if br.bit():  # simple code
        nsym = br.bit() + 1
        if br.bit():  # first symbol is 8 bits
            s0 = br.bits(8)
        else:
            s0 = br.bit()
        lengths = [0] * alphabet_size
        lengths[s0] = 1
        if nsym == 2:
            s1 = br.bits(8)
            lengths[s1] = 1
        return PrefixCode(lengths)

    # code-length code
    num_codes = br.bits(4) + 4
    cl_lengths = [0] * 19
    for i in range(num_codes):
        cl_lengths[_CLC_ORDER[i]] = br.bits(3)
    cl_code = PrefixCode(cl_lengths)

    if br.bit():  # explicit max symbol
        length_nbits = 2 + 2 * br.bits(3)
        max_symbol = 2 + br.bits(length_nbits)
    else:
        max_symbol = alphabet_size

    lengths = [0] * alphabet_size
    prev = 8
    i = 0
    while i < alphabet_size:
        if max_symbol <= 0:
            break
        max_symbol -= 1
        s = cl_code.read(br)
        if s < 16:
            lengths[i] = s
            i += 1
            if s:
                prev = s
        elif s == 16:
            rep = 3 + br.bits(2)
            for _ in range(rep):
                if i < alphabet_size:
                    lengths[i] = prev
                    i += 1
        elif s == 17:
            i += 3 + br.bits(3)
        else:  # 18
            i += 11 + br.bits(7)
    return PrefixCode(lengths)


def _prefix_value(br: BitReader, code: int) -> int:
    """LZ77 length/distance prefix decoding (spec §4.2.2)."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    offset = (2 + (code & 1)) << extra
    return offset + br.bits(extra) + 1


class _Group:
    __slots__ = ("g", "r", "b", "a", "d")


def _read_groups(br: BitReader, n: int, cache_bits: int) -> List[_Group]:
    groups = []
    cache_size = (1 << cache_bits) if cache_bits else 0
    for _ in range(n):
        gr = _Group()
        gr.g = _read_prefix_code(br, 256 + 24 + cache_size)
        gr.r = _read_prefix_code(br, 256)
        gr.b = _read_prefix_code(br, 256)
        gr.a = _read_prefix_code(br, 256)
        gr.d = _read_prefix_code(br, 40)
        groups.append(gr)
    return groups


def _decode_entropy_image(
    br: BitReader, w: int, h: int, allow_meta: bool
) -> np.ndarray:
    """Decode one entropy-coded ARGB image → uint32 [h, w] packed ARGB."""
    cache_bits = br.bits(4) if br.bit() else 0
    cache = np.zeros(1 << cache_bits, np.uint32) if cache_bits else None

    meta = None
    meta_bits = 0
    ngroups = 1
    if allow_meta and br.bit():
        meta_bits = br.bits(3) + 2
        mw = (w + (1 << meta_bits) - 1) >> meta_bits
        mh = (h + (1 << meta_bits) - 1) >> meta_bits
        meta_img = _decode_entropy_image(br, mw, mh, False)
        meta = ((meta_img >> 8) & 0xFFFF).astype(np.int32)
        ngroups = int(meta.max()) + 1

    groups = _read_groups(br, ngroups, cache_bits)
    dist_map = _build_dist_map(w)

    out = np.zeros(w * h, np.uint32)
    pos = 0
    total = w * h
    x = 0
    gr = groups[0]
    row_meta = None
    y = 0
    if meta is not None:
        row_meta = meta[0]
    while pos < total:
        if meta is not None:
            gr = groups[int(row_meta[x >> meta_bits])]
        s = gr.g.read(br)
        if s < 256:
            r = gr.r.read(br)
            b = gr.b.read(br)
            a = gr.a.read(br)
            px = (a << 24) | (r << 16) | (s << 8) | b
            out[pos] = px
            if cache is not None:
                cache[((0x1E35A7BD * px) & 0xFFFFFFFF) >> (32 - cache_bits)] = px
            pos += 1
            x += 1
            if x == w:
                x = 0
                y += 1
                if meta is not None and y < h:
                    row_meta = meta[min(y >> meta_bits, meta.shape[0] - 1)]
        elif s < 256 + 24:
            length = _prefix_value(br, s - 256)
            dcode = gr.d.read(br)
            dist = _prefix_value(br, dcode)
            if dist <= 120:
                dist = int(dist_map[dist - 1])
            else:
                dist -= 120
            if dist > pos:
                raise ValueError("VP8L: invalid back-reference")
            for _ in range(length):
                if pos >= total:
                    break
                px = out[pos - dist]
                out[pos] = px
                if cache is not None:
                    cache[((0x1E35A7BD * int(px)) & 0xFFFFFFFF)
                          >> (32 - cache_bits)] = px
                pos += 1
                x += 1
                if x == w:
                    x = 0
                    y += 1
                    if meta is not None and y < h:
                        row_meta = meta[min(y >> meta_bits, meta.shape[0] - 1)]
        else:
            px = cache[s - 256 - 24]
            out[pos] = px
            pos += 1
            x += 1
            if x == w:
                x = 0
                y += 1
                if meta is not None and y < h:
                    row_meta = meta[min(y >> meta_bits, meta.shape[0] - 1)]
    return out.reshape(h, w)


# ------------------------------------------------------------- transforms
def _inv_subtract_green(argb: np.ndarray) -> np.ndarray:
    g = (argb >> 8) & 0xFF
    r = (((argb >> 16) & 0xFF) + g) & 0xFF
    b = ((argb & 0xFF) + g) & 0xFF
    return (argb & 0xFF00FF00) | (r << 16) | b


def _delta(t: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Signed color-transform delta: (int8(t) * int8(c)) >> 5."""
    ts = t.astype(np.int8).astype(np.int32)
    cs = c.astype(np.int8).astype(np.int32)
    return (ts * cs) >> 5


def _inv_color_transform(argb: np.ndarray, tiles: np.ndarray, bits: int) -> np.ndarray:
    h, w = argb.shape
    ty = np.arange(h) >> bits
    tx = np.arange(w) >> bits
    tile = tiles[np.ix_(ty, tx)]
    # element packing: red_to_blue << 16 | green_to_blue << 8 | green_to_red
    r2b = (tile >> 16) & 0xFF
    g2b = (tile >> 8) & 0xFF
    g2r = tile & 0xFF
    g = (argb >> 8) & 0xFF
    r = (argb >> 16) & 0xFF
    b = argb & 0xFF
    r = (r + _delta(g2r, g)) & 0xFF
    b = (b + _delta(g2b, g) + _delta(r2b, r)) & 0xFF
    return (argb & 0xFF00FF00) | (r.astype(np.uint32) << 16) | b.astype(np.uint32)


def _avg2(a, b):
    return (a + b) // 2


def _inv_predictor(argb: np.ndarray, tiles: np.ndarray, bits: int) -> np.ndarray:
    """Predictor transform inverse — sequential per pixel (14 modes)."""
    h, w = argb.shape
    out = argb.copy()

    def channels(px):
        return np.array(
            [(px >> 24) & 0xFF, (px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF],
            np.int32,
        )

    def pack(c):
        c = c & 0xFF
        return (
            (int(c[0]) << 24) | (int(c[1]) << 16) | (int(c[2]) << 8) | int(c[3])
        )

    for y in range(h):
        trow = tiles[y >> bits]
        for x in range(w):
            if x == 0 and y == 0:
                pred = 0xFF000000
            elif y == 0:
                pred = out[0, x - 1]  # mode 1 (left) forced on first row
            elif x == 0:
                pred = out[y - 1, 0]  # mode 2 (top) forced on first column
            else:
                mode = (int(trow[x >> bits]) >> 8) & 0xFF
                L = channels(out[y, x - 1])
                T = channels(out[y - 1, x])
                TL = channels(out[y - 1, x - 1])
                # TR of the last column is the first pixel of the current
                # row (scan-order addressing, RFC 9649 §4.4.2)
                TR = channels(out[y - 1, x + 1] if x + 1 < w else out[y, 0])
                if mode == 0:
                    pred = 0xFF000000
                elif mode == 1:
                    pred = out[y, x - 1]
                elif mode == 2:
                    pred = out[y - 1, x]
                elif mode == 3:
                    pred = out[y - 1, x + 1] if x + 1 < w else out[y, 0]
                elif mode == 4:
                    pred = out[y - 1, x - 1]
                elif mode == 5:
                    pred = pack(_avg2(_avg2(L, TR), T))
                elif mode == 6:
                    pred = pack(_avg2(L, TL))
                elif mode == 7:
                    pred = pack(_avg2(L, T))
                elif mode == 8:
                    pred = pack(_avg2(TL, T))
                elif mode == 9:
                    pred = pack(_avg2(T, TR))
                elif mode == 10:
                    pred = pack(_avg2(_avg2(L, TL), _avg2(T, TR)))
                elif mode == 11:  # select
                    pL = np.abs(T - TL).sum()
                    pT = np.abs(L - TL).sum()
                    pred = out[y, x - 1] if pL < pT else out[y - 1, x]
                elif mode == 12:  # clamp add subtract full
                    pred = pack(np.clip(L + T - TL, 0, 255))
                else:  # 13: clamp add subtract half (C trunc-toward-zero div)
                    avg = _avg2(L, T)
                    d = avg - TL
                    half = np.sign(d) * (np.abs(d) // 2)
                    pred = pack(np.clip(avg + half, 0, 255))
            a = (int(out[y, x]) + int(pred)) & 0xFFFFFFFF
            # per-channel modular add
            s = int(out[y, x])
            p = int(pred)
            px = 0
            for shift in (24, 16, 8, 0):
                px |= (((s >> shift) + (p >> shift)) & 0xFF) << shift
            out[y, x] = px
    return out


def _sub_image_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def decode_vp8l(payload: bytes, size=None) -> np.ndarray:
    """Decode a VP8L chunk payload → [h, w, 4] RGBA uint8.

    size=(w, h): headerless mode — an ALPH chunk's lossless alpha stream
    has no signature/dims/version (the container supplies the frame size);
    the stream starts directly at the transform loop."""
    br = BitReader(payload)
    if size is not None:
        w, h = size
    else:
        if br.bits(8) != 0x2F:
            raise ValueError("VP8L: bad signature")
        w = br.bits(14) + 1
        h = br.bits(14) + 1
        br.bit()  # alpha hint
        if br.bits(3) != 0:
            raise ValueError("VP8L: unsupported version")

    transforms = []  # applied in reverse order after decode
    xsize = w
    palette = None
    while br.bit():
        ttype = br.bits(2)
        if ttype == 0:  # predictor
            bits = br.bits(3) + 2
            tw, th = _sub_image_size(xsize, bits), _sub_image_size(h, bits)
            tiles = _decode_entropy_image(br, tw, th, False)
            transforms.append(("pred", bits, tiles))
        elif ttype == 1:  # color transform
            bits = br.bits(3) + 2
            tw, th = _sub_image_size(xsize, bits), _sub_image_size(h, bits)
            tiles = _decode_entropy_image(br, tw, th, False)
            transforms.append(("color", bits, tiles))
        elif ttype == 2:
            transforms.append(("subgreen",))
        else:  # color indexing
            psize = br.bits(8) + 1
            pal_img = _decode_entropy_image(br, psize, 1, False)[0]
            # palette entries are delta-coded
            pal = np.zeros(psize, np.uint32)
            prev = 0
            for i in range(psize):
                v = 0
                s = int(pal_img[i])
                p = int(prev)
                for shift in (24, 16, 8, 0):
                    v |= (((s >> shift) + (p >> shift)) & 0xFF) << shift
                pal[i] = v
                prev = v
            if psize <= 2:
                xbits = 3
            elif psize <= 4:
                xbits = 2
            elif psize <= 16:
                xbits = 1
            else:
                xbits = 0
            xsize = _sub_image_size(w, xbits)
            transforms.append(("palette", xbits, pal))
            palette = pal

    argb = _decode_entropy_image(br, xsize, h, True)

    for t in reversed(transforms):
        if t[0] == "pred":
            argb = _inv_predictor(argb, t[2], t[1])
        elif t[0] == "color":
            argb = _inv_color_transform(argb, t[2], t[1])
        elif t[0] == "subgreen":
            argb = _inv_subtract_green(argb)
        else:  # palette
            xbits, pal = t[1], t[2]
            if xbits:
                per = 1 << xbits
                bw = 8 >> xbits
                idx = (argb >> 8) & 0xFF  # green holds packed indices
                cols = []
                for i in range(per):
                    cols.append((idx >> (i * bw)) & ((1 << bw) - 1))
                unpacked = np.stack(cols, axis=-1).reshape(h, -1)[:, :w]
            else:
                unpacked = (argb >> 8) & 0xFF
            unpacked = np.clip(unpacked, 0, len(pal) - 1)
            argb = pal[unpacked.astype(np.int32)]

    a = (argb >> 24) & 0xFF
    r = (argb >> 16) & 0xFF
    g = (argb >> 8) & 0xFF
    b = argb & 0xFF
    return np.stack([r, g, b, a], axis=-1).astype(np.uint8)


# ------------------------------------------------------------- lossy (VP8)
def _riff_chunks(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP")
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        tag = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        yield tag, data[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)


def _fancy_upsample(p: np.ndarray, H: int, W: int) -> np.ndarray:
    """libwebp's "fancy" chroma upsampler: quarter-phase bilinear with
    (9,3,3,1)/16 weights and edge replication — reproduced exactly so the
    RGB output is bit-identical to libwebp's."""
    ext = np.empty((p.shape[0] + 2, p.shape[1] + 2), np.int32)
    ext[1:-1, 1:-1] = p
    ext[0, :] = ext[1, :]
    ext[-1, :] = ext[-2, :]
    ext[:, 0] = ext[:, 1]
    ext[:, -1] = ext[:, -2]
    c = ext[1:-1, 1:-1]
    l = ext[1:-1, :-2]
    r = ext[1:-1, 2:]
    t = ext[:-2, 1:-1]
    b = ext[2:, 1:-1]
    tl = ext[:-2, :-2]
    tr = ext[:-2, 2:]
    bl = ext[2:, :-2]
    br = ext[2:, 2:]
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    out[0::2, 0::2] = (9 * c + 3 * (l + t) + tl + 8) >> 4
    out[0::2, 1::2] = (9 * c + 3 * (r + t) + tr + 8) >> 4
    out[1::2, 0::2] = (9 * c + 3 * (l + b) + bl + 8) >> 4
    out[1::2, 1::2] = (9 * c + 3 * (r + b) + br + 8) >> 4
    return out[:H, :W]


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fixed-point full-range YUV→RGB (yuv.h constants)."""
    y = y.astype(np.int32)

    def mh(a, c):
        return (a * c) >> 8

    def clip8(x):
        return np.where((x & ~((256 << 6) - 1)) == 0, x >> 6,
                        np.where(x < 0, 0, 255)).astype(np.uint8)

    ybase = mh(y, 19077)
    r = clip8(ybase + mh(v, 26149) - 14234)
    g = clip8(ybase - mh(u, 6419) - mh(v, 13320) + 8708)
    b = clip8(ybase + mh(u, 33050) - 17685)
    return np.stack([r, g, b], axis=-1)


def _alpha_unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """Undo the ALPH chunk's prediction filter (container spec / libwebp
    dsp/filters.c semantics): 0 none, 1 horizontal, 2 vertical, 3
    gradient. Row 0 always unfilters horizontally."""
    if method == 0:
        return a
    H, W = a.shape
    out = np.zeros_like(a, np.int32)
    src = a.astype(np.int32)
    # row 0: horizontal
    out[0] = np.cumsum(src[0], dtype=np.int64) & 0xFF
    if method == 1:  # horizontal: left predictor, x=0 predicted by above
        for y in range(1, H):
            row = src[y].copy()
            row[0] = (row[0] + out[y - 1, 0]) & 0xFF
            out[y] = np.cumsum(row, dtype=np.int64) & 0xFF
    elif method == 2:  # vertical
        for y in range(1, H):
            out[y] = (src[y] + out[y - 1]) & 0xFF
    else:  # gradient
        for y in range(1, H):
            prev = out[y - 1]
            left = int(prev[0])
            top_left = left
            row = src[y]
            dst = out[y]
            for x in range(W):
                top = int(prev[x])
                g = left + top - top_left
                if g < 0:
                    g = 0
                elif g > 255:
                    g = 255
                left = (int(row[x]) + g) & 0xFF
                dst[x] = left
                top_left = top
    return out.astype(np.uint8)


def _decode_alph(body: bytes, W: int, H: int) -> np.ndarray:
    """ALPH chunk → [H, W] u8 alpha. Header byte: C (bits 0-1: 0 raw,
    1 lossless), F filter (2-3), P pre-processing (4-5, no decode
    action)."""
    hdr = body[0]
    comp = hdr & 3
    filt = (hdr >> 2) & 3
    if comp == 0:
        if len(body) < 1 + W * H:
            raise ValueError("ALPH: short raw alpha")
        a = np.frombuffer(body, np.uint8, W * H, 1).reshape(H, W)
    elif comp == 1:
        rgba = decode_vp8l(body[1:], size=(W, H))
        a = rgba[:, :, 1]  # alpha rides the green channel
    else:
        raise ValueError("ALPH: unknown compression method")
    return _alpha_unfilter(a, filt)


def decode_webp_lossy(data: bytes) -> np.ndarray:
    """RIFF walk → VP8 keyframe payload → native RFC 6386 decode
    (native/webp_vp8.cpp, bit-exact vs libwebp YUV) → fancy upsample +
    fixed-point color convert (bit-exact vs libwebp RGB). An ALPH chunk
    (raw or lossless alpha, all four prediction filters) decodes natively
    too → [H, W, 4]."""
    import ctypes

    from ..native import lib

    payload = None
    alph = None
    for tag, body in _riff_chunks(data):
        if tag == b"ALPH":
            alph = body
        if tag == b"VP8 ":
            payload = body
            break
    if payload is None:
        raise ValueError("WebP: no VP8 chunk")
    L = lib()
    cap = 1 << 24
    y = np.empty(cap, np.uint8)
    u = np.empty(cap, np.uint8)
    v = np.empty(cap, np.uint8)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = L.tic_vp8_decode(
        payload, len(payload),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(w), ctypes.byref(h), 0,
    )
    if rc != 0:
        raise ValueError(f"VP8 decode failed rc={rc}")
    W, H = w.value, h.value
    cw, ch = (W + 1) // 2, (H + 1) // 2
    Y = y[: W * H].reshape(H, W)
    U = _fancy_upsample(u[: cw * ch].reshape(ch, cw), H, W)
    V = _fancy_upsample(v[: cw * ch].reshape(ch, cw), H, W)
    rgb = _yuv_to_rgb(Y, U, V)
    if alph is not None:
        a = _decode_alph(bytes(alph), W, H)
        return np.dstack([rgb, a])
    return rgb


def decode_webp_lossless(data: bytes) -> np.ndarray:
    """RIFF walk → VP8L payload → RGBA (alpha dropped if fully opaque)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP")
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        tag = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        if tag == b"VP8L":
            img = decode_vp8l(data[pos + 8 : pos + 8 + size])
            if (img[..., 3] == 255).all():
                img = np.ascontiguousarray(img[..., :3])
            return img
        pos += 8 + size + (size & 1)
    raise ValueError("WebP: no VP8L chunk (lossy VP8 handled by fallback)")




# ------------------------------------------------------------------ encode
class BitWriterLSB:
    """LSB-first bit writer (VP8L payload convention)."""

    __slots__ = ("out", "acc", "n")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, v: int, k: int) -> None:
        self.acc |= (v & ((1 << k) - 1)) << self.n
        self.n += k
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def finish(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)


def _limited_huffman_lengths(freq: np.ndarray, max_len: int = 15) -> np.ndarray:
    """Length-limited Huffman code lengths with an EXACT Kraft sum of 1.

    Decoders (libwebp's BuildHuffmanTable included) reject incomplete
    prefix codes, so after clamping over-long codes the lengths are
    adjusted until sum(2^-len) == 1: clamping only over-fills (> 1), the
    over-full tree is fixed by deepening the cheapest symbols, and any
    over-shoot is returned by shortening the deepest symbol whose gain
    fits the remaining deficit (all gains are powers of two, so the
    greedy always lands exactly)."""
    n = len(freq)
    lengths = np.zeros(n, np.int32)
    nz = np.nonzero(freq)[0]
    if len(nz) == 0:
        return lengths
    if len(nz) == 1:
        lengths[nz[0]] = 1
        return lengths
    import heapq

    heap = [(int(freq[i]), int(i), (int(i),)) for i in nz]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for sym in s1 + s2:
            lengths[sym] += 1
        heapq.heappush(heap, (f1 + f2, min(s1 + s2), s1 + s2))
    if lengths.max() <= max_len:
        return lengths
    lengths = np.minimum(lengths, max_len)
    unit = 1 << max_len
    kraft = int(sum(1 << (max_len - int(lengths[i])) for i in nz))
    # over-full from clamping: deepen lowest-frequency symbols first
    while kraft > unit:
        cand = [int(i) for i in nz if lengths[i] < max_len]
        i = min(cand, key=lambda j: (int(freq[j]), j))
        kraft -= 1 << (max_len - int(lengths[i]) - 1)
        lengths[i] += 1
    # give back any over-shoot: shorten the deepest symbol whose gain
    # fits (gains are powers of two; highest-frequency first at a depth)
    while kraft < unit:
        deficit = unit - kraft
        best = None
        for i in nz:
            li = int(lengths[i])
            if li <= 1:
                continue
            gain = 1 << (max_len - li)
            if gain <= deficit and (
                best is None
                or (li, int(freq[i])) > (int(lengths[best]),
                                         int(freq[best]))
            ):
                best = int(i)
        if best is None:  # cannot land exactly: deepen cheapest and retry
            cand = [int(i) for i in nz if lengths[i] < max_len]
            i = min(cand, key=lambda j: (int(freq[j]), j))
            kraft -= 1 << (max_len - int(lengths[i]) - 1)
            lengths[i] += 1
            continue
        kraft += 1 << (max_len - int(lengths[best]))
        lengths[best] -= 1
    return lengths


def _write_prefix_code(bw: BitWriterLSB, lengths: np.ndarray) -> None:
    """Emit one prefix code: simple form for <=2 symbols, else the
    code-length-code form (RFC 9649 §3.5)."""
    syms = np.nonzero(lengths)[0]
    if len(syms) <= 2 and (len(syms) == 0 or syms.max() <= 255):
        bw.bits(1, 1)  # simple
        nsym = max(1, len(syms))
        bw.bits(len(syms) - 1 if len(syms) else 0, 1)
        first = int(syms[0]) if len(syms) else 0
        if first <= 1 and len(syms):
            bw.bits(0, 1)  # 1-bit first symbol
            bw.bits(first, 1)
        else:
            bw.bits(1, 1)
            bw.bits(first, 8)
        if len(syms) == 2:
            bw.bits(int(syms[1]), 8)
        return

    bw.bits(0, 1)  # normal form
    # RLE the length array with 16 (repeat prev non-zero), 17/18 (zero runs)
    tokens = []  # (symbol, extra_value, extra_bits)
    i = 0
    n = len(lengths)
    prev_nz = 8
    while i < n:
        l = int(lengths[i])
        if l == 0:
            run = 1
            while i + run < n and lengths[i + run] == 0:
                run += 1
            i += run
            while run >= 11:
                r = min(run, 138)
                tokens.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                tokens.append((17, run - 3, 3))
                run = 0
            for _ in range(run):
                tokens.append((0, 0, 0))
        else:
            tokens.append((l, 0, 0))
            prev = l
            i += 1
            run = 0
            while i + run < n and lengths[i + run] == prev:
                run += 1
            reps = run
            i += run
            while reps >= 3:
                r = min(reps, 6)
                tokens.append((16, r - 3, 2))
                reps -= r
            for _ in range(reps):
                tokens.append((prev, 0, 0))
    clc_freq = np.zeros(19, np.int64)
    for sym, _, _ in tokens:
        clc_freq[sym] += 1
    clc_len = _limited_huffman_lengths(clc_freq, 7)
    # emit CLC lengths in the fixed order, trimmed
    order_pos = {s: i for i, s in enumerate(_CLC_ORDER)}
    ordered = [int(clc_len[s]) for s in _CLC_ORDER]
    num = 19
    while num > 4 and ordered[num - 1] == 0:
        num -= 1
    bw.bits(num - 4, 4)
    for i in range(num):
        bw.bits(ordered[i], 3)
    clc = PrefixCode(list(clc_len))
    codes = _canonical_codes(clc_len)
    bw.bits(0, 1)  # no explicit max_symbol
    for sym, extra, nbits in tokens:
        c, l = codes[sym]
        bw.bits(_reverse_bits(c, l), l)
        if nbits:
            bw.bits(extra, nbits)


def _canonical_codes(lengths) -> dict:
    """{symbol: (code, length)} canonical (sorted by length then symbol)."""
    pairs = sorted(
        (int(l), s) for s, l in enumerate(lengths) if l
    )
    codes = {}
    code = 0
    prev_len = 0
    for l, s in pairs:
        code <<= (l - prev_len)
        codes[s] = (code, l)
        code += 1
        prev_len = l
    return codes


def _reverse_bits(v: int, n: int) -> int:
    """Prefix-code bits are written so the decoder's MSB-first per-bit walk
    sees them in order; with an LSB-first byte writer that means emitting
    the code MSB-first bit by bit (i.e. bit-reversed as one field)."""
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def encode_webp_lossless(img: np.ndarray) -> bytes:
    """Encode [H,W,3] or [H,W,4] u8 → lossless WebP (VP8L).

    Minimal-but-valid stream: subtract-green transform + one prefix-code
    group of order-0 optimized codes (no LZ77/palette/predictor — decoders
    are agnostic; compression is entropy-bound). The reference cannot encode
    WebP at all; this rounds out the drop-in matrix.
    """
    if img.ndim == 2:
        img = np.dstack([img] * 3)
    h, w, ch = img.shape
    has_alpha = ch == 4
    r = img[..., 0].astype(np.int32)
    g = img[..., 1].astype(np.int32)
    b = img[..., 2].astype(np.int32)
    a = img[..., 3].astype(np.int32) if has_alpha else np.full((h, w), 255, np.int32)
    # subtract-green (forward)
    r_ = (r - g) & 0xFF
    b_ = (b - g) & 0xFF

    bw = BitWriterLSB()
    bw.bits(0x2F, 8)
    bw.bits(w - 1, 14)
    bw.bits(h - 1, 14)
    bw.bits(1 if has_alpha else 0, 1)
    bw.bits(0, 3)  # version
    bw.bits(1, 1)  # transform present
    bw.bits(2, 2)  # subtract-green
    bw.bits(0, 1)  # no more transforms
    bw.bits(0, 1)  # no color cache
    bw.bits(0, 1)  # no meta-prefix

    def hist(vals, size):
        f = np.zeros(size, np.int64)
        np.add.at(f, vals.reshape(-1), 1)
        return f

    green_len = _limited_huffman_lengths(hist(g, 280))
    red_len = _limited_huffman_lengths(hist(r_, 256))
    blue_len = _limited_huffman_lengths(hist(b_, 256))
    alpha_len = _limited_huffman_lengths(hist(a, 256))
    dist_len = np.zeros(40, np.int32)
    dist_len[0] = 1  # unused, single-symbol code
    for lens in (green_len, red_len, blue_len, alpha_len, dist_len):
        _write_prefix_code(bw, lens)

    gc = _canonical_codes(green_len)
    rc = _canonical_codes(red_len)
    bc = _canonical_codes(blue_len)
    ac = _canonical_codes(alpha_len)
    single_alpha = len(ac) == 1

    gf, rf, bf, af = g.reshape(-1), r_.reshape(-1), b_.reshape(-1), a.reshape(-1)
    for i in range(gf.shape[0]):
        c, l = gc[int(gf[i])]
        bw.bits(_reverse_bits(c, l), l)
        c, l = rc[int(rf[i])]
        bw.bits(_reverse_bits(c, l), l)
        c, l = bc[int(bf[i])]
        bw.bits(_reverse_bits(c, l), l)
        if not single_alpha:
            c, l = ac[int(af[i])]
            bw.bits(_reverse_bits(c, l), l)
    payload = bw.finish()

    riff = b"VP8L" + len(payload).to_bytes(4, "little") + payload
    if len(payload) & 1:
        riff += b"\x00"
    out = b"RIFF" + (len(riff) + 4).to_bytes(4, "little") + b"WEBP" + riff
    return out


def encode_webp_lossy(img: np.ndarray, quality: float = 75.0) -> bytes:
    """Encode [H,W,3] u8 → lossy WebP (native VP8 keyframe encoder,
    native/webp_vp8_encode.cpp). RGB → BT.601 studio-range YUV420, then the
    RFC 6386 intra encoder (16x16 modes, default probabilities). Streams
    decode bit-identically in our native decoder and libwebp. The counter
    part of the reference's OpenCV lossy-WebP encode
    (extensions/opencv/opencv_encoder.cpp, IMWRITE_WEBP_QUALITY)."""
    import ctypes
    import struct

    from ..native import lib

    if img.ndim == 2:
        img = np.dstack([img] * 3)
    if img.shape[-1] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError("lossy WebP encode wants [H,W,3|4] u8")
    alpha = img[:, :, 3] if img.shape[-1] == 4 else None
    img = img[:, :, :3]
    H, W = img.shape[:2]
    r = img[:, :, 0].astype(np.int32)
    g = img[:, :, 1].astype(np.int32)
    b = img[:, :, 2].astype(np.int32)
    Y = np.clip(((16839 * r + 33059 * g + 6420 * b + 32768) >> 16) + 16,
                0, 255).astype(np.uint8)
    U = np.clip(((-9719 * r - 19081 * g + 28800 * b + 32768) >> 16) + 128,
                0, 255)
    V = np.clip(((28800 * r - 24116 * g - 4684 * b + 32768) >> 16) + 128,
                0, 255)

    def ss(p):  # 2x2 box subsample with rounding
        pe = np.pad(p, ((0, H % 2), (0, W % 2)), mode="edge")
        return ((pe[0::2, 0::2] + pe[0::2, 1::2]
                 + pe[1::2, 0::2] + pe[1::2, 1::2] + 2) >> 2).astype(np.uint8)

    import os

    # quality -> qindex calibrated so stream sizes track libwebp's at the
    # same quality setting (piecewise-linear through size-matched points on
    # the photo corpus; libwebp's own curve is nonlinear in qindex)
    q = min(100.0, max(0.0, quality))
    pts = [(0.0, 127), (25.0, 68), (50.0, 56), (75.0, 40), (90.0, 12),
           (100.0, 0)]
    qindex = 0
    for (q0, v0), (q1, v1) in zip(pts, pts[1:]):
        if q <= q1:
            qindex = int(round(v0 + (v1 - v0) * (q - q0) / (q1 - q0)))
            break
    L = lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    stats = (ctypes.c_int32 * 2)()
    rc = L.tic_vp8_encode(
        np.ascontiguousarray(Y).tobytes(), ss(U).tobytes(), ss(V).tobytes(),
        W, H, qindex, ctypes.byref(out), ctypes.byref(n),
        1 if os.environ.get("TIC_VP8_NO_BPRED") else 0, stats)
    if rc != 0:
        raise ValueError(f"VP8 encode failed rc={rc}")
    payload = ctypes.string_at(out, n.value)
    ctypes.CDLL(None).free(out)
    chunks = b""
    if alpha is not None:
        # extended container: VP8X (alpha flag) + ALPH (method 0: raw
        # alpha, no filter) before the VP8 frame
        vp8x = bytes([0x10, 0, 0, 0]) + struct.pack(
            "<I", W - 1)[:3] + struct.pack("<I", H - 1)[:3]
        chunks += b"VP8X" + struct.pack("<I", len(vp8x)) + vp8x
        ab = b"\x00" + np.ascontiguousarray(alpha).tobytes()
        chunks += b"ALPH" + struct.pack("<I", len(ab)) + ab
        if len(ab) & 1:
            chunks += b"\x00"
    chunks += b"VP8 " + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


class WebpVp8Encoder(EncoderPlugin):
    """Lossy WebP encode (native VP8). Takes the bucket when the caller
    asks for lossy quality (< 95); alpha and the default/lossless request
    fall through to the VP8L encoder below."""

    codec = "webp"
    plugin_id = "tpu_webp_vp8_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.HIGH

    def can_encode(self, image_batch, info_batch, params):
        out = []
        lossy = params is not None and getattr(params, "quality", 95) < 95
        for img in image_batch:
            arr = np.asarray(img)
            ok = (lossy and arr.dtype == np.uint8
                  and (arr.ndim == 2
                       or (arr.ndim == 3 and arr.shape[-1] in (3, 4))))
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params):
        q = float(getattr(params, "quality", 75.0) or 75.0)
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(
                        ProcessingStatus.SUCCESS,
                        encode_webp_lossy(np.asarray(img), q),
                    )
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


class WebpLosslessEncoder(EncoderPlugin):
    codec = "webp"
    plugin_id = "tpu_webp_lossless_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_encode(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            arr = np.asarray(img)
            ok = arr.dtype == np.uint8 and (
                arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] in (3, 4))
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(
                        ProcessingStatus.SUCCESS,
                        encode_webp_lossless(np.asarray(img)),
                    )
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


class WebpLosslessDecoder(DecoderPlugin):
    codec = "webp"
    plugin_id = "tpu_webp_lossless_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL  # above the system-libwebp fallback (LOW)

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:16])
            ok = (
                head[:4] == b"RIFF"
                and head[8:12] == b"WEBP"
                and head[12:16] == b"VP8L"
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS,
                        decode_webp_lossless(bytes(data)),
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class WebpVp8Decoder(DecoderPlugin):
    """Native lossy (VP8 keyframe) WebP decoder: RFC 6386 entropy/intra/
    loop-filter in C++ (native/webp_vp8.cpp, bit-exact vs libwebp YUV) with
    libwebp-exact upsampling + color conversion; ALPH chunks (raw or
    lossless alpha) decode natively too. Animations decline here and are
    handled by webp_anim.WebpAnimDecoder."""

    codec = "webp"
    plugin_id = "tpu_webp_vp8_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL  # above the system-libwebp fallback (LOW)

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:40])
            ok = head[:4] == b"RIFF" and head[8:12] == b"WEBP"
            if ok:
                try:
                    tags = [t for t, _ in _riff_chunks(bytes(data))]
                    ok = b"VP8 " in tags and b"ANIM" not in tags
                except Exception:
                    ok = False
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS,
                        decode_webp_lossy(bytes(data)),
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


def register(registry) -> None:
    from .webp_anim import WebpAnimDecoder

    registry.codec("webp").register_decoder(WebpLosslessDecoder())
    registry.codec("webp").register_decoder(WebpVp8Decoder())
    registry.codec("webp").register_decoder(WebpAnimDecoder())
    registry.codec("webp").register_encoder(WebpVp8Encoder())
    registry.codec("webp").register_encoder(WebpLosslessEncoder())
