"""A plain baseline JPEG encoder and decoder in NumPy.

The benchmark's own codec: it makes every JPEG input from the seed, and it
is the reference that judges what the measured program decodes and
encodes. It imports nothing of the program.

Semantics (ITU-T T.81 baseline, JFIF colour):
- colour: full-range YCbCr with libjpeg's 16-bit fixed-point constants
  (jccolor.c / jdcolor.c);
- 4:2:0: a plane is padded to even size by repeating its last row and
  column, averaged over 2x2 with libjpeg's alternating bias 1, 2
  (jcsample.c h2v2_downsample), and padded to whole blocks by repetition;
  decoding upsamples with libjpeg's triangular "fancy" filter
  (jdsample.c h2v2_fancy_upsample), edges repeated;
- DCT: the orthonormal 8x8 transform as a [64, 64] product in float64
  (or, with `precision="tf32"`, with both operands rounded to TF32's 10-bit
  mantissa: the control); the encoder rounds c / q half away from zero, the
  decoder rounds samples half to even and clips;
- Huffman: the Annex K.3 tables, or tables made for each image from its
  symbol counts by the Annex K.2 procedure.

Only what the benchmark needs is here: 8-bit, 1 or 3 components, sampling
4:4:4 or 4:2:0, one interleaved sequential scan, no restart markers.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# zigzag index -> natural (row-major) position, T.81 figure A.6
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# T.81 Annex K.1 quantisation tables, natural order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)

# T.81 Annex K.3 Huffman tables: (counts of codes of length 1..16, values)
STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
STD_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
STD_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

_FIX16 = {  # round(x * 2^16), libjpeg's constants
    "0.29900": 19595, "0.58700": 38470, "0.11400": 7471,
    "0.16874": 11059, "0.33126": 21709, "0.50000": 32768,
    "0.41869": 27439, "0.08131": 5329,
    "1.40200": 91881, "0.34414": 22554, "0.71414": 46802, "1.77200": 116130,
}
_HALF16 = 1 << 15


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG quality scaling of a base table (libjpeg jcparam.c)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


# --------------------------------------------------------------------------
# products
# --------------------------------------------------------------------------

def _dct_basis() -> np.ndarray:
    """C[k, x] = c(k) / 2 * cos((2x + 1) k pi / 16)."""
    k = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(k == 0, 1 / np.sqrt(2), 1.0)
    return 0.5 * c * np.cos((2 * x + 1) * k * np.pi / 16)


_C = _dct_basis()
FDCT_64 = np.kron(_C, _C)      # coefficients = FDCT_64 @ samples
IDCT_64 = FDCT_64.T.copy()     # samples = IDCT_64 @ coefficients


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away from zero, as the tensor cores round their inputs)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def product(a: np.ndarray, m: np.ndarray, precision: str) -> np.ndarray:
    """a @ m.T: [..., 64] by [64, 64] in float64, or with both operands
    rounded to TF32 and sums in float32 ("tf32")."""
    if precision == "float64":
        return a.astype(np.float64) @ m.T
    if precision == "tf32":
        return (round_tf32(a.astype(np.float32))
                @ round_tf32(m.astype(np.float32)).T)
    raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------------------
# pixel stages
# --------------------------------------------------------------------------

def _y(r, g, b):
    f = _FIX16
    return (f["0.29900"] * r + f["0.58700"] * g + f["0.11400"] * b
            + _HALF16) >> 16


def _cb(r, g, b):
    f = _FIX16
    return (-f["0.16874"] * r - f["0.33126"] * g + f["0.50000"] * b
            + (128 << 16) + _HALF16 - 1) >> 16


def _cr(r, g, b):
    f = _FIX16
    return (f["0.50000"] * r - f["0.41869"] * g - f["0.08131"] * b
            + (128 << 16) + _HALF16 - 1) >> 16


def rgb_to_ycc(img: np.ndarray):
    """uint8 [H, W, 3] -> (Y, Cb, Cr) int64 planes (jccolor.c)."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return _y(r, g, b), _cb(r, g, b), _cr(r, g, b)


def _r(y, cb, cr):
    return y + ((_FIX16["1.40200"] * (cr - 128) + _HALF16) >> 16)


def _g(y, cb, cr):
    return y + ((-_FIX16["0.34414"] * (cb - 128)
                 - _FIX16["0.71414"] * (cr - 128) + _HALF16) >> 16)


def _b(y, cb, cr):
    return y + ((_FIX16["1.77200"] * (cb - 128) + _HALF16) >> 16)


def _rgb(r, g, b) -> np.ndarray:
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """int planes of one size -> uint8 [H, W, 3] (jdcolor.c)."""
    y, cb, cr = (p.astype(np.int64) for p in (y, cb, cr))
    return _rgb(_r(y, cb, cr), _g(y, cb, cr), _b(y, cb, cr))


def pad_edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Repeat the last row and column of p up to [h, w]."""
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def downsample_h2v2(p: np.ndarray) -> np.ndarray:
    """2x2 average with the alternating bias 1, 2 along each row."""
    p = pad_edge(p, -(-p.shape[0] // 2) * 2, -(-p.shape[1] // 2) * 2)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) % 2)
    return (s + bias[None, :]) >> 2


def upsample_h2v2_fancy(p: np.ndarray) -> np.ndarray:
    """Triangular 2x2 upsampling: each output sample weighs its nearest
    input sample 9, the two beside it 3 and the diagonal one 1, with the
    rounding of jdsample.c (+8 even columns, +7 odd); edges repeated."""
    p = p.astype(np.int64)
    up = np.concatenate([p[:1], p[:-1]], 0)
    down = np.concatenate([p[1:], p[-1:]], 0)
    rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    rows[0::2] = 3 * p + up
    rows[1::2] = 3 * p + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
    out = np.empty((rows.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out


def to_blocks(p: np.ndarray) -> np.ndarray:
    """[8*bh, 8*bw] -> [bh, bw, 64] natural order."""
    bh, bw = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)


def from_blocks(b: np.ndarray) -> np.ndarray:
    """[bh, bw, 64] -> [8*bh, 8*bw]."""
    bh, bw = b.shape[:2]
    return b.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8,
                                                                 bw * 8)


@dataclass
class Frame:
    """What a stream says about its image."""
    height: int
    width: int
    # (id, h, v, quant table id) a component
    components: List[Tuple[int, int, int, int]]
    quant: Dict[int, np.ndarray] = field(default_factory=dict)  # natural
    # (class, id) -> (counts[16], values)
    huffman: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = field(
        default_factory=dict)
    # per scan component: (component index, dc table, ac table)
    scan: List[Tuple[int, int, int]] = field(default_factory=list)
    marker: int = 0xC0
    restart_interval: int = 0
    data: bytes = b""  # the entropy-coded segment, stuffed

    @property
    def hmax(self) -> int:
        return max(c[1] for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c[2] for c in self.components)

    def mcus(self) -> Tuple[int, int]:
        return (-(-self.width // (8 * self.hmax)),
                -(-self.height // (8 * self.vmax)))

    def block_dims(self) -> List[Tuple[int, int]]:
        """(bh, bw) of each component's coded block grid."""
        mx, my = self.mcus()
        return [(my * v, mx * h) for _id, h, v, _t in self.components]


def layout(height: int, width: int, subsampling: str, quality: int) -> Frame:
    """The frame of an encode: 4:2:0 or 4:4:4 (3 components) or gray."""
    if subsampling == "gray":
        comps = [(1, 1, 1, 0)]
    elif subsampling in ("420", "444"):
        f = 2 if subsampling == "420" else 1
        comps = [(1, f, f, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    else:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    frame = Frame(height, width, comps)
    frame.quant = {0: quality_table(LUMA_QUANT, quality)}
    if len(comps) == 3:
        frame.quant[1] = quality_table(CHROMA_QUANT, quality)
    return frame


def encode_coefficients(img: np.ndarray, frame: Frame,
                        precision: str = "float64") -> List[np.ndarray]:
    """uint8 [H, W, 3] (or [H, W] for gray) -> quantised coefficients of
    each component, int32 [bh, bw, 64] natural order."""
    if len(frame.components) == 1:
        planes = [rgb_to_ycc(img)[0] if img.ndim == 3 else
                  img.astype(np.int64)]
    else:
        planes = list(rgb_to_ycc(img))
    hmax, vmax = frame.hmax, frame.vmax
    out = []
    for (_id, h, v, tq), p, (bh, bw) in zip(frame.components, planes,
                                            frame.block_dims()):
        if (hmax // h, vmax // v) == (2, 2):
            p = downsample_h2v2(p)
        elif (hmax, vmax) != (h, v):
            raise ValueError("only 4:4:4 and 4:2:0")
        x = to_blocks(pad_edge(p, bh * 8, bw * 8)).astype(np.float64) - 128
        c = product(x, FDCT_64, precision) / frame.quant[tq][None, None, :]
        out.append((np.sign(c) * np.floor(np.abs(c) + 0.5)).astype(np.int32))
    return out


def _planes(frame: Frame, samples: List[np.ndarray]) -> List[np.ndarray]:
    """Each component's int samples [bh, bw, 64] -> its plane cropped to
    the image and upsampled to full size."""
    H, W = frame.height, frame.width
    hmax, vmax = frame.hmax, frame.vmax
    out = []
    for (_id, h, v, _tq), s in zip(frame.components, samples):
        p = from_blocks(s.astype(np.int64))
        p = p[:-(-H * v // vmax), :-(-W * h // hmax)]
        if (hmax // h, vmax // v) == (2, 2):
            p = upsample_h2v2_fancy(p)
        elif (hmax, vmax) != (h, v):
            raise ValueError("only 4:4:4 and 4:2:0")
        out.append(p[:H, :W])
    return out


def decode_pixels(frame: Frame, coefs: List[np.ndarray],
                  precision: str = "float64") -> np.ndarray:
    """Quantised coefficients [bh, bw, 64] natural order of each component
    -> uint8 image [H, W, 3] (or [H, W])."""
    samples = []
    for (_id, _h, _v, tq), c in zip(frame.components, coefs):
        deq = c.astype(np.float64) * frame.quant[tq][None, None, :]
        samples.append(np.clip(np.rint(product(deq, IDCT_64, precision)
                                       + 128), 0, 255))
    planes = _planes(frame, samples)
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_rgb(*planes)


def decode(data: bytes, precision: str = "float64") -> np.ndarray:
    """A whole stream -> its uint8 image."""
    frame = parse(data)
    return decode_pixels(frame, entropy_decode(frame), precision)


# --------------------------------------------------------------------------
# Huffman tables
# --------------------------------------------------------------------------

def code_table(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol value (T.81 Annex C)."""
    counts, values = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[values[k]] = code
            len_of[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def optimal_table(freq: np.ndarray):
    """Annex K.2: code lengths from symbol counts (a reserved symbol keeps
    the all-ones code out), limited to 16 bits, as (counts, values)."""
    freq = [int(f) for f in freq] + [1]  # index 256: the reserved symbol
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v1 = v2 = None
        for i, f in enumerate(freq):  # the two least, larger index on ties
            if f <= 0:
                continue
            if v1 is None or f <= v1:
                c2, v2 = c1, v1
                c1, v1 = i, f
            elif v2 is None or f <= v2:
                c2, v2 = i, f
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for s in codesize:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):  # K.2 figure K.3: shorten to 16 bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code goes
    values = [s for size in range(1, 33) for s in range(256)
              if codesize[s] == size]
    return bits[1:17], values


# --------------------------------------------------------------------------
# entropy coding
# --------------------------------------------------------------------------

def _bit_length(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0), v int64 below 2^15."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    for b in range(16):
        n += (a >> b) > 0
    return n


def _scan_blocks(frame: Frame, coefs: List[np.ndarray]):
    """Every block in interleaved scan order: ([N, 64] zigzag int64,
    component index [N])."""
    mx, my = frame.mcus()
    parts, comp = [], []
    for ci, ((_id, h, v, _t), c) in enumerate(zip(frame.components, coefs)):
        # [my, v, mx, h, 64] -> MCU-major, then the component's v x h blocks
        b = c.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
        parts.append(b.reshape(my * mx, v * h, 64))
        comp.append(np.full((my * mx, v * h), ci))
    blocks = np.concatenate(parts, 1).reshape(-1, 64)
    comp = np.concatenate(comp, 1).reshape(-1)
    return blocks[:, ZIGZAG].astype(np.int64), comp


def _symbols(frame: Frame, coefs: List[np.ndarray]):
    """The scan's symbols in order: (block, is_ac, symbol, extra bits,
    extra length, component) arrays."""
    zz, comp = _scan_blocks(frame, coefs)
    n = len(zz)
    # DC differences within each component
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for ci in range(len(frame.components)):
        idx = np.nonzero(comp == ci)[0]
        d = dc[idx]
        diff[idx] = d - np.concatenate([[0], d[:-1]])
    dsz = _bit_length(diff)
    dextra = np.where(diff < 0, diff + (1 << dsz) - 1, diff)
    # AC: runs of zeros before each non-zero
    ac = zz[:, 1:]
    blk, pos = np.nonzero(ac)
    pos = pos + 1
    val = ac[blk, pos - 1]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    asz = _bit_length(val)
    aextra = np.where(val < 0, val + (1 << asz) - 1, val)
    nzrl = run >> 4
    # end of block where the last non-zero is before position 63
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.nonzero(last < 63)[0]
    zrl_blk = np.repeat(blk, nzrl)
    zrl_pos = np.repeat(pos, nzrl)
    # keys order a block's items: DC, then per position ZRLs before the
    # value, then EOB
    key = np.concatenate([
        np.arange(n) * 256,
        blk * 256 + 2 * pos + 1,
        zrl_blk * 256 + 2 * zrl_pos,
        eob * 256 + 255])
    sym = np.concatenate([dsz, ((run & 15) << 4) | asz,
                          np.full(len(zrl_blk), 0xF0), np.zeros(len(eob),
                                                                np.int64)])
    extra = np.concatenate([dextra, aextra, np.zeros(len(zrl_blk) + len(eob),
                                                     np.int64)])
    elen = np.concatenate([dsz, asz, np.zeros(len(zrl_blk) + len(eob),
                                              np.int64)])
    is_ac = np.concatenate([np.zeros(n, bool), np.ones(len(blk) + len(zrl_blk)
                                                       + len(eob), bool)])
    owner = np.concatenate([np.arange(n), blk, zrl_blk, eob])
    order = np.argsort(key, kind="stable")
    return (is_ac[order], sym[order], extra[order], elen[order],
            comp[owner[order]])


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate codes MSB first, pad with 1-bits, stuff 0x00 after every
    0xFF."""
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    item = np.repeat(np.arange(len(values)), lengths)
    shift = (start + lengths)[item] - 1 - np.arange(total)
    bits = ((values[item] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    if len(ff):
        out = np.insert(out, ff + 1, 0)
    return out.tobytes()


def entropy_encode(frame: Frame, coefs: List[np.ndarray],
                   optimized: bool) -> bytes:
    """The scan's entropy-coded segment; sets frame.huffman and
    frame.scan (DC and AC table ids 0 for luma, 1 for chroma)."""
    is_ac, sym, extra, elen, comp = _symbols(frame, coefs)
    tid = np.minimum(comp, 1)  # table 0 for Y, 1 for Cb and Cr
    frame.scan = [(ci, min(ci, 1), min(ci, 1))
                  for ci in range(len(frame.components))]
    std = {(0, 0): STD_DC_LUMA, (0, 1): STD_DC_CHROMA,
           (1, 0): STD_AC_LUMA, (1, 1): STD_AC_CHROMA}
    codes = np.zeros(len(sym), np.int64)
    lens = np.zeros(len(sym), np.int64)
    frame.huffman = {}
    for cls in (0, 1):
        for t in sorted(set(tid.tolist())):
            sel = (is_ac == bool(cls)) & (tid == t)
            if optimized:
                spec = optimal_table(np.bincount(sym[sel], minlength=256))
            else:
                spec = std[(cls, t)]
            frame.huffman[(cls, t)] = spec
            code_of, len_of = code_table(spec)
            codes[sel] = code_of[sym[sel]]
            lens[sel] = len_of[sym[sel]]
    if (lens == 0).any():
        raise ValueError("a symbol has no code in its table")
    return _pack((codes << elen) | extra, lens + elen)


def write(frame: Frame, data: bytes) -> bytes:
    """SOI, APP0 (JFIF), DQT, SOF0, DHT, SOS, the data, EOI."""
    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8",
           seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in sorted(frame.quant.items()):
        out.append(seg(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, frame.height, frame.width,
                      len(frame.components))
    for cid, h, v, tq in frame.components:
        sof += bytes([cid, (h << 4) | v, tq])
    out.append(seg(0xC0, sof))
    for (cls, t), (counts, values) in sorted(frame.huffman.items()):
        out.append(seg(0xC4, bytes([(cls << 4) | t]) + bytes(counts)
                       + bytes(values)))
    sos = bytes([len(frame.scan)])
    for ci, td, ta in frame.scan:
        sos += bytes([frame.components[ci][0], (td << 4) | ta])
    out.append(seg(0xDA, sos + b"\x00\x3f\x00"))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def encode(img: np.ndarray, quality: int, subsampling: str = "420",
           optimized: bool = False, precision: str = "float64"
           ) -> Tuple[bytes, Frame, List[np.ndarray]]:
    """uint8 image -> (stream, its frame, its quantised coefficients)."""
    frame = layout(img.shape[0], img.shape[1], subsampling, quality)
    coefs = encode_coefficients(img, frame, precision)
    data = entropy_encode(frame, coefs, optimized)
    return write(frame, data), frame, coefs


# --------------------------------------------------------------------------
# parsing and entropy decoding
# --------------------------------------------------------------------------

def parse(data: bytes) -> Frame:
    """The headers of a baseline stream and its entropy-coded segment."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    i = 2
    frame: Optional[Frame] = None
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
    restart = 0
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"no marker at {i}")
        marker = data[i + 1]
        if marker == 0xFF:
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[i + 2:i + 4])
        body = data[i + 4:i + 2 + length]
        if marker == 0xDB:
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(body[k + 1:k + 1 + n],
                                    ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                quant[tq] = q
                k += 1 + n
        elif marker == 0xC4:
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                counts = list(body[k + 1:k + 17])
                n = sum(counts)
                huff[(tc, th)] = (counts, list(body[k + 17:k + 17 + n]))
                k += 17 + n
        elif marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise ValueError("only 8-bit samples")
            h, w, nc = struct.unpack(">HHB", body[1:6])
            comps = [(body[6 + 3 * c], body[7 + 3 * c] >> 4,
                      body[7 + 3 * c] & 15, body[8 + 3 * c])
                     for c in range(nc)]
            frame = Frame(h, w, comps, marker=marker)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"unsupported frame type 0x{marker:02X}")
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = body[0]
            ids = [c[0] for c in frame.components]
            frame.scan = [(ids.index(body[1 + 2 * k]),
                           body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15)
                          for k in range(ns)]
            if ns != len(frame.components):
                raise ValueError("only one interleaved scan")
            start = i + 2 + length
            end = start
            while True:  # the segment ends at a marker other than RSTn
                end = data.index(b"\xff", end)
                if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                    end += 2
                    continue
                break
            frame.data = data[start:end]
            frame.quant = quant
            frame.huffman = huff
            frame.restart_interval = restart
            return frame
        i += 2 + length
    raise ValueError("no scan")


def _lookup(spec) -> Tuple[List[int], List[int]]:
    """Flat 16-bit lookahead: for every 16-bit window, (length, symbol) of
    the code that starts it; length 0 where no code does."""
    code_of, len_of = code_table(spec)
    lens = np.zeros(1 << 16, np.int64)
    syms = np.zeros(1 << 16, np.int64)
    for s in spec[1]:
        n = int(len_of[s])
        lo = int(code_of[s]) << (16 - n)
        lens[lo:lo + (1 << (16 - n))] = n
        syms[lo:lo + (1 << (16 - n))] = s
    return lens.tolist(), syms.tolist()


def entropy_decode(frame: Frame) -> List[np.ndarray]:
    """The entropy-coded segment -> quantised coefficients [bh, bw, 64]
    natural order of each component."""
    if frame.restart_interval:
        raise ValueError("restart markers are not supported")
    raw = np.frombuffer(frame.data, np.uint8)
    stuffed = np.nonzero((raw[:-1] == 0xFF) & (raw[1:] == 0))[0] + 1
    raw = np.delete(raw, stuffed).astype(np.int64)
    raw = np.concatenate([raw, np.zeros(4, np.int64)])
    words = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8)
             | raw[3:]).tolist()
    nbits = 8 * (len(raw) - 4)
    mx, my = frame.mcus()
    tables = {key: _lookup(spec) for key, spec in frame.huffman.items()}
    comps = []
    for ci, td, ta in frame.scan:
        _id, h, v, _t = frame.components[ci]
        comps.append((ci, h, v, tables[(0, td)], tables[(1, ta)]))
    out = [np.zeros((my * v, mx * h, 64), np.int64)
           for (_i, h, v, _tq) in frame.components]
    flat = [o.reshape(-1, 64) for o in out]
    pred = [0] * len(frame.components)
    zz = ZIGZAG.tolist()
    pos = 0
    for mcu in range(mx * my):
        my_, mx_ = divmod(mcu, mx)
        for ci, h, v, (dlen, dsym), (alen, asym) in comps:
            bw = mx * h
            for by in range(v):
                for bx in range(h):
                    blk = [0] * 64
                    w = (words[pos >> 3] << (pos & 7)) & 0xFFFFFFFF
                    n = dlen[w >> 16]
                    if n == 0:
                        raise ValueError("bad DC code")
                    s = dsym[w >> 16]
                    pos += n
                    d = 0
                    if s:
                        w = (words[pos >> 3] << (pos & 7)) & 0xFFFFFFFF
                        d = w >> (32 - s)
                        if d < (1 << (s - 1)):
                            d -= (1 << s) - 1
                        pos += s
                    pred[ci] += d
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        w = (words[pos >> 3] << (pos & 7)) & 0xFFFFFFFF
                        n = alen[w >> 16]
                        if n == 0:
                            raise ValueError("bad AC code")
                        rs = asym[w >> 16]
                        pos += n
                        s = rs & 15
                        if s == 0:
                            if rs != 0xF0:
                                break
                            k += 16
                            continue
                        k += rs >> 4
                        w = (words[pos >> 3] << (pos & 7)) & 0xFFFFFFFF
                        a = w >> (32 - s)
                        if a < (1 << (s - 1)):
                            a -= (1 << s) - 1
                        pos += s
                        if k > 63:
                            raise ValueError("coefficient past 63")
                        blk[zz[k]] = a
                        k += 1
                    flat[ci][(my_ * v + by) * bw + mx_ * h + bx] = blk
    if pos > nbits:
        raise ValueError("the scan ran past its data")
    return out


# --------------------------------------------------------------------------
# bounds: every value a float32 evaluation may give
# --------------------------------------------------------------------------
#
# The program computes its products in float32, in an order of its own. A
# dot product of n terms evaluated in float32 in any order, with its matrix
# rounded to float32, lies within (n + 2) u sum |m_i x_i| of the exact
# value (u = 2^-24); one more add or rounding step adds u |result|. So
# where the exact value lies that close to a rounding boundary, either
# neighbour is a right answer. The bounds below carry [lo, hi] of every
# sample or coefficient through the stages; every later stage is monotonic
# in each input, so its bounds come from the right ends of its inputs'.

U32 = 2.0 ** -24
DOT_SLACK = 70 * U32  # 64 terms, the matrix's rounding, the last add


def _round_bounds(v, slack):
    """[lo, hi] of round-half-to-even over [v - slack, v + slack]."""
    return np.rint(v - slack), np.rint(v + slack)


def decode_bounds(frame: Frame, coefs: List[np.ndarray]):
    """(lo, hi) uint8 images: every image a float32 decode of these
    coefficients may give, sample by sample."""
    los, his = [], []
    for (_id, _h, _v, tq), c in zip(frame.components, coefs):
        deq = c.astype(np.float64) * frame.quant[tq][None, None, :]
        v = deq @ IDCT_64.T + 128
        slack = DOT_SLACK * (np.abs(deq) @ np.abs(IDCT_64).T + 128)
        lo, hi = _round_bounds(v, slack)
        los.append(np.clip(lo, 0, 255))
        his.append(np.clip(hi, 0, 255))
    lo, hi = _planes(frame, los), _planes(frame, his)
    if len(lo) == 1:
        return lo[0].astype(np.uint8), hi[0].astype(np.uint8)
    (ylo, cblo, crlo), (yhi, cbhi, crhi) = lo, hi
    # R rises with Y and Cr, G with Y and falls with Cb and Cr, B rises
    # with Y and Cb
    return (_rgb(_r(ylo, cblo, crlo), _g(ylo, cbhi, crhi),
                 _b(ylo, cblo, crlo)),
            _rgb(_r(yhi, cbhi, crhi), _g(yhi, cblo, crlo),
                 _b(yhi, cbhi, crhi)))


def _round_away(c):
    return np.sign(c) * np.floor(np.abs(c) + 0.5)


def encode_bounds(lo: np.ndarray, hi: np.ndarray, frame: Frame):
    """[(lo, hi)] int64 [bh, bw, 64] of each component: every quantised
    coefficient a float32 encode of any image between lo and hi may give."""
    if len(frame.components) != 3 or lo.ndim != 3:
        raise ValueError("bounds of three-component encodes only")
    (rl, gl, bl), (rh, gh, bh_) = ([im[..., i].astype(np.int64)
                                    for i in range(3)] for im in (lo, hi))
    planes = [(_y(rl, gl, bl), _y(rh, gh, bh_)),
              (_cb(rh, gh, bl), _cb(rl, gl, bh_)),
              (_cr(rl, gh, bh_), _cr(rh, gl, bl))]
    hmax, vmax = frame.hmax, frame.vmax
    out = []
    for (_id, h, v, tq), (plo, phi), (nbh, nbw) in zip(
            frame.components, planes, frame.block_dims()):
        xs = []
        for p in (plo, phi):
            if (hmax // h, vmax // v) == (2, 2):
                p = downsample_h2v2(p)
            xs.append(to_blocks(pad_edge(p, nbh * 8, nbw * 8))
                      .astype(np.float64) - 128)
        m = FDCT_64 / frame.quant[tq][:, None]
        mid = (xs[0] + xs[1]) / 2 @ m.T
        rad = (xs[1] - xs[0]) / 2 @ np.abs(m).T
        mag = np.maximum(np.abs(xs[0]), np.abs(xs[1])) @ np.abs(m).T
        slack = DOT_SLACK * mag + U32 * (np.abs(mid) + rad + 1)
        out.append((_round_away(mid - rad - slack).astype(np.int64),
                    _round_away(mid + rad + slack).astype(np.int64)))
    return out
