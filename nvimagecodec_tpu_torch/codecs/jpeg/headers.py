"""Full JPEG structural parse: all markers needed to drive entropy decode.

Counterpart of the header walks inside the reference's nvjpeg-based decoders
(the parser in src/parsers/jpeg.cpp only sniffs ImageInfo; the codec itself
needs DQT/DHT/SOF/SOS/DRI — nvjpeg does this internally, we do it here).

The marker walk is native (native/jpeg_headers.cpp, `tic_jpeg_parse_batch`):
one call a batch, which finds every segment and every scan's end without the
interpreter lock and writes a record a stream. The frames are built here
from the records, reading only the bytes of the table segments.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.trace import add_count
from ...native import lib as native_lib
from .tables import ZIGZAG

# marker bytes
SOI, EOI, SOS, DQT, DHT, DRI, DNL = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xDC
SOF_SET = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


@dataclass
class Component:
    comp_id: int
    h: int  # horizontal sampling factor
    v: int
    tq: int  # quant table id
    # filled per scan:
    dc_tbl: int = 0
    ac_tbl: int = 0


@dataclass
class ScanInfo:
    comp_indices: List[int]  # indices into frame.components
    ss: int  # spectral start
    se: int  # spectral end
    ah: int  # successive approx high
    al: int  # successive approx low
    data_start: int  # offset of entropy-coded bytes
    data_end: int  # end offset (next marker)
    dc_tables: List[int] = field(default_factory=list)
    ac_tables: List[int] = field(default_factory=list)
    # Table state snapshot at this scan's position (tables may be redefined
    # between scans in progressive streams).
    dc_huff: Dict[int, "HuffTable"] = field(default_factory=dict)
    ac_huff: Dict[int, "HuffTable"] = field(default_factory=dict)
    restart_interval: int = 0


@dataclass
class HuffTable:
    """Canonical Huffman table: bits[1..16] counts + symbol values."""

    bits: List[int]
    values: List[int]

    def build_lut(self) -> Tuple[np.ndarray, np.ndarray]:
        """Build (code, length) per symbol for encode, and a flat decode LUT:
        16-bit-index table mapping the next 16 bits to (symbol, length)."""
        codes = []
        code = 0
        for length in range(1, 17):
            for _ in range(self.bits[length - 1]):
                codes.append((code, length))
                code += 1
            code <<= 1
        sym_lut = np.zeros(1 << 16, dtype=np.int16)
        len_lut = np.zeros(1 << 16, dtype=np.int8)
        for (c, length), v in zip(codes, self.values):
            base = c << (16 - length)
            span = 1 << (16 - length)
            sym_lut[base : base + span] = v
            len_lut[base : base + span] = length
        return sym_lut, len_lut


@dataclass
class JpegFrame:
    marker: int  # SOF marker id
    precision: int
    height: int
    width: int
    components: List[Component]
    quant: Dict[int, np.ndarray] = field(default_factory=dict)  # natural order
    dc_huff: Dict[int, HuffTable] = field(default_factory=dict)
    ac_huff: Dict[int, HuffTable] = field(default_factory=dict)
    restart_interval: int = 0
    scans: List[ScanInfo] = field(default_factory=list)
    adobe_transform: Optional[int] = None

    @property
    def is_progressive(self) -> bool:
        return self.marker in (0xC2, 0xC6, 0xCA, 0xCE)

    @property
    def is_lossless(self) -> bool:
        return self.marker in (0xC3, 0xC7, 0xCB, 0xCF)

    @property
    def is_baseline_or_extended(self) -> bool:
        return self.marker in (0xC0, 0xC1, 0xC9)

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    def mcu_geometry(self):
        """MCUs across/down and per-component block dims.

        Returns (mcus_x, mcus_y, [(blocks_w, blocks_h, comp)] aligned to MCU
        coverage — blocks_w/h include MCU padding like libjpeg's
        width_in_blocks only for interleaved coverage."""
        hmax, vmax = self.hmax, self.vmax
        mcus_x = (self.width + 8 * hmax - 1) // (8 * hmax)
        mcus_y = (self.height + 8 * vmax - 1) // (8 * vmax)
        dims = []
        for c in self.components:
            dims.append((mcus_x * c.h, mcus_y * c.v))
        return mcus_x, mcus_y, dims

    def comp_true_blocks(self, c: Component) -> Tuple[int, int]:
        """Blocks needed to cover the actual sample area of one component
        (libjpeg width_in_blocks semantics)."""
        hmax, vmax = self.hmax, self.vmax
        w = (self.width * c.h + hmax - 1) // hmax
        h = (self.height * c.v + vmax - 1) // vmax
        return (w + 7) // 8, (h + 7) // 8


# the native walk's record items (native/jpeg_headers.cpp)
_SOF, _DQT, _DHT, _DRI, _ADOBE, _SOS = 1, 2, 3, 4, 5, 6
_CAPACITY = -2
# words a stream's record gets at first; a longer one is walked again
_RECORD_WORDS = 256
_ERRORS = {
    1: "not a JPEG",
    2: "SOS before SOF",
    3: "JPEG: no frame header",
    4: "JPEG: SOF segment shorter than its components",
    5: "JPEG: DQT table runs past its segment",
    6: "JPEG: DRI segment shorter than 2 bytes",
    7: "JPEG: SOS segment shorter than its fields",
    8: "JPEG: SOS names a component the frame lacks",
}

# parsed table segments by their bytes, DQT and DHT apart: a batch's
# streams mostly share them. A lookup and a store are single dictionary
# operations; threads that race at worst parse a segment twice.
_QUANT_CACHE: Dict[bytes, list] = {}
_HUFF_CACHE: Dict[bytes, list] = {}
_CACHE_MAX = 1024


def _quant_tables(seg: bytes) -> List[Tuple[int, np.ndarray]]:
    """[(tq, natural-order int32 table)] of a DQT segment whose tables the
    walk found whole. Shared: the caller copies."""
    out = _QUANT_CACHE.get(seg)
    if out is None:
        out = []
        p = 0
        while p < len(seg):
            pq, tq = seg[p] >> 4, seg[p] & 0xF
            p += 1
            if pq:
                vals = np.frombuffer(seg, ">u2", 64, p).astype(np.int32)
                p += 128
            else:
                vals = np.frombuffer(seg, np.uint8, 64, p).astype(np.int32)
                p += 64
            nat = np.zeros(64, np.int32)
            nat[ZIGZAG] = vals  # stored zigzag → natural order
            out.append((tq, nat))
        _remember(_QUANT_CACHE, seg, out)
    return out


def _huff_tables(seg: bytes) -> List[Tuple[int, int, List[int], List[int]]]:
    """[(tc, th, bits, values)] of a DHT segment; a table cut off by the
    segment's end keeps what it has. Shared: the caller copies."""
    out = _HUFF_CACHE.get(seg)
    if out is None:
        out = []
        p = 0
        while p < len(seg):
            bits = list(seg[p + 1:p + 17])
            nv = sum(bits)
            out.append((seg[p] >> 4, seg[p] & 0xF, bits,
                        list(seg[p + 17:p + 17 + nv])))
            p += 17 + nv
        _remember(_HUFF_CACHE, seg, out)
    return out


def _remember(cache: dict, seg: bytes, tables: list) -> None:
    if len(cache) >= _CACHE_MAX:
        cache.clear()
    cache[seg] = tables


def _frame(data: bytes, r: List[int]) -> JpegFrame:
    """The frame of one stream from its record `r`, items in stream order:
    a table or DRI item changes the state that later scans snapshot, and
    an SOF item starts the frame afresh."""
    frame = None
    quant: Dict[int, np.ndarray] = {}
    dc_huff: Dict[int, HuffTable] = {}
    ac_huff: Dict[int, HuffTable] = {}
    restart_interval = 0
    adobe_transform = None
    k, end = 0, len(r)
    while k < end:
        kind = r[k]
        if kind == _SOS:
            ns = r[k + 1]
            t = k + 2 + 3 * ns
            ss, se, ah, al, data_start, data_end = r[t:t + 6]
            frame.scans.append(ScanInfo(
                r[k + 2:t:3], ss, se, ah, al, data_start, data_end,
                r[k + 3:t:3], r[k + 4:t:3], dict(dc_huff), dict(ac_huff),
                restart_interval))
            k = t + 6
        elif kind == _DHT:
            for tc, th, bits, values in _huff_tables(data[r[k + 1]:r[k + 2]]):
                (ac_huff if tc else dc_huff)[th] = HuffTable(list(bits),
                                                             list(values))
            k += 3
        elif kind == _DQT:
            for tq, nat in _quant_tables(data[r[k + 1]:r[k + 2]]):
                quant[tq] = nat.copy()
            k += 3
        elif kind == _SOF:
            marker, precision, h, w, nc = r[k + 1:k + 6]
            k += 6
            frame = JpegFrame(marker, precision, h, w,
                              [Component(*r[j:j + 4])
                               for j in range(k, k + 4 * nc, 4)])
            k += 4 * nc
        elif kind == _DRI:
            restart_interval = r[k + 1]
            k += 2
        else:  # _ADOBE
            adobe_transform = r[k + 1]
            k += 2
    frame.quant = quant
    frame.dc_huff = dc_huff
    frame.ac_huff = ac_huff
    frame.restart_interval = restart_interval
    frame.adobe_transform = adobe_transform
    return frame


def _walk(datas: List[bytes], words: int):
    """One native call over `datas`, `words` record words a stream:
    (records [n, words], status [n], used [n]), int64 views of one buffer
    (one address for ctypes to take: each costs microseconds)."""
    n = len(datas)
    buf = np.empty(n * (words + 4) + 1, np.int64)
    k = n * words
    buf[k:k + n + 1] = np.arange(0, (n + 1) * words, words)
    buf[k + n + 1:k + 2 * n + 1] = [len(d) for d in datas]
    at = buf.ctypes.data
    native_lib().tic_jpeg_parse_batch(
        n, (ctypes.c_char_p * n)(*datas), at + 8 * (k + n + 1), at,
        at + 8 * k, at + 8 * (k + 2 * n + 1), at + 8 * (k + 3 * n + 1))
    return (buf[:k].reshape(n, words), buf[k + 2 * n + 1:k + 3 * n + 1],
            buf[k + 3 * n + 1:])


def parse_jpeg_batch(datas: Sequence) -> List[Tuple[Optional[JpegFrame],
                                                    Optional[str]]]:
    """Walk the markers of every stream of `datas` (bytes-like) in one
    native call, which holds no interpreter lock, and build each frame.
    Returns one (frame, None) or (None, error text) a stream: a malformed
    stream fails alone."""
    out: List[Tuple[Optional[JpegFrame], Optional[str]]] = [None] * len(datas)
    raws, where = [], []
    for i, d in enumerate(datas):
        try:
            raws.append(d if type(d) is bytes else bytes(d))
            where.append(i)
        except Exception as e:  # not bytes-like
            out[i] = (None, str(e))
    n = len(raws)
    if n:
        rec, status, used = _walk(raws, _RECORD_WORDS)
        add_count("imgcodec.jpeg.parse_native_streams", n)
        rows = {}
        long = np.flatnonzero(status == _CAPACITY)
        if long.size:  # walked again, each with the words it needs
            rec2, status[long], _ = _walk([raws[j] for j in long],
                                          int(used[long].max()))
            rows = dict(zip(long.tolist(), rec2))
        status, used = status.tolist(), used.tolist()
        for j, i in enumerate(where):
            if status[j]:
                out[i] = (None, _ERRORS[status[j]])
                continue
            row = rows[j] if j in rows else rec[j]
            try:
                out[i] = (_frame(raws[j], row[:used[j]].tolist()), None)
            except Exception as e:  # whatever the walk let through fails alone
                out[i] = (None, str(e))
    return out


def parse_jpeg_structure(data: bytes) -> JpegFrame:
    """Walk all markers, collecting tables and scan spans: the batch of
    one (`parse_jpeg_batch`). Raises ValueError for a malformed stream."""
    frame, err = parse_jpeg_batch([data])[0]
    if err is not None:
        raise ValueError(err)
    return frame
