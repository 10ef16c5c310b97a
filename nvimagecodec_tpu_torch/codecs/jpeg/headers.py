"""Full JPEG structural parse: all markers needed to drive entropy decode.

Counterpart of the header walks inside the reference's nvjpeg-based decoders
(the parser in src/parsers/jpeg.cpp only sniffs ImageInfo; the codec itself
needs DQT/DHT/SOF/SOS/DRI — nvjpeg does this internally, we do it here).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

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


def parse_jpeg_structure(data: bytes) -> JpegFrame:
    """Walk all markers, collecting tables and scan spans."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != SOI:
        raise ValueError("not a JPEG")
    pos = 2
    frame: Optional[JpegFrame] = None
    quant: Dict[int, np.ndarray] = {}
    dc_huff: Dict[int, HuffTable] = {}
    ac_huff: Dict[int, HuffTable] = {}
    restart_interval = 0
    adobe_transform = None

    while pos + 2 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == SOI or (0xD0 <= marker <= 0xD7):
            pos += 2
            continue
        if marker == EOI:
            break
        if pos + 4 > n:
            break
        (seglen,) = struct.unpack_from(">H", data, pos + 2)
        seg_start = pos + 4
        seg = data[seg_start : pos + 2 + seglen]

        if marker in SOF_SET:
            precision, h, w, ncomp = struct.unpack_from(">BHHB", seg, 0)
            comps = []
            for c in range(ncomp):
                cid = seg[6 + 3 * c]
                hv = seg[7 + 3 * c]
                tq = seg[8 + 3 * c]
                comps.append(Component(cid, hv >> 4, hv & 0xF, tq))
            frame = JpegFrame(marker, precision, h, w, comps)
        elif marker == DQT:
            p = 0
            while p < len(seg):
                pq_tq = seg[p]
                pq, tq = pq_tq >> 4, pq_tq & 0xF
                p += 1
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, p).astype(np.int32)
                    p += 128
                else:
                    vals = np.frombuffer(seg, np.uint8, 64, p).astype(np.int32)
                    p += 64
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG] = vals  # stored zigzag → natural order
                quant[tq] = nat
        elif marker == DHT:
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                tc, th = tc_th >> 4, tc_th & 0xF
                bits = list(seg[p + 1 : p + 17])
                nv = sum(bits)
                values = list(seg[p + 17 : p + 17 + nv])
                tbl = HuffTable(bits, values)
                if tc == 0:
                    dc_huff[th] = tbl
                else:
                    ac_huff[th] = tbl
                p += 17 + nv
        elif marker == DRI:
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == SOS:
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = seg[0]
            comp_indices = []
            dc_tables, ac_tables = [], []
            for j in range(ns):
                cs = seg[1 + 2 * j]
                td_ta = seg[2 + 2 * j]
                idx = next(
                    i for i, c in enumerate(frame.components) if c.comp_id == cs
                )
                comp_indices.append(idx)
                dc_tables.append(td_ta >> 4)
                ac_tables.append(td_ta & 0xF)
            ss = seg[1 + 2 * ns]
            se = seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            data_start = pos + 2 + seglen
            # entropy data runs to the next non-RST marker. One vectorized
            # pass: all 0xFF positions and their successors at once, not a
            # find per 0xFF in a Python loop
            arr = np.frombuffer(data, np.uint8)
            seg_ff = np.flatnonzero(arr[data_start : n - 1] == 0xFF)
            if seg_ff.size:
                nxt = arr[data_start + seg_ff + 1]
                real = seg_ff[(nxt != 0x00) & (nxt != 0xFF)
                              & ((nxt < 0xD0) | (nxt > 0xD7))]
                data_end = data_start + int(real[0]) if real.size else n
            else:
                data_end = n
            frame.scans.append(
                ScanInfo(
                    comp_indices, ss, se, ahal >> 4, ahal & 0xF,
                    data_start, data_end, dc_tables, ac_tables,
                    dict(dc_huff), dict(ac_huff), restart_interval,
                )
            )
            pos = data_end
            continue
        pos += 2 + seglen

    if frame is None:
        raise ValueError("JPEG: no frame header")
    frame.quant = quant
    frame.dc_huff = dc_huff
    frame.ac_huff = ac_huff
    frame.restart_interval = restart_interval
    frame.adobe_transform = adobe_transform
    return frame
