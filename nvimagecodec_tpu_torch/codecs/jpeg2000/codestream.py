"""JPEG2000 codestream structure: marker segments, band geometry, bit IO.

Counterpart of the codestream handling nvjpeg2k does internally in the
reference (extensions/nvjpeg2k/cuda_decoder.cpp; header sniffing in
src/parsers/jpeg2k.cpp:216-356). Written from ITU-T T.800 Annexes A/B.

Scope (documented restrictions):
- default code-block style (no bypass/reset/termall/causal/segsym).
Arbitrary (incl. odd) image/tile reference-grid origins and odd tile
sizes are supported both directions — the DWT takes per-level parity
from the absolute tile-component origin (ops/dwt.py, T.800 F.3.4).
Precinct partitions, multiple quality layers, and all five progression
orders (honest precinct-position iteration, T.800 B.12) are supported on
both encode and decode.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# marker codes
SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, RGN, POC, COM = (
    0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF64,
)
CAP = 0xFF50  # extended capabilities (T.814 A.3: Pcap bit 15 → HTJ2K)

# SPcod code-block style bit: HT block coder (T.814)
CBLK_HT = 0x40

JP2_SIG = bytes.fromhex("0000000C6A5020200D0A870A")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- bit IO
class HeaderBitWriter:
    """Packet-header bit writer with JPEG2000 stuffing: after an 0xFF byte
    only 7 bits go in the next byte (T.800 B.10.1)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
        self.limit = 8

    def put_bit(self, b: int) -> None:
        self.acc = (self.acc << 1) | (b & 1)
        self.n += 1
        if self.n == self.limit:
            self.out.append(self.acc if self.limit == 8 else self.acc)
            nxt = 7 if self.out[-1] == 0xFF else 8
            self.acc = 0
            self.n = 0
            self.limit = nxt

    def put_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bit((v >> i) & 1)

    def flush(self) -> bytes:
        while self.n:
            self.put_bit(0)
        # if the final byte is 0xFF the spec requires a stuffed byte so the
        # following body data cannot form a marker
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class HeaderBitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.n = 0
        self.prev_ff = False

    def get_bit(self) -> int:
        if self.n == 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            if self.prev_ff:
                self.n = 7
                self.prev_ff = False  # stuffed byte's MSB is 0 by construction
            else:
                self.n = 8
            self.prev_ff = b == 0xFF
            self.acc = b
        self.n -= 1
        return (self.acc >> self.n) & 1

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def align(self) -> None:
        """Byte-align after a packet header (consume the stuffed 0 if the
        last byte was 0xFF)."""
        self.n = 0
        if self.prev_ff:
            self.pos += 1
            self.prev_ff = False


# ---------------------------------------------------------------- geometry
@dataclass
class Band:
    """One subband of one resolution of one tile-component."""

    btype: int  # 0 LL, 1 HL, 2 LH, 3 HH
    lev: int    # decomposition level (1..NL; LL uses NL)
    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @property
    def gain(self) -> int:
        return (0, 1, 1, 2)[self.btype]


@dataclass
class Resolution:
    r: int
    x0: int
    y0: int
    x1: int
    y1: int
    bands: List[Band] = field(default_factory=list)


@dataclass
class CodingParams:
    levels: int = 5
    reversible: bool = True
    mct: bool = True
    cblk_w: int = 64  # exponent form on the wire
    cblk_h: int = 64
    prog_order: int = 0  # 0 LRCP, 1 RLCP, 2 RPCL, 3 PCRL, 4 CPRL
    num_layers: int = 1
    cblk_style: int = 0
    # precinct partition exponents per resolution [(PPx, PPy)] (T.800 A-21);
    # None = maximal precincts (the implied 15/15 default)
    precincts: Optional[List[Tuple[int, int]]] = None
    # quantization (per band, natural packet order): (exponent, mantissa)
    qcd_style: int = 0
    guard_bits: int = 2
    band_q: List[Tuple[int, int]] = field(default_factory=list)
    # per-component overrides from COC/QCC markers (T.800 A.6.2/A.6.5):
    # comp index -> CodingParams with that component's levels/cblk/precincts
    # (COC) and/or qcd_style/guard_bits/band_q (QCC)
    comp_overrides: Dict[int, "CodingParams"] = field(default_factory=dict)
    # progression-order changes (POC marker, T.800 A.6.6): list of
    # (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc); None = COD order only
    poc: Optional[List[Tuple[int, int, int, int, int, int]]] = None
    # Scod bits 1/2: SOP markers between packets / EPH after headers
    sop: bool = False
    eph: bool = False
    # RGN maxshift (T.800 A.6.4/H): component -> SPrgn shift
    rgn: Optional[Dict[int, int]] = None
    # PPM (T.800 A.7.4): Zppm-ordered packed-header record stream, one
    # [Nppm(4)][headers] record per tile-part in stream order
    ppm: Optional[bytes] = None

    def pp(self, r: int) -> Tuple[int, int]:
        """Precinct exponents at resolution r (15/15 when no partition)."""
        if not self.precincts:
            return (15, 15)
        return self.precincts[min(r, len(self.precincts) - 1)]

    def for_comp(self, c: int) -> "CodingParams":
        """Effective coding parameters of component c (COC/QCC merged)."""
        return self.comp_overrides.get(c, self)


@dataclass
class SizInfo:
    width: int = 0
    height: int = 0
    x0: int = 0
    y0: int = 0
    tile_w: int = 0
    tile_h: int = 0
    tx0: int = 0
    ty0: int = 0
    ncomp: int = 0
    depth: List[int] = field(default_factory=list)   # bit depth per comp
    signed: List[bool] = field(default_factory=list)
    sub_x: List[int] = field(default_factory=list)
    sub_y: List[int] = field(default_factory=list)

    @property
    def tiles_x(self) -> int:
        return ceil_div(self.width - self.tx0, self.tile_w)

    @property
    def tiles_y(self) -> int:
        return ceil_div(self.height - self.ty0, self.tile_h)

    def tile_rect(self, t: int) -> Tuple[int, int, int, int]:
        """(x0, y0, x1, y1) of tile t in reference-grid coordinates."""
        ti = t % self.tiles_x
        tj = t // self.tiles_x
        x0 = max(self.x0, self.tx0 + ti * self.tile_w)
        y0 = max(self.y0, self.ty0 + tj * self.tile_h)
        x1 = min(self.width, self.tx0 + (ti + 1) * self.tile_w)
        y1 = min(self.height, self.ty0 + (tj + 1) * self.tile_h)
        return x0, y0, x1, y1


def band_rect(tcx0, tcy0, tcx1, tcy1, lev: int, btype: int):
    """Subband coordinates (T.800 B.5 eq. B-15)."""
    xob = (0, 1, 0, 1)[btype]
    yob = (0, 0, 1, 1)[btype]
    if lev == 0:  # no decomposition: LL is the whole tile-component
        return tcx0, tcy0, tcx1, tcy1
    d = 1 << lev
    h = 1 << (lev - 1)
    bx0 = ceil_div(tcx0 - h * xob, d)
    by0 = ceil_div(tcy0 - h * yob, d)
    bx1 = ceil_div(tcx1 - h * xob, d)
    by1 = ceil_div(tcy1 - h * yob, d)
    return bx0, by0, bx1, by1


def build_resolutions(tcx0, tcy0, tcx1, tcy1, levels: int) -> List[Resolution]:
    """All resolutions of a tile-component, r = 0 (LL only) … levels."""
    out = []
    for r in range(levels + 1):
        d = 1 << (levels - r)
        rx0, ry0 = ceil_div(tcx0, d), ceil_div(tcy0, d)
        rx1, ry1 = ceil_div(tcx1, d), ceil_div(tcy1, d)
        res = Resolution(r, rx0, ry0, rx1, ry1)
        if r == 0:
            x0, y0, x1, y1 = band_rect(tcx0, tcy0, tcx1, tcy1, levels, 0)
            res.bands.append(Band(0, levels, x0, y0, x1, y1))
        else:
            lev = levels - r + 1
            for btype in (1, 2, 3):
                x0, y0, x1, y1 = band_rect(tcx0, tcy0, tcx1, tcy1, lev, btype)
                res.bands.append(Band(btype, lev, x0, y0, x1, y1))
        out.append(res)
    return out


def cblk_grid(band: Band, cw: int, ch: int) -> Tuple[int, int, List[Tuple[int, int, int, int]]]:
    """Code-block partition of a band: blocks anchored on the cblk grid.
    Returns (nx, ny, [(x0, y0, x1, y1)] raster order)."""
    if band.w == 0 or band.h == 0:
        return 0, 0, []
    gx0 = (band.x0 // cw) * cw
    gy0 = (band.y0 // ch) * ch
    nx = ceil_div(band.x1 - gx0, cw)
    ny = ceil_div(band.y1 - gy0, ch)
    blocks = []
    for j in range(ny):
        for i in range(nx):
            x0 = max(band.x0, gx0 + i * cw)
            y0 = max(band.y0, gy0 + j * ch)
            x1 = min(band.x1, gx0 + (i + 1) * cw)
            y1 = min(band.y1, gy0 + (j + 1) * ch)
            blocks.append((x0, y0, x1, y1))
    return nx, ny, blocks


# ------------------------------------------------------------- precincts
def precinct_count(res: Resolution, ppx: int, ppy: int) -> Tuple[int, int]:
    """Precinct grid dims of a resolution (grid anchored at 0 with size
    2^PPx × 2^PPy, T.800 B.6)."""
    if res.x1 <= res.x0 or res.y1 <= res.y0:
        return 0, 0
    npx = ceil_div(res.x1, 1 << ppx) - (res.x0 >> ppx)
    npy = ceil_div(res.y1, 1 << ppy) - (res.y0 >> ppy)
    return npx, npy


def precinct_rect(res: Resolution, ppx: int, ppy: int, p: int):
    """Rect of precinct p (raster index) in resolution coords, clipped to the
    resolution; also returns the unclipped grid origin (progression anchors)."""
    npx, _ = precinct_count(res, ppx, ppy)
    i, j = p % npx, p // npx
    gx = ((res.x0 >> ppx) + i) << ppx
    gy = ((res.y0 >> ppy) + j) << ppy
    x0, y0 = max(res.x0, gx), max(res.y0, gy)
    x1 = min(res.x1, gx + (1 << ppx))
    y1 = min(res.y1, gy + (1 << ppy))
    return (x0, y0, x1, y1), (gx, gy)


def cblk_grid_precinct(
    band: Band, r: int, ppx: int, ppy: int, prect, cw: int, ch: int
) -> Tuple[int, int, List[Tuple[int, int, int, int]]]:
    """Code-blocks of one band inside one precinct: the precinct rect maps
    into band coords (halved for r>0), the code-block grid is anchored at 0
    with the effective size min(cblk, precinct-in-band) (T.800 B.7).
    Returns (nx, ny, [(x0,y0,x1,y1)] raster order)."""
    s = 0 if r == 0 else 1
    ecw = min(cw, 1 << max(0, ppx - s))
    ech = min(ch, 1 << max(0, ppy - s))
    px0, py0, px1, py1 = prect
    bx0 = max(band.x0, px0 >> s)
    by0 = max(band.y0, py0 >> s)
    bx1 = min(band.x1, ceil_div(px1, 1 << s))
    by1 = min(band.y1, ceil_div(py1, 1 << s))
    if bx1 <= bx0 or by1 <= by0:
        return 0, 0, []
    gx0 = (bx0 // ecw) * ecw
    gy0 = (by0 // ech) * ech
    nx = ceil_div(bx1 - gx0, ecw)
    ny = ceil_div(by1 - gy0, ech)
    blocks = []
    for j in range(ny):
        for i in range(nx):
            x0 = max(bx0, gx0 + i * ecw)
            y0 = max(by0, gy0 + j * ech)
            x1 = min(bx1, gx0 + (i + 1) * ecw)
            y1 = min(by1, gy0 + (j + 1) * ech)
            blocks.append((x0, y0, x1, y1))
    return nx, ny, blocks


def progression_iter(cp: CodingParams, resolutions, ncomp: int,
                     tcx0: int, tcy0: int, sub=None):
    """Yield (layer, r, c, p) in the tile's progression order for all five
    T.800 B.12 orders, precinct-aware. Position-based orders (RPCL/PCRL/CPRL)
    order precincts by their projected reference-grid anchor — the top-left
    sample position of the precinct within the tile (T.800 B.12.1.3-5);
    for subsampled components the projection multiplies by XRsiz/YRsiz
    (`sub`: [(dx, dy)] per component). `resolutions`: comp -> [Resolution]."""
    if cp.poc:
        yield from progression_iter_poc(cp, resolutions, ncomp, tcx0, tcy0,
                                        sub=sub)
        return
    L = cp.num_layers
    entries = []  # (c, r, p, anchor_y, anchor_x)
    for c in range(ncomp):
        cc = cp.for_comp(c)
        dx, dy = sub[c] if sub else (1, 1)
        for res in resolutions[c]:
            r = res.r
            ppx, ppy = cc.pp(r)
            npx, npy = precinct_count(res, ppx, ppy)
            scale = cc.levels - r
            for p in range(npx * npy):
                _, (gx, gy) = precinct_rect(res, ppx, ppy, p)
                ax = max(tcx0, (gx << scale) * dx)
                ay = max(tcy0, (gy << scale) * dy)
                entries.append((c, r, p, ay, ax))

    po = cp.prog_order
    if po == 0:  # LRCP
        for l in range(L):
            for c, r, p, _ay, _ax in sorted(
                entries, key=lambda e: (e[1], e[0], e[2])
            ):
                yield l, r, c, p
    elif po == 1:  # RLCP
        by_r: Dict[int, list] = {}
        for e in sorted(entries, key=lambda e: (e[1], e[0], e[2])):
            by_r.setdefault(e[1], []).append(e)
        for r in sorted(by_r):
            for l in range(L):
                for c, _r, p, _ay, _ax in by_r[r]:
                    yield l, _r, c, p
    elif po == 2:  # RPCL: resolution, position, component, layer
        for c, r, p, _ay, _ax in sorted(
            entries, key=lambda e: (e[1], e[3], e[4], e[0])
        ):
            for l in range(L):
                yield l, r, c, p
    elif po == 3:  # PCRL: position, component, resolution, layer
        for c, r, p, _ay, _ax in sorted(
            entries, key=lambda e: (e[3], e[4], e[0], e[1])
        ):
            for l in range(L):
                yield l, r, c, p
    else:  # CPRL: component, position, resolution, layer
        for c, r, p, _ay, _ax in sorted(
            entries, key=lambda e: (e[0], e[3], e[4], e[1])
        ):
            for l in range(L):
                yield l, r, c, p


def progression_iter_poc(cp: CodingParams, resolutions, ncomp: int,
                         tcx0: int, tcy0: int, sub=None):
    """Packet order under progression-order changes (T.800 B.11): each POC
    progression emits the packets inside its resolution/component/layer
    bounds in its own order, skipping packets already emitted by earlier
    progressions; any remainder follows the COD order."""
    import dataclasses

    seen = set()
    for (rs, cs, lye, re_, ce, ppoc) in cp.poc:
        sub_cp = dataclasses.replace(cp, prog_order=ppoc, poc=None)
        for l, r, c, p in progression_iter(sub_cp, resolutions, ncomp,
                                           tcx0, tcy0, sub=sub):
            if not (rs <= r < re_ and cs <= c < ce and l < lye):
                continue
            key = (l, r, c, p)
            if key in seen:
                continue
            seen.add(key)
            yield key
    # under-specified POC lists: remaining packets in COD order
    base_cp = dataclasses.replace(cp, poc=None)
    for key in progression_iter(base_cp, resolutions, ncomp, tcx0, tcy0,
                                sub=sub):
        if key not in seen:
            seen.add(key)
            yield key


# ---------------------------------------------------------------- markers
def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def write_siz(siz: SizInfo, rsiz: int = 0) -> bytes:
    p = struct.pack(
        ">HIIIIIIIIH", rsiz, siz.width, siz.height, siz.x0, siz.y0,
        siz.tile_w, siz.tile_h, siz.tx0, siz.ty0, siz.ncomp,
    )
    for c in range(siz.ncomp):
        ssiz = (siz.depth[c] - 1) | (0x80 if siz.signed[c] else 0)
        p += struct.pack(">BBB", ssiz, siz.sub_x[c], siz.sub_y[c])
    return _seg(SIZ, p)


def write_cap(mb: int) -> bytes:
    """CAP marker declaring Part-15 (HTJ2K): Pcap bit 15 set, Ccap15 with
    HTONLY sets and the magnitude-bound parameter (T.814 A.3)."""
    pcap = 1 << 17
    ccap15 = max(0, min(31, mb - 8))
    return _seg(CAP, struct.pack(">IH", pcap, ccap15))


def write_cod(cp: CodingParams) -> bytes:
    scod = 1 if cp.precincts else 0  # bit 0: precinct sizes defined
    sgcod = struct.pack(">BHB", cp.prog_order, cp.num_layers, 1 if cp.mct else 0)
    spcod = struct.pack(
        ">BBBBB",
        cp.levels,
        _cblk_exp(cp.cblk_w),
        _cblk_exp(cp.cblk_h),
        cp.cblk_style,
        1 if cp.reversible else 0,  # T.800 A.20: 1 = 5/3 reversible, 0 = 9/7
    )
    if cp.precincts:
        # one byte per resolution: PPx low nibble, PPy high (T.800 A-21)
        spcod += bytes(
            (cp.pp(r)[0] & 15) | ((cp.pp(r)[1] & 15) << 4)
            for r in range(cp.levels + 1)
        )
    return _seg(COD, bytes([scod]) + sgcod + spcod)


def _cblk_exp(size: int) -> int:
    e = size.bit_length() - 1
    return e - 2  # wire value: log2(size) - 2


def write_coc(c: int, o: CodingParams, ncomp: int) -> bytes:
    """Per-component coding style override (T.800 A.6.2)."""
    head = bytes([c]) if ncomp < 257 else struct.pack(">H", c)
    scoc = 1 if o.precincts else 0
    body = head + bytes([scoc]) + struct.pack(
        ">BBBBB", o.levels, _cblk_exp(o.cblk_w), _cblk_exp(o.cblk_h),
        o.cblk_style, 1 if o.reversible else 0)
    if o.precincts:
        body += bytes((o.pp(r)[0] & 15) | ((o.pp(r)[1] & 15) << 4)
                      for r in range(o.levels + 1))
    return _seg(COC, body)


def write_qcc(c: int, o: CodingParams, ncomp: int) -> bytes:
    """Per-component quantization override (T.800 A.6.5)."""
    head = bytes([c]) if ncomp < 257 else struct.pack(">H", c)
    sq = o.qcd_style | (o.guard_bits << 5)
    body = head + bytes([sq])
    if o.qcd_style == 0:
        for (eps, _mu) in o.band_q:
            body += bytes([eps << 3])
    else:
        for (eps, mu) in o.band_q:
            body += struct.pack(">H", (eps << 11) | mu)
    return _seg(QCC, body)


def write_qcd(cp: CodingParams) -> bytes:
    sqcd = cp.qcd_style | (cp.guard_bits << 5)
    p = bytes([sqcd])
    if cp.qcd_style == 0:  # no quantization: exponent only
        for (eps, _mu) in cp.band_q:
            p += bytes([eps << 3])
    else:  # scalar expounded: (eps, mantissa)
        for (eps, mu) in cp.band_q:
            p += struct.pack(">H", (eps << 11) | mu)
    return _seg(QCD, p)


def parse_main_header(data: bytes, pos: int):
    """Parse from SOC up to the first SOT. Returns (siz, cod, pos_of_SOT)."""
    if struct.unpack_from(">H", data, pos)[0] != SOC:
        raise ValueError("J2K: missing SOC")
    pos += 2
    siz: Optional[SizInfo] = None
    cp: Optional[CodingParams] = None
    coc_raw: List[bytes] = []
    qcc_raw: List[bytes] = []
    poc_raw: Optional[bytes] = None
    ppm_segs: List[Tuple[int, bytes]] = []
    while pos + 4 <= len(data):
        marker, ln = struct.unpack_from(">HH", data, pos)
        if marker == SOT:
            break
        body = data[pos + 4 : pos + 2 + ln]
        if marker == SIZ:
            (rsiz, w, h, x0, y0, tw, th, tx0, ty0, nc) = struct.unpack_from(
                ">HIIIIIIIIH", body, 0
            )
            siz = SizInfo(w, h, x0, y0, tw, th, tx0, ty0, nc)
            off = 36
            for c in range(nc):
                ssiz, sx, sy = struct.unpack_from(">BBB", body, off)
                off += 3
                siz.depth.append((ssiz & 0x7F) + 1)
                siz.signed.append(bool(ssiz & 0x80))
                siz.sub_x.append(sx)
                siz.sub_y.append(sy)
        elif marker == COD:
            scod = body[0]
            prog, nlayers, mct = struct.unpack_from(">BHB", body, 1)
            levels, cbw, cbh, style, transform = struct.unpack_from(
                ">BBBBB", body, 5
            )
            # supported: plain EBCOT, HT, and all part-1 mode switches —
            # BYPASS (0x01), RESET (0x02), TERMALL (0x04), CAUSAL (0x08),
            # ERTERM (0x10, encoder-side termination choice only: any
            # conforming MQ decoder reads such segments), SEGSYM (0x20).
            # 0xC0 (HT mixed with MQ blocks) routes to the
            # system-openjpeg fallback plugin.
            if style != CBLK_HT and (style & ~0x3F):
                raise ValueError("J2K: unsupported code-block style")
            # range checks: corrupted bytes here would otherwise drive
            # gigantic geometry loops (levels/cblk are exponents)
            if levels > 32:
                raise ValueError("J2K: decomposition levels > 32")
            if cbw > 8 or cbh > 8 or prog > 4:
                raise ValueError("J2K: invalid COD parameters")
            precincts = None
            if scod & 1:  # precinct partition sizes follow SPcod
                precincts = []
                for r in range(levels + 1):
                    if 10 + r >= len(body):
                        raise ValueError("J2K: truncated precinct sizes")
                    b = body[10 + r]
                    ppx, ppy = b & 15, b >> 4
                    if r > 0 and (ppx == 0 or ppy == 0):
                        raise ValueError("J2K: PPx/PPy=0 above resolution 0")
                    precincts.append((ppx, ppy))
            cp = CodingParams(
                sop=bool(scod & 2),
                eph=bool(scod & 4),
                levels=levels,
                reversible=(transform == 1),  # T.800 A.20
                mct=bool(mct),
                cblk_w=1 << (cbw + 2),
                cblk_h=1 << (cbh + 2),
                prog_order=prog,
                num_layers=nlayers,
                cblk_style=style,
                precincts=precincts,
            )
        elif marker == COC:
            coc_raw.append(body)
        elif marker == QCC:
            qcc_raw.append(body)
        elif marker == QCD:
            sqcd = body[0]
            style = sqcd & 0x1F
            guard = sqcd >> 5
            q = []
            if style == 0:
                for b in body[1:]:
                    q.append((b >> 3, 0))
            elif style == 2:
                for off in range(1, len(body), 2):
                    v = struct.unpack_from(">H", body, off)[0]
                    q.append((v >> 11, v & 0x7FF))
            elif style == 1:  # scalar derived: single (eps, mu), expand later
                v = struct.unpack_from(">H", body, 1)[0]
                q.append((v >> 11, v & 0x7FF))
            if cp is None:
                cp = CodingParams()
            cp.qcd_style = style
            cp.guard_bits = guard
            cp.band_q = q
        elif marker == POC:
            poc_raw = body  # decoded below once ncomp is known
        elif marker == RGN:
            # ROI maxshift (T.800 A.6.4): Crgn, Srgn(=0), SPrgn
            if len(body) == 3:
                crgn, srgn, sprgn = body[0], body[1], body[2]
            elif len(body) == 4:
                (crgn,) = struct.unpack_from(">H", body, 0)
                srgn, sprgn = body[2], body[3]
            else:
                raise ValueError("J2K: malformed RGN marker")
            if srgn != 0:
                raise ValueError("J2K: only maxshift RGN (Srgn=0) defined")
            if cp is None:
                cp = CodingParams()
            if cp.rgn is None:
                cp.rgn = {}
            cp.rgn[crgn] = sprgn
        elif marker == 0xFF60:  # PPM: Zppm + packed-header record stream
            ppm_segs.append((body[0], body[1:]))
        pos += 2 + ln
    if siz is None or cp is None:
        raise ValueError("J2K: missing SIZ/COD")
    if ppm_segs:
        cp.ppm = b"".join(b for _z, b in sorted(ppm_segs,
                                                key=lambda t: t[0]))
    if poc_raw is not None:
        cp.poc = parse_poc_body(poc_raw, siz.ncomp)

    # resolve per-component COC/QCC overrides (T.800 A.6.2 / A.6.5)
    import dataclasses as _dc

    def _comp_cp(c: int) -> CodingParams:
        if c not in cp.comp_overrides:
            cp.comp_overrides[c] = _dc.replace(
                cp, precincts=list(cp.precincts) if cp.precincts else None,
                band_q=list(cp.band_q), comp_overrides={})
        return cp.comp_overrides[c]

    cw = 1 if siz.ncomp < 257 else 2
    for body in coc_raw:
        c = body[0] if cw == 1 else struct.unpack_from(">H", body, 0)[0]
        scoc = body[cw]
        levels, cbw, cbh, style, transform = struct.unpack_from(
            ">BBBBB", body, cw + 1)
        if style != CBLK_HT and (style & ~0x3F):
            raise ValueError("J2K: unsupported code-block style (COC)")
        if levels > 32 or cbw > 8 or cbh > 8:
            raise ValueError("J2K: invalid COC parameters")
        o = _comp_cp(c)
        o.levels = levels
        o.cblk_w = 1 << (cbw + 2)
        o.cblk_h = 1 << (cbh + 2)
        o.cblk_style = style
        o.reversible = transform == 1
        if scoc & 1:
            o.precincts = []
            for r in range(levels + 1):
                b = body[cw + 6 + r]
                o.precincts.append((b & 15, b >> 4))
        else:
            o.precincts = None
    for body in qcc_raw:
        c = body[0] if cw == 1 else struct.unpack_from(">H", body, 0)[0]
        sq = body[cw]
        style = sq & 0x1F
        o = _comp_cp(c)
        o.qcd_style = style
        o.guard_bits = sq >> 5
        q: List[Tuple[int, int]] = []
        if style == 0:
            for b in body[cw + 1:]:
                q.append((b >> 3, 0))
        elif style == 2:
            for off in range(cw + 1, len(body) - 1, 2):
                v = struct.unpack_from(">H", body, off)[0]
                q.append((v >> 11, v & 0x7FF))
        else:  # scalar derived
            v = struct.unpack_from(">H", body, cw + 1)[0]
            q.append((v >> 11, v & 0x7FF))
        o.band_q = q
    # pad band lists (a COC-raised decomposition count may exceed the bands
    # QCD supplied; T.800: reuse the last signalled value)
    for o in cp.comp_overrides.values():
        need = 1 + 3 * o.levels
        if o.qcd_style != 1 and o.band_q and len(o.band_q) < need:
            o.band_q = o.band_q + [o.band_q[-1]] * (need - len(o.band_q))
    return siz, cp, pos


def parse_poc_body(poc_raw: bytes, ncomp: int):
    """Decode a POC marker body (T.800 A.6.6) into [(RSpoc, CSpoc, LYEpoc,
    REpoc, CEpoc, Ppoc)]; component fields are 1 byte below 257
    components."""
    wide = ncomp >= 257
    step = 7 + (2 if wide else 0)
    out = []
    off = 0
    while off + step <= len(poc_raw):
        if wide:
            rs = poc_raw[off]
            (cs,) = struct.unpack_from(">H", poc_raw, off + 1)
            (lye,) = struct.unpack_from(">H", poc_raw, off + 3)
            re_ = poc_raw[off + 5]
            (ce,) = struct.unpack_from(">H", poc_raw, off + 6)
            ppoc = poc_raw[off + 8]
        else:
            rs, cs = poc_raw[off], poc_raw[off + 1]
            (lye,) = struct.unpack_from(">H", poc_raw, off + 2)
            re_, ce, ppoc = (poc_raw[off + 4], poc_raw[off + 5],
                             poc_raw[off + 6])
        if ppoc > 4 or re_ <= rs or ce <= cs or lye == 0:
            raise ValueError("J2K: invalid POC progression change")
        out.append((rs, cs, lye, re_, ce, ppoc))
        off += step
    if not out:
        raise ValueError("J2K: empty POC marker")
    return out


def iter_tile_parts(data: bytes, pos: int, ppm: bytes = None):
    """Yield (tile_index, tile_data, packed_headers, poc_bodies) per tile,
    with MULTI-TILE-PART streams reassembled: a tile's parts carry
    consecutive slices of its packet sequence (tile-part boundaries fall on
    packet boundaries, T.800 A.4.2), so concatenating the SOD payloads in
    TPsot order restores the full sequence. packed_headers is the tile's
    PPT (A.7.5) or PPM (A.7.4) header stream, or None. poc_bodies is the
    concatenated POC marker bodies from the tile-part headers (A.6.6 —
    overrides the main-header POC for this tile; openjpeg writes POC
    here), or None. Single-part streams stream through without buffering."""
    n = len(data)
    parts: dict = {}
    ppt_segs: dict = {}
    ppm_hdrs: dict = {}
    poc_bodies: dict = {}
    ppm_pos = 0
    order: list = []
    multi = False
    while pos + 4 <= n:
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == EOC:
            break
        if marker != SOT:
            raise ValueError(f"J2K: expected SOT, got {marker:#x}")
        _, lsot = struct.unpack_from(">HH", data, pos)
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", data, pos + 4)
        tile_end = pos + psot if psot else n
        q = pos + 2 + lsot
        # skip tile-part header segments until SOD; reject per-tile coding
        # overrides rather than mis-decode with main-header parameters
        while q + 2 <= n:
            m = struct.unpack_from(">H", data, q)[0]
            if m == SOD:
                q += 2
                break
            if m in (COD, COC, QCD, QCC):
                raise ValueError(
                    "J2K: per-tile coding/quantization overrides not supported"
                )
            if m == RGN:
                # tile-level ROI overrides: reject so the system-openjpeg
                # rung handles them (main-header RGN decodes natively)
                raise ValueError("J2K: RGN tile-part segments not supported")
            ln = struct.unpack_from(">H", data, q + 2)[0]
            if m == POC:
                poc_bodies.setdefault(isot, []).append(
                    (tpsot, data[q + 4:q + 2 + ln]))
            if m == 0xFF61:  # PPT: Zppt + packed packet headers
                zppt = data[q + 4]
                ppt_segs.setdefault(isot, []).append(
                    (zppt, data[q + 5:q + 2 + ln]))
            q += 2 + ln
        span = data[q:tile_end]
        if tile_end <= pos:  # corrupted Psot must not stall the walk
            raise ValueError("J2K: non-advancing tile-part length")
        pos = tile_end
        if tpsot > 0 or isot in parts:
            multi = True
        if ppm is not None:
            # one [Nppm][headers] record per tile-part, stream order
            if ppm_pos + 4 > len(ppm):
                raise ValueError("J2K: PPM record stream exhausted")
            (nppm,) = struct.unpack_from(">I", ppm, ppm_pos)
            rec = ppm[ppm_pos + 4:ppm_pos + 4 + nppm]
            ppm_pos += 4 + nppm
            ppm_hdrs.setdefault(isot, []).append((tpsot, rec))
        parts.setdefault(isot, []).append((tpsot, span))
        if isot not in order:
            order.append(isot)
    for isot in order:
        plist = sorted(parts[isot], key=lambda t: t[0])
        if multi and [t for t, _ in plist] != list(range(len(plist))):
            raise ValueError("J2K: non-contiguous tile-part sequence")
        ppt = None
        if isot in ppt_segs:
            segs = sorted(ppt_segs[isot], key=lambda t: t[0])
            ppt = b"".join(sp for _, sp in segs)
        elif isot in ppm_hdrs:
            segs = sorted(ppm_hdrs[isot], key=lambda t: t[0])
            ppt = b"".join(sp for _, sp in segs)
        poc = None
        if isot in poc_bodies:
            segs = sorted(poc_bodies[isot], key=lambda t: t[0])
            poc = b"".join(sp for _, sp in segs)
        yield isot, (plist[0][1] if len(plist) == 1
                     else b"".join(sp for _, sp in plist)), ppt, poc


def wrap_jp2(codestream: bytes, siz: SizInfo,
             colorspace: str = None, brand: bytes = b"jp2 ") -> bytes:
    """Minimal JP2-family container: signature, ftyp, jp2h(ihdr+colr),
    jp2c. colorspace: None (sRGB for 3 comps, grey otherwise) or "sycc"
    (EnumCS 18 — subsampled YCbCr encodes, ISO 15444-1 I.5.3.3).
    brand: b"jp2 " or b"jph " (HTJ2K container, ISO 15444-15)."""

    def box(btype: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body) + 8) + btype + body

    ihdr = struct.pack(
        ">IIHBBBB", siz.height, siz.width, siz.ncomp, siz.depth[0] - 1, 7, 0, 0
    )
    enum_cs = 18 if colorspace == "sycc" else (16 if siz.ncomp == 3 else 17)
    colr = b"\x01\x00\x00" + struct.pack(">I", enum_cs)
    jp2h = box(b"ihdr", ihdr) + box(b"colr", colr)
    # jph streams are HT-coded and NOT decodable by a baseline part-1
    # reader, so the ftyp compatibility list must not advertise "jp2 "
    # (ISO 15444-15 conformance; was an advisor finding)
    compat = brand
    return (
        JP2_SIG
        + box(b"ftyp", brand + struct.pack(">I", 0) + compat)
        + box(b"jp2h", jp2h)
        + box(b"jp2c", codestream)
    )


def unwrap_jp2(data: bytes) -> bytes:
    """Extract the contiguous codestream from a JP2 container (or return
    raw J2K input unchanged)."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return data
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        (ln,) = struct.unpack_from(">I", data, pos)
        btype = data[pos + 4 : pos + 8]
        body_off = pos + 8
        if ln == 1:  # extended length
            (xl,) = struct.unpack_from(">Q", data, pos + 8)
            ln = xl
            body_off = pos + 16
        if btype == b"jp2c":
            end = pos + ln if ln else n
            return data[body_off:end]
        pos += ln if ln else n
    raise ValueError("JP2: no codestream box")


def jp2_colorspace(data: bytes):
    """EnumCS of the JP2 colr box (16 sRGB / 17 grey / 18 sYCC), or None
    for raw codestreams / missing box / ICC (method 2) boxes. Real box
    walk via the parser (no byte-find heuristic — codestream bytes can
    contain b"colr" by chance)."""
    from ...parsers.jpeg2k import jp2_color_info

    ci = jp2_color_info(data)
    if ci is None or ci[0] != 1:
        return None
    return ci[1]
