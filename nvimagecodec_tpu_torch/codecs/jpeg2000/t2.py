"""JPEG2000 Tier-2: packet header coding (ITU-T T.800 B.9-B.12).

Packets are per (layer, resolution, component, precinct); maximal precincts
(the implied PPx=PPy=15 default) degenerate to one precinct per resolution.
Inclusion/zero-bitplane tag trees live per precinct-band and persist across
layers, as do the per-code-block Lblock and pass counters — both sides of the
multi-layer state machine (reference analog: the packet parsing nvjpeg2k does
internally; written from the spec).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .codestream import (
    Band,
    CodingParams,
    HeaderBitWriter,
    Resolution,
    cblk_grid_precinct,
    precinct_count,
    precinct_rect,
)
from ...ops.j2k_t1 import ROW
from .tagtree import TagTree


@dataclass
class PrecinctState:
    """The encoder's state of one precinct-band: its tag trees and its
    code-blocks' rectangles (x0, y0, x1, y1), raster order."""
    incl: TagTree
    zbp: TagTree
    nx: int
    ny: int
    cblks: List[Tuple[int, int, int, int]] = field(default_factory=list)


def _npasses_write(bw: HeaderBitWriter, n: int) -> None:
    if n == 1:
        bw.put_bit(0)
    elif n == 2:
        bw.put_bits(0b10, 2)
    elif n <= 5:
        bw.put_bits(0b11, 2)
        bw.put_bits(n - 3, 2)
    elif n <= 36:
        bw.put_bits(0b1111, 4)
        bw.put_bits(n - 6, 5)
    else:
        bw.put_bits(0b111111111, 9)
        bw.put_bits(n - 37, 7)


def _floor_log2(n: int) -> int:
    return n.bit_length() - 1


def _build_precinct_states(cp: CodingParams, res: Resolution):
    """PrecinctState per (precinct, band) of one resolution."""
    ppx, ppy = cp.pp(res.r)
    npx, npy = precinct_count(res, ppx, ppy)
    out: Dict[Tuple[int, int], PrecinctState] = {}
    for p in range(npx * npy):
        prect, _ = precinct_rect(res, ppx, ppy, p)
        for bi, band in enumerate(res.bands):
            nx, ny, blocks = cblk_grid_precinct(
                band, res.r, ppx, ppy, prect, cp.cblk_w, cp.cblk_h
            )
            out[(p, bi)] = PrecinctState(
                TagTree(max(nx, 1), max(ny, 1)),
                TagTree(max(nx, 1), max(ny, 1)),
                nx, ny,
                blocks,
            )
    return npx * npy, out


class TileRows(NamedTuple):
    """The rows of a tile's code-blocks, as `PacketDecoder.rows` writes
    them (native/j2k_t2.cpp tic_t2_rows): `t1`, [n, ops/j2k_t1.ROW] int32 a
    part-1 block; `ht`, [n, 12] int32 an HT block (the native HT batch
    decoder's row, then the stride and the destination's element offset,
    low and high 32 bits); `side`, the segments a row does not read in
    place in the tile data (joined, or TERMALL/BYPASS blobs), which follow
    the tile data in the rows' data; `bad`, the first part-1 row the
    native decoder would refuse (-1 none)."""
    t1: np.ndarray
    ht: np.ndarray
    side: np.ndarray
    bad: int


# int64 a band of `PacketDecoder.rows`'s specs (native/j2k_t2.cpp)
_SPEC = 16


class TileLayout(NamedTuple):
    """A tile's geometry and packet order as Tier-2's native reader takes
    them (native/j2k_t2.cpp): `geom`, 22 int32 a resolution
    (tic_t2_add_resolutions); `res`, (c, r) -> (its precincts, the id of
    precinct 0's first band, its bands), the ids of (c, r, p, bi) following
    in precinct, then band, order; `packets`, 4 int32 a packet in
    progression order (tic_t2_read_packets); `flags`, SOP markers (1) and
    EPH markers (2)."""
    geom: np.ndarray
    res: Dict[Tuple[int, int], Tuple[int, int, int]]
    packets: np.ndarray
    flags: int


def tile_layout(cp: CodingParams, resolutions: Dict[int, List[Resolution]],
                packets) -> TileLayout:
    """The layout of a tile of `resolutions` (comp -> [Resolution]) coded
    with `cp`, whose packets (layer, r, c, p) come in the order of
    `packets`."""
    geom: List[int] = []
    res: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
    first = 0
    for c, res_list in resolutions.items():
        ccp = cp.for_comp(c)
        for rs in res_list:
            ppx, ppy = ccp.pp(rs.r)
            npx, npy = precinct_count(rs, ppx, ppy)
            nb = len(rs.bands)
            res[(c, rs.r)] = (npx * npy, first, nb)
            first += npx * npy * nb
            geom += (rs.x0, rs.y0, rs.x1, rs.y1, rs.r, ppx, ppy, ccp.cblk_w,
                     ccp.cblk_h, nb)
            for band in rs.bands:
                geom += (band.x0, band.y0, band.x1, band.y1)
            geom += (0,) * (12 - 4 * nb)
    # the style bits the reader takes: 0x40 (HT two-segment rule) and 0x05
    # (part-1 TERMALL/BYPASS terminations)
    sty = {c: cp.for_comp(c).cblk_style & 0x45 for c in resolutions}
    pk: List[int] = []
    for l, r, c, p in packets:
        _n, b0, nb = res[(c, r)]
        pk += (l, b0 + p * nb, nb, sty[c])
    return TileLayout(np.asarray(geom or [0], np.int32), res,
                      np.asarray(pk or [0], np.int32),
                      (1 if cp.sop else 0) | (2 if cp.eph else 0))


class PacketDecoder:
    """Decodes the packet sequence of one tile into a native context
    (native/j2k_t2.cpp) that holds every code-block's geometry, state and
    codeword segments (as ranges of the tile data) across layers:
    `read_packets` reads the tile's packets in one call, and `rows` then
    writes every code-block's Tier-1 row in one call."""

    _ERRORS = {
        -1: "J2K: runaway zero-bitplane tree",
        -2: "J2K: runaway Lblock",
        -3: "J2K: absurd segment length field",
        -4: "J2K: packet body past end of tile data",
        -5: "J2K: packet overflows segment capacity",
    }

    def __init__(self, layout: TileLayout):
        from ...native import lib

        self.layout = layout
        self._L = lib()  # signatures: native._declare_j2k
        self._ctx = ctypes.c_void_p(self._L.tic_t2_create())
        self._L.tic_t2_add_resolutions(self._ctx, len(layout.geom) // 22,
                                       layout.geom.ctypes.data)

    def __del__(self):
        try:
            self._L.tic_t2_free(self._ctx)
        except Exception:
            pass

    def read_packets(self, tdata: bytes, ppt=None) -> None:
        """Reads the tile's packets from the tile data or, with PPT/PPM
        (T.800 A.7.4-5), their headers from the packed headers `ppt` and
        their codeword segments from the tile data, in one native call.
        Raises a ValueError for a malformed packet; the context then holds
        a part-read tile and is done with."""
        pk = self.layout.packets
        hdr = tdata if ppt is None else ppt
        rc = self._L.tic_t2_read_packets(
            self._ctx, hdr, len(hdr), None if ppt is None else tdata,
            len(tdata), pk.ctypes.data, len(pk) // 4, self.layout.flags)
        if rc == -6:
            raise ValueError("J2K: tile data exhausted mid-packet"
                             if ppt is None else "J2K: PPT headers exhausted")
        if rc < 0:
            raise ValueError(self._ERRORS.get(rc,
                                              f"J2K: packet parse rc={rc}"))

    def band_spec(self, c: int, r: int, bi: int, band: Band, dest,
                  mb: int, style: int, need=None) -> List[int]:
        """One band of `rows`: its code-blocks of every precinct go to
        `dest`, (element offset of the band's plane, its row stride), with
        Mb `mb` and code-block style `style` (HT where 0x40); with `need`,
        a region (y0, x0, y1, x1) in band coordinates, only blocks that
        meet it."""
        plane, stride = dest
        nprec, first, nb = self.layout.res[(c, r)]
        return [1 if style & 0x40 else 0, plane, stride, band.btype, mb,
                style, band.x0, band.y0, need is not None,
                *(need or (0, 0, 0, 0)), first + bi, nprec, nb]

    def rows(self, specs: List[List[int]], tdata: bytes,
             base: int = 0) -> TileRows:
        """Every code-block with a pass of the bands `specs` (`band_spec`),
        band after band, in one native call: the rows' segment offsets
        count from a data buffer that holds `tdata` at `base` and the side
        area right after it."""
        ncb = self._L.tic_t2_blocks(self._ctx)
        t1 = np.empty((ncb, ROW), np.int32)
        ht = np.empty((ncb, 12), np.int32)
        spec = np.asarray(specs or [[0] * _SPEC], np.int64)
        out = np.zeros(4, np.int64)
        self._L.tic_t2_rows(self._ctx, tdata, len(tdata), base,
                            spec.ctypes.data, len(specs), t1.ctypes.data,
                            ht.ctypes.data, out.ctypes.data)
        n1, n2, used, bad = (int(v) for v in out)
        side = np.empty(used, np.uint8)
        if used:
            self._L.tic_t2_side(self._ctx, side.ctypes.data)
        return TileRows(t1[:n1], ht[:n2], side, bad)


@dataclass
class _EncCblk:
    """Encoder-side per-code-block layering plan + running state."""

    layers: List[Tuple[bytes, int]]  # per layer: (segment bytes, npasses)
    zero_bps: int
    first_layer: int  # num_layers if never included
    included: bool = False
    lblock: int = 3
    cum_passes: int = 0
    # HT (T.814): layer -> [(segment bytes, npasses)] when a layer carries
    # multiple terminated codeword segments (cleanup | SigProp+MagRef)
    splits: Dict[int, List[Tuple[bytes, int]]] = field(default_factory=dict)


class PacketEncoder:
    """Multi-layer, precinct-aware packet writer. Construct per tile with the
    full layering plan, then emit packets in progression order via
    write_packet — tag trees / Lblock state persist across layers exactly
    mirroring PacketDecoder."""

    def __init__(self, cp: CodingParams,
                 resolutions: Dict[int, List[Resolution]], ncomp: int):
        self.cp = cp
        self.resolutions = resolutions
        # (c, r, p, bi) -> PrecinctState-shaped encoder state
        self.state: Dict[Tuple[int, int, int, int], PrecinctState] = {}
        self.nprec: Dict[Tuple[int, int], int] = {}
        self.plans: Dict[Tuple[int, int, int, int], List[_EncCblk]] = {}
        for c in range(ncomp):
            for res in resolutions[c]:
                np_, states = _build_precinct_states(cp.for_comp(c), res)
                self.nprec[(c, res.r)] = np_
                for (p, bi), ps in states.items():
                    self.state[(c, res.r, p, bi)] = ps
                    self.plans[(c, res.r, p, bi)] = []
        # native header writer (native/j2k_t2.cpp encoder side); Python
        # bit-writer below stays as the fallback and the reference.
        # TERMALL/BYPASS blocks can carry many codeword segments per
        # packet (one per terminated pass); the native writer's meta rows
        # hold at most two, so those streams use the Python writer.
        self._nctx = None
        if cp.cblk_style & 0x05:
            return
        try:
            import ctypes

            from ...native import lib

            L = lib()
            self._NL = L
            self._nctx = ctypes.c_void_p(L.tic_t2e_create())
            self._nband: Dict[Tuple[int, int, int, int], int] = {}
        except Exception:
            self._nctx = None

    def __del__(self):
        if getattr(self, "_nctx", None) is not None:
            try:
                self._NL.tic_t2e_free(self._nctx)
            except Exception:
                pass

    def set_plan(self, c: int, r: int, p: int, bi: int,
                 plan: List[_EncCblk]) -> None:
        """Per-code-block layer plan in the precinct's raster order; seeds
        the inclusion (first layer) and zero-bitplane tag trees."""
        ps = self.state[(c, r, p, bi)]
        assert len(plan) == len(ps.cblks)
        self.plans[(c, r, p, bi)] = plan
        if self._nctx is not None:
            import ctypes

            import numpy as _np

            i32p = ctypes.POINTER(ctypes.c_int32)
            fl = _np.asarray([e.first_layer for e in plan] or [0], _np.int32)
            zb = _np.asarray([e.zero_bps for e in plan] or [0], _np.int32)
            nx = max(ps.nx, 1) if plan else 0
            ny = (len(plan) + nx - 1) // nx if plan else 0
            bid = self._NL.tic_t2e_add_precband(
                self._nctx, nx if plan else 0, ny,
                fl.ctypes.data_as(i32p), zb.ctypes.data_as(i32p))
            self._nband[(c, r, p, bi)] = bid
            return
        if plan:
            ps.incl.set_values([e.first_layer for e in plan])
            ps.zbp.set_values([e.zero_bps for e in plan])

    def write_packet(self, c: int, r: int, p: int, layer: int) -> bytes:
        if self._nctx is not None:
            return self._write_packet_native(c, r, p, layer)
        return self._write_packet_py(c, r, p, layer)

    def _write_packet_native(self, c: int, r: int, p: int,
                             layer: int) -> bytes:
        import ctypes

        import numpy as _np

        res = self.resolutions[c][r]
        nb = len(res.bands)
        band_ids = _np.empty(nb, _np.int32)
        ncbs = _np.empty(nb, _np.int32)
        metas = []
        bodies: List[bytes] = []
        i32p = ctypes.POINTER(ctypes.c_int32)
        for bi in range(nb):
            plan = self.plans[(c, r, p, bi)]
            bid = self._nband.get((c, r, p, bi))
            if bid is None:  # band whose plan was never set: empty
                z = _np.zeros(1, _np.int32)
                bid = self._NL.tic_t2e_add_precband(
                    self._nctx, 0, 0, z.ctypes.data_as(i32p),
                    z.ctypes.data_as(i32p))
                self._nband[(c, r, p, bi)] = bid
            band_ids[bi] = bid
            ncbs[bi] = len(plan)
            for e in plan:
                seg, npasses = (
                    e.layers[layer] if layer < len(e.layers) else (b"", 0)
                )
                contributes = layer >= e.first_layer and npasses > 0
                row = [1 if contributes else 0, npasses, 0, 0, 1, 0, 1]
                if contributes:
                    segments = e.splits.get(layer, [(seg, npasses)])
                    # the native meta row holds at most 2 segments; plans
                    # that could split further (TERMALL/BYPASS) never take
                    # this writer, but guard so a >2 split can never make
                    # the native side read past the row
                    if len(segments) > 2:  # not an assert: must survive -O
                        raise ValueError(
                            "native packet writer got "
                            f"{len(segments)} segments (max 2)")
                    row[2] = len(segments)
                    for sgi, (sdat, snp) in enumerate(segments[:2]):
                        row[3 + 2 * sgi] = len(sdat)
                        row[4 + 2 * sgi] = snp
                        bodies.append(sdat)
                metas.append(row)
        meta = _np.asarray(metas or [[0] * 7], _np.int32)
        cap = 4096 + 2 * meta.shape[0] * 8
        out = _np.empty(cap, _np.uint8)
        n = self._NL.tic_t2e_write_packet(
            self._nctx, band_ids.ctypes.data_as(i32p), nb,
            ncbs.ctypes.data_as(i32p), layer,
            meta.ctypes.data_as(i32p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise ValueError("J2K: packet header overflow")
        return out[:n].tobytes() + b"".join(bodies)

    def _write_packet_py(self, c: int, r: int, p: int, layer: int) -> bytes:
        res = self.resolutions[c][r]
        bw = HeaderBitWriter()
        any_data = False
        for bi in range(len(res.bands)):
            for e in self.plans[(c, r, p, bi)]:
                if layer >= e.first_layer and e.layers[layer][1] > 0:
                    any_data = True
        if not any_data:
            bw.put_bit(0)
            return bw.flush()
        bw.put_bit(1)
        bodies: List[bytes] = []
        for bi in range(len(res.bands)):
            ps = self.state[(c, r, p, bi)]
            for idx, e in enumerate(self.plans[(c, r, p, bi)]):
                x, y = idx % max(ps.nx, 1), idx // max(ps.nx, 1)
                seg, npasses = (
                    e.layers[layer] if layer < len(e.layers) else (b"", 0)
                )
                contributes = layer >= e.first_layer and npasses > 0
                if not e.included:
                    # first-inclusion signaling via the tag tree (threshold
                    # = layer+1); resolves exactly when layer == first_layer
                    ps.incl.encode(bw, x, y, layer + 1)
                    if not contributes:
                        continue
                    # newly included: emit the zero-bitplane tree to leaf
                    k = 1
                    while True:
                        ps.zbp.encode(bw, x, y, k)
                        if ps.zbp.coded[ps.zbp._index(0, x, y)]:
                            break
                        k += 1
                    e.included = True
                else:
                    bw.put_bit(1 if contributes else 0)
                    if not contributes:
                        continue
                _npasses_write(bw, npasses)
                segments = e.splits.get(layer, [(seg, npasses)])
                nbits_needed = max(
                    max(1, len(s)).bit_length() - _floor_log2(np_)
                    for s, np_ in segments
                )
                while e.lblock < nbits_needed:
                    bw.put_bit(1)
                    e.lblock += 1
                bw.put_bit(0)
                for s, np_ in segments:
                    bw.put_bits(len(s), e.lblock + _floor_log2(np_))
                    bodies.append(s)
        header = bw.flush()
        return header + b"".join(bodies)


def plan_layers_ht(cup: bytes, ref: bytes, npasses: int, zero_bps: int,
                   num_layers: int) -> _EncCblk:
    """Layer plan for an HT code-block (T.814): the cleanup pass is one
    terminated segment; SigProp+MagRef (if present) share a second. With
    one layer the first packet carries both segments (two length fields);
    with more layers the cleanup goes to the first layer and the
    refinement segment to the second."""
    if npasses <= 0 or not cup:
        return _EncCblk([(b"", 0)] * num_layers, zero_bps, num_layers)
    layers: List[Tuple[bytes, int]] = []
    splits: Dict[int, List[Tuple[bytes, int]]] = {}
    if npasses == 1 or not ref:
        layers.append((cup, 1))
    elif num_layers == 1:
        layers.append((cup + ref, npasses))
        splits[0] = [(cup, 1), (ref, npasses - 1)]
    else:
        layers.append((cup, 1))
        layers.append((ref, npasses - 1))
    while len(layers) < num_layers:
        layers.append((b"", 0))
    return _EncCblk(layers, zero_bps, 0, splits=splits)


def pass_is_raw(style: int, p: int) -> bool:
    """Part-1 selective bypass (T.800 B.10.7.2): cumulative pass p is
    raw-coded when BYPASS is on, p >= 10 and p is not a cleanup pass."""
    return bool(style & 0x01) and p >= 10 and (p % 3) != 0


def terminated_after(style: int, p: int) -> bool:
    """True when a codeword-segment termination follows pass p: always
    under TERMALL (0x04); at every MQ<->raw switch under BYPASS (0x01)."""
    if style & 0x04:
        return True
    if not (style & 0x01):
        return False
    return pass_is_raw(style, p) != pass_is_raw(style, p + 1)


def seg_pass_groups(style: int, npasses: int, start: int = 0) -> List[int]:
    """Pass counts per terminated codeword segment for a block coded with
    TERMALL/BYPASS — must mirror the native T1 encoder's termination
    points (native/j2k_t1.cpp terminated_after) and the T2 reader's
    grouping (native/j2k_t2.cpp)."""
    groups: List[int] = []
    cnt = 0
    for p in range(start, start + npasses):
        cnt += 1
        if p == start + npasses - 1 or terminated_after(style, p):
            groups.append(cnt)
            cnt = 0
    return groups


def plan_layers_seg(segments: List[Tuple[bytes, int]], zero_bps: int,
                    num_layers: int) -> _EncCblk:
    """Layer plan for a multi-segment (TERMALL/BYPASS) code-block. Each
    terminated codeword segment is atomic — its length is signaled in the
    packet whose layer carries its passes (T.800 B.10.7.2) — so segments
    are distributed across layers near-proportionally by pass count rather
    than split at arbitrary byte positions like plan_layers."""
    npasses = sum(n for _, n in segments)
    if npasses <= 0:
        return _EncCblk([(b"", 0)] * num_layers, zero_bps, num_layers)
    layers: List[Tuple[bytes, int]] = []
    splits: Dict[int, List[Tuple[bytes, int]]] = {}
    si = 0
    done = 0
    for l in range(num_layers):
        target = ((l + 1) * npasses + num_layers - 1) // num_layers
        take: List[Tuple[bytes, int]] = []
        while si < len(segments) and (done < target
                                      or l == num_layers - 1):
            take.append(segments[si])
            done += segments[si][1]
            si += 1
        if take:
            layers.append((b"".join(s for s, _ in take),
                           sum(n for _, n in take)))
            if len(take) > 1:
                splits[l] = take
        else:
            layers.append((b"", 0))
    first = next(l for l, (s, n) in enumerate(layers) if n > 0)
    return _EncCblk(layers, zero_bps, first, splits=splits)


def plan_layers(seg: bytes, npasses: int, zero_bps: int,
                num_layers: int) -> _EncCblk:
    """Split one code-block's coding passes across quality layers: earlier
    layers take the leading (most significant) passes, and the terminated MQ
    byte stream splits proportionally at the matching positions — the
    concatenation every conforming decoder performs reconstructs the exact
    single-segment bytes (codeword segments span layers, T.800 B.8)."""
    if npasses <= 0 or not seg:
        return _EncCblk([(b"", 0)] * num_layers, zero_bps, num_layers)
    base, extra = divmod(npasses, num_layers)
    counts = [base + (1 if l < extra else 0) for l in range(num_layers)]
    layers = []
    cum_p = 0
    cum_b = 0
    for l, n in enumerate(counts):
        cum_p += n
        end = len(seg) if cum_p == npasses else round(len(seg) * cum_p / npasses)
        # a layer with passes must carry at least the bytes seen so far
        end = max(end, cum_b)
        layers.append((seg[cum_b:end], n))
        cum_b = end
    first = next(l for l, (s, n) in enumerate(layers) if n > 0)
    return _EncCblk(layers, zero_bps, first)
