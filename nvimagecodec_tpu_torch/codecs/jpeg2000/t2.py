"""JPEG2000 Tier-2: packet header coding (ITU-T T.800 B.9-B.12).

Packets are per (layer, resolution, component, precinct); maximal precincts
(the implied PPx=PPy=15 default) degenerate to one precinct per resolution.
Inclusion/zero-bitplane tag trees live per precinct-band and persist across
layers, as do the per-code-block Lblock and pass counters — both sides of the
multi-layer state machine (reference analog: the packet parsing nvjpeg2k does
internally; written from the spec).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .codestream import (
    CodingParams,
    HeaderBitReader,
    HeaderBitWriter,
    Resolution,
    SizInfo,
    cblk_grid_precinct,
    precinct_count,
    precinct_rect,
)
from .tagtree import TagTree


@dataclass
class CblkState:
    """Accumulated decode state of one code-block across layers."""

    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    zero_bps: int = 0
    num_passes: int = 0
    lblock: int = 3
    segments: List[bytes] = field(default_factory=list)


@dataclass
class PrecinctState:
    incl: TagTree
    zbp: TagTree
    nx: int
    ny: int
    cblks: List[CblkState] = field(default_factory=list)


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


def _npasses_read(br: HeaderBitReader) -> int:
    if not br.get_bit():
        return 1
    if not br.get_bit():
        return 2
    v = br.get_bits(2)
    if v < 3:
        return 3 + v
    v = br.get_bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.get_bits(7)


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
                [CblkState(*b) for b in blocks],
            )
    return npx * npy, out


class PacketDecoder:
    """Decodes the packet sequence of one tile into per-codeblock segment
    lists. The bit-level header parse (tag trees, pass counts, Lblock,
    segment lengths) runs in native code (native/j2k_t2.cpp) with state
    held per tile in a native context — semantics identical to the
    commented Python at the top of this file's git history; geometry and
    the progression iteration stay here."""

    _ERRORS = {
        -1: "J2K: runaway zero-bitplane tree",
        -2: "J2K: runaway Lblock",
        -3: "J2K: absurd segment length field",
        -4: "J2K: packet body past end of tile data",
        -5: "J2K: packet overflows segment capacity",
    }

    def __init__(self, siz: SizInfo, cp: CodingParams,
                 resolutions: Dict[int, List[Resolution]]):
        import ctypes

        from ...native import lib

        self.siz = siz
        self.cp = cp
        self.resolutions = resolutions  # comp -> [Resolution]
        self._L = lib()  # signatures: native._declare_j2k
        self._ctx = ctypes.c_void_p(self._L.tic_t2_create())
        self._outbuf = None  # reused native length-group buffer
        self.nprec: Dict[Tuple[int, int], int] = {}
        # (c, r, p, bi) -> (band_id, [block geometry])
        self._bands: Dict[Tuple[int, int, int, int], Tuple[int, list]] = {}
        self._segs: Dict[int, list] = {}   # global cb id -> [bytes]
        self._cb_base: Dict[int, int] = {}  # band_id -> first global cb id
        ncb_total = 0
        for c, res_list in resolutions.items():
            ccp = cp.for_comp(c)
            for res in res_list:
                ppx, ppy = ccp.pp(res.r)
                npx, npy = precinct_count(res, ppx, ppy)
                self.nprec[(c, res.r)] = npx * npy
                for p in range(npx * npy):
                    prect, _ = precinct_rect(res, ppx, ppy, p)
                    for bi, band in enumerate(res.bands):
                        nx, ny, blocks = cblk_grid_precinct(
                            band, res.r, ppx, ppy, prect,
                            ccp.cblk_w, ccp.cblk_h)
                        bid = self._L.tic_t2_add_precband(
                            self._ctx, nx, ny)
                        self._bands[(c, res.r, p, bi)] = (bid, blocks)
                        self._cb_base[bid] = ncb_total
                        ncb_total += nx * ny

    def __del__(self):
        try:
            self._L.tic_t2_free(self._ctx)
        except Exception:
            pass

    def band_cblks(self, c: int, r: int, bi: int) -> List[CblkState]:
        """All code-blocks of one band, concatenated over its precincts."""
        import ctypes

        import numpy as _np

        out: List[CblkState] = []
        for p in range(self.nprec.get((c, r), 0)):
            bid, blocks = self._bands[(c, r, p, bi)]
            n = len(blocks)
            if n == 0:
                continue
            # fully overwritten by tic_t2_dump: no zeroing needed
            incl = _np.empty(n, _np.int32)
            zbps = _np.empty(n, _np.int32)
            npasses = _np.empty(n, _np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            self._L.tic_t2_dump(self._ctx, bid,
                                incl.ctypes.data_as(i32p),
                                zbps.ctypes.data_as(i32p),
                                npasses.ctypes.data_as(i32p))
            base = self._cb_base[bid]
            # bulk-convert once: per-element numpy scalar indexing costs
            # ~10x a list walk at 777 blocks/image
            incl_l = incl.tolist()
            zbps_l = zbps.tolist()
            np_l = npasses.tolist()
            segs = self._segs
            for i, b in enumerate(blocks):
                cb = CblkState(*b)
                cb.included = bool(incl_l[i])
                cb.zero_bps = zbps_l[i]
                cb.num_passes = np_l[i]
                cb.segments = segs.get(base + i, [])
                out.append(cb)
        return out

    def read_packet(self, br: HeaderBitReader, c: int, r: int, layer: int,
                    p: int = 0, body: bytes = None,
                    body_pos=None) -> None:
        """Parse one packet header via the native T2 context.

        On a negative native return this raises and the context must be
        considered POISONED: tag-tree / code-block inclusion state may be
        partially mutated while ``br.pos`` is not advanced, so re-calling
        over the same PacketDecoder would silently resume from corrupted
        state. Callers abort the whole decode on error (no resync/retry).
        """
        import ctypes

        res = self.resolutions[c][r]
        nb = len(res.bands)
        entries = [self._bands[(c, r, p, bi)] for bi in range(nb)]
        band_ids = (ctypes.c_int32 * nb)(*[e[0] for e in entries])
        # Segment-rule style bits the native reader understands: 0x40 (HT
        # two-segment rule) and 0x05 (part-1 TERMALL/BYPASS terminations).
        ht = self.cp.for_comp(c).cblk_style & 0x45
        # worst case codeword segments per code-block in the precinct:
        # 2 for HT, one per pass (<= 109 for part-1) under TERMALL/BYPASS
        per_cb = 110 if (ht & 0x05) else 2
        cap = 8 + per_cb * sum(len(e[1]) for e in entries)
        out = self._outbuf
        if out is None or len(out) < 3 * cap:
            out = self._outbuf = (ctypes.c_int64 * (3 * cap))()
        pos = ctypes.c_int64(br.pos)
        flags = ((1 if self.cp.sop else 0) | (2 if self.cp.eph else 0))
        if body is None:
            n = self._L.tic_t2_read_packet(
                self._ctx, br.data, len(br.data), ctypes.byref(pos),
                layer, band_ids, nb, ht, out, cap, flags)
        else:
            # PPT mode (T.800 A.7.5): header bits from the packed-header
            # buffer, codeword segments from the tile body stream
            n = self._L.tic_t2_read_packet_split(
                self._ctx, br.data, len(br.data), ctypes.byref(pos),
                layer, band_ids, nb, ht, out, cap, flags,
                body, len(body), ctypes.byref(body_pos))
        if n < 0:
            raise ValueError(self._ERRORS.get(n, f"J2K: packet parse rc={n}"))
        data = br.data if body is None else body
        segs = self._segs
        for i in range(n):
            cb_id = out[3 * i]
            # bit 62: this length-field group continues the codeword
            # segment started in an earlier layer (TERMALL/BYPASS only)
            cont = cb_id & (1 << 62)
            cb_id &= (1 << 62) - 1
            off = out[3 * i + 1]
            ln = out[3 * i + 2]
            # segments are stored as (off, len) RANGES into the tile data
            # (zero-copy: the block batch reads them in place); adjacent
            # continuations merge, non-adjacent ones materialize to bytes
            lst = segs.get(cb_id)
            if cont and lst:
                prev = lst[-1]
                if type(prev) is tuple and prev[0] + prev[1] == off:
                    lst[-1] = (prev[0], prev[1] + ln)
                else:
                    pb = (data[prev[0]:prev[0] + prev[1]]
                          if type(prev) is tuple else prev)
                    lst[-1] = pb + data[off:off + ln]
            elif lst is not None:
                lst.append((off, ln))
            else:
                segs[cb_id] = [(off, ln)]
        br.pos = pos.value


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
