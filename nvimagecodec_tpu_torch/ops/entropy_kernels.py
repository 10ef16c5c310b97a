"""K2 (baseline) and K3 (progressive) JPEG Huffman decode, one segment per
lane.

`decode_segments` replaces the Pallas kernel of
nvimagecodec_tpu/ops/pallas_entropy.py (`_build_kernel`) with the same
inputs and outputs: words [W, S] (uint32 bits, held as int32), side [6, S]
int32 → coefficients [R*bpm, 64, S] int16 in zigzag order and err [S] int32.
A CUDA tensor goes to the hand-written kernel in csrc/huffman.cu; a CPU
tensor goes to `decode_segments_plain`, the same decode in plain PyTorch,
vectorised over lanes with one symbol step per iteration.

`decode_prog_scan` does the same for one progressive scan and replaces
`_build_prog_kernel` (csrc/prog_huffman.cu; plain version
`decode_prog_scan_plain`).

`huffman_tables` turns the numpy table form of `entropy_kernel_spec`
(maxcode/base/values per component) into the int32
table tensor both K2 versions read; `prog_scan_tables` builds K3's from a
scan's own table snapshot.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import _build

TAB_HEADER = 34  # maxcode[17] + base[17]

# Host glue of the kernels, numpy only: the scope checks and table forms of
# nvimagecodec_tpu/ops/pallas_entropy.py (`entropy_kernel_spec`, `make_side`,
# `prog_scan_specs`), copied so that both packages route and pack alike.

_TABLES_CACHE: dict = {}


def _build_tables(frame):
    """Per table class: (maxcode[17], base[17], values[nvals]) with
    base[l] = valptr[l] - mincode[l] so sym_idx = code + base[len].
    Content-cached: corpora typically share Huffman tables across frames,
    and this runs per sample on the routing path."""
    fp = tuple(
        (tc, tid, bytes(t.bits), bytes(t.values))
        for tc, tabs in enumerate((frame.dc_huff, frame.ac_huff))
        for tid, t in sorted(tabs.items())
    )
    hit = _TABLES_CACHE.get(fp)
    if hit is not None:
        return hit
    classes = []
    for tc in (0, 1):  # 0 = DC, 1 = AC
        per_id = {}
        tabs = frame.dc_huff if tc == 0 else frame.ac_huff
        for tid, t in tabs.items():
            code = 0
            k = 0
            maxcode = [-1] * 17
            base = [0] * 17
            for l in range(1, 17):
                n = t.bits[l - 1]
                base[l] = k - code
                code += n
                k += n
                maxcode[l] = code - 1 if n else -1
                code <<= 1
            per_id[tid] = (tuple(maxcode), tuple(base),
                           tuple(int(v) for v in t.values))
        classes.append(per_id)
    if len(_TABLES_CACHE) > 4096:
        _TABLES_CACHE.clear()
    _TABLES_CACHE[fp] = classes
    return classes  # [dc_tables, ac_tables]


def entropy_kernel_spec(frame, R: int = 0) -> Tuple:
    """Static bucket description: (R, comp_map, tables, total MCUs).
    `R` = MCUs per segment; 0 means use the frame's restart interval (DRI
    streams) — for streams without restart markers the caller picks R from
    the host index scan's split stride. Raises ValueError when the stream
    shape is outside kernel support."""
    if frame.is_progressive or frame.is_lossless or frame.precision != 8:
        raise ValueError("device entropy: baseline 8-bit only")
    if R <= 0:
        R = frame.restart_interval
    if R <= 0:
        raise ValueError("device entropy: needs a segment stride")
    if (len(frame.scans) != 1
            or len(frame.scans[0].comp_indices) != len(frame.components)):
        raise ValueError("device entropy: one interleaved scan only")
    if len(frame.components) == 1:
        c = frame.components[0]
        if c.h != 1 or c.v != 1:
            # T.81: single-component scans are non-interleaved (sampling
            # factors don't group blocks into MCUs)
            raise ValueError("device entropy: 1-comp scans need h=v=1")
    comp_map = []
    for ci, c in enumerate(frame.components):
        if c.h > 4 or c.v > 4:
            raise ValueError("device entropy: h/v factors <= 4 (T.81 B.2.2)")
        comp_map.extend([ci] * (c.h * c.v))
    scan = frame.scans[0]
    dc_tabs, ac_tabs = _build_tables(frame)
    tables = tuple(
        (dc_tabs[scan.dc_tables[ci]], ac_tabs[scan.ac_tables[ci]])
        for ci in range(len(frame.components))
    )
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    return (R, tuple(comp_map), tables, mcus_x * mcus_y)


def make_side(seg_mcus: np.ndarray, start_bits=None,
              dc0=None) -> np.ndarray:
    """Assemble the kernel's [6, S] int32 sideband from per-lane MCU
    counts, optional start bits, and optional [4, S] DC predictor seeds
    (both zero for restart-marker segments)."""
    S = seg_mcus.shape[-1]
    side = np.zeros((6, S), np.int32)
    side[0] = seg_mcus.reshape(-1)
    if start_bits is not None:
        side[1] = start_bits.reshape(-1)
    if dc0 is not None:
        side[2:6] = dc0
    return side


def prog_scan_specs(frame):
    """Validate a progressive frame for the device path; returns per-scan
    (is_dc, comp_map_or_comp, R_units) metadata. Raises ValueError when
    any scan is outside kernel support."""
    if not frame.is_progressive or frame.precision != 8:
        raise ValueError("prog device entropy: 8-bit progressive only")
    specs = []
    for s in frame.scans:
        if s.restart_interval <= 0:
            raise ValueError("prog device entropy: needs restart markers")
        if s.ss == 0:
            if s.se != 0:
                raise ValueError("prog device entropy: bad DC scan")
            if len(s.comp_indices) != len(frame.components):
                raise ValueError("prog device entropy: partial DC scan")
            for c in frame.components:
                if c.h > 4 or c.v > 4:
                    raise ValueError("prog device entropy: h/v <= 4")
        else:
            if len(s.comp_indices) != 1:
                raise ValueError("prog device entropy: AC scan not single")
        specs.append(s)
    return specs



def huffman_tables(frame, R: int = 0) -> Tuple[int, tuple, np.ndarray]:
    """(R, comp_map, tables) for one bucket. tables is int32
    [ncomp, 2, 34 + nv]: per component DC then AC, maxcode[17], base[17],
    then values[] zero padded to nv. Raises ValueError outside K2's scope
    (the reference's checks)."""
    R, comp_map, tabs, _total = entropy_kernel_spec(frame, R)
    nv = max(1, max(len(t[2]) for comp in tabs for t in comp))
    out = np.zeros((len(tabs), 2, TAB_HEADER + nv), np.int32)
    for ci, comp in enumerate(tabs):
        for tc, (maxcode, base, vals) in enumerate(comp):
            out[ci, tc, :17] = maxcode
            out[ci, tc, 17:34] = base
            out[ci, tc, 34:34 + len(vals)] = vals
    return R, tuple(comp_map), out


def _extend(bits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """T.81 F.2.2.1 EXTEND, elementwise."""
    half = torch.ones_like(t) << (t - 1).clamp(min=0)
    v = torch.where(bits < half, bits - (torch.ones_like(t) << t) + 1, bits)
    return torch.where(t == 0, torch.zeros_like(v), v)


def _padded_words(words: torch.Tensor) -> torch.Tensor:
    """[W, S] int32 words → [W + 2, S] int64 uint32 values with two zero
    rows, so a lane reads zeros past row W."""
    W, S = words.shape
    w = torch.zeros((W + 2, S), dtype=torch.int64, device=words.device)
    w[:W] = words.to(torch.int64) & 0xFFFFFFFF
    return w


def _peek32(w: torch.Tensor, lanes: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    """The 32 bits at bit `pos` of each lane's column (zeros past row W)."""
    wi = (pos >> 5).clamp(max=w.shape[0] - 2)
    v = (w[wi, lanes] << 32) | w[wi + 1, lanes]
    return (v >> (32 - (pos & 31))) & 0xFFFFFFFF


_SHIFTS = torch.arange(15, -1, -1)[:, None]  # 16 - l for l = 1..16


def _huff_decode(p32: torch.Tensor, t: torch.Tensor):
    """(found, length, symbol) per lane for one table row t [34 + nv]:
    the first length l whose l-bit prefix is <= maxcode[l]; a value index
    outside [0, nv) reads 0."""
    nv = t.shape[-1] - TAB_HEADER
    codes = (p32 >> 16)[None, :] >> _SHIFTS.to(p32.device)  # [16, S]
    ok = codes <= t[1:17, None]
    found = ok.any(0)
    first = ok.to(torch.int32).argmax(0)
    code = codes.gather(0, first[None].to(torch.int64))[0]
    idx = code + t[18:34][first]
    inside = (idx >= 0) & (idx < nv)
    sym = torch.where(inside, t[TAB_HEADER:][idx.clamp(0, nv - 1)], 0)
    return found, first.to(torch.int64) + 1, sym


def _take(p32: torch.Tensor, ln: torch.Tensor, n: torch.Tensor):
    """n value bits that follow an ln-bit code in p32 (ln + n <= 31)."""
    return (p32 >> (32 - ln - n)) & ((torch.ones_like(n) << n) - 1)


def decode_segments_plain(words: torch.Tensor, side: torch.Tensor,
                          tables: torch.Tensor, R: int,
                          comp_map: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 in plain PyTorch; same contract as `decode_segments`."""
    W, S = words.shape
    dev = words.device
    bpm = len(comp_map)
    i64 = torch.int64
    w = _padded_words(words)
    lanes = torch.arange(S, device=dev)
    nmcu = side[0].to(i64)
    pos = side[1].to(i64).clone()
    pred = side[2:6].to(i64).clone()
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    out = torch.empty((R * bpm, 64, S), dtype=torch.int16, device=dev)
    tab = tables.to(dev, i64)

    for mcu in range(R):
        active = nmcu > mcu
        for b in range(bpm):
            ci = comp_map[b]
            dct, act = tab[ci, 0], tab[ci, 1]
            regs = torch.zeros((64, S), dtype=i64, device=dev)

            p32 = _peek32(w, lanes, pos)
            found, ln, t = _huff_decode(p32, dct)
            ok = active & found & (t <= 15)
            err |= active & ~ok
            ln = torch.where(ok, ln, 0)
            t = torch.where(ok, t, 0)
            diff = _extend(_take(p32, ln, t), t)
            pred[ci] = torch.where(ok, pred[ci] + diff, pred[ci])
            regs[0] = torch.where(ok, pred[ci], 0)
            pos += ln + t

            k = torch.ones(S, dtype=i64, device=dev)
            pend = active.clone()
            while bool(pend.any()):
                p32 = _peek32(w, lanes, pos)
                found, ln, sym = _huff_decode(p32, act)
                go = pend & found
                run, size = sym >> 4, sym & 15
                eob = go & (size == 0) & (run != 15)
                zrl = go & (size == 0) & (run == 15)
                kk = k + run
                over = go & (size != 0) & (kk > 63)
                wr = go & (size != 0) & ~over
                ln = torch.where(go, ln, 0)
                size = torch.where(wr, size, 0)
                val = _extend(_take(p32, ln, size), size)
                regs[kk[wr], lanes[wr]] = val[wr]
                pos += ln + size
                k = torch.where(zrl, k + 16, torch.where(wr, kk + 1, k))
                bad = (pend & ~found) | over
                err |= bad
                pend &= ~(bad | eob | ((zrl | wr) & (k > 63)))
            out[mcu * bpm + b] = regs.to(torch.int16)
    return out, err.to(torch.int32)


def decode_segments(words: torch.Tensor, side: torch.Tensor,
                    tables: torch.Tensor, R: int,
                    comp_map: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """Huffman-decode S segments: words [W, S] int32 (uint32 bits), side
    [6, S] int32, tables from `huffman_tables` → (coefficients
    [R*bpm, 64, S] int16 zigzag, err [S] int32). A CPU tensor takes the
    plain version; a CUDA tensor launches K2 (csrc/huffman.cu) or raises."""
    if words.device.type == "cpu":
        return decode_segments_plain(words, side, tables, R, comp_map)
    if words.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {words.device}")
    W, S = words.shape
    dev = words.device
    for name, t, shape in (("words", words, (W, S)), ("side", side, (6, S))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"K2: {name} must be contiguous int32 {shape} "
                             f"on {dev}")
    ncomp = tables.shape[0]
    nv = tables.shape[-1] - TAB_HEADER
    if (tables.dtype != torch.int32 or tables.dim() != 3
            or tables.shape[1] != 2 or tables.device != dev
            or not tables.is_contiguous()):
        raise ValueError("K2: tables must be contiguous int32 "
                         "[ncomp, 2, 34 + nv] on the words' device")
    if tables.numel() * 4 > 48 * 1024:
        raise ValueError("K2: Huffman tables exceed the shared-memory budget")
    bpm = len(comp_map)
    out = torch.empty((R * bpm, 64, S), dtype=torch.int16, device=dev)
    err = torch.empty((S,), dtype=torch.int32, device=dev)
    cmap = np.asarray(comp_map, np.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.lib().tic_huffman_decode(
        words.data_ptr(), W, S, side.data_ptr(), tables.data_ptr(), ncomp, nv,
        cmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bpm, R, out.data_ptr(), err.data_ptr(), stream)
    _build.check(rc, "K2 huffman launch")
    decode_segments.launches += 1
    return out, err


decode_segments.launches = 0


# K3: progressive Huffman decode of one scan, one restart segment per lane.
#
# `decode_prog_scan` replaces the Pallas kernel of
# nvimagecodec_tpu/ops/pallas_entropy.py (`_build_prog_kernel`) with the same
# inputs and outputs. Four kinds: "dc" (first DC scan, interleaved), "dcref"
# (DC refinement, one raw bit per block), "ac" (first AC band scan of one
# component) and "acref" (AC refinement, T.81 G.1.2.3, which reads the
# current band). A CUDA tensor goes to csrc/prog_huffman.cu; a CPU tensor to
# `decode_prog_scan_plain`.

PROG_KINDS = ("dc", "dcref", "ac", "acref")


def _canonical(t) -> np.ndarray:
    """One HuffTable → int32 [34 + len(values)]: maxcode[17], base[17]
    (sym index = code + base[len]), values."""
    out = np.zeros(TAB_HEADER + len(t.values), np.int32)
    out[:17] = -1
    code = k = 0
    for ln in range(1, 17):
        n = t.bits[ln - 1]
        out[17 + ln] = k - code
        code += n
        k += n
        if n:
            out[ln] = code - 1
        code <<= 1
    out[TAB_HEADER:] = t.values
    return out


def prog_scan_tables(frame, scan) -> np.ndarray:
    """The scan's own Huffman table snapshot (progressive streams may
    redefine tables between scans) as int32 [ncomp, 34 + nv], values zero
    padded to nv: one row per frame component for a first DC scan, one row
    for an AC scan, and a placeholder row (no codes) for DC refinement,
    which reads no table."""
    if scan.ss == 0 and scan.ah != 0:
        rows = [np.concatenate([np.full(17, -1, np.int32),
                                np.zeros(18, np.int32)])]
    elif scan.ss == 0:
        rows = [_canonical(scan.dc_huff[scan.dc_tables[ci]])
                for ci in range(len(frame.components))]
    else:
        rows = [_canonical(scan.ac_huff[scan.ac_tables[0]])]
    width = max(TAB_HEADER + 1, max(len(r) for r in rows))
    out = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def prog_scan_kind(scan) -> str:
    """The K3 kind that decodes `scan`."""
    if scan.ss == 0:
        return "dcref" if scan.ah else "dc"
    return "acref" if scan.ah else "ac"


def decode_prog_scan_plain(kind: str, words: torch.Tensor, side: torch.Tensor,
                           tables: torch.Tensor, R: int, bpm: int,
                           comp_map: tuple, ss: int, se: int, al: int,
                           band_in=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch; same contract as `decode_prog_scan`. Lanes
    advance together, one masked step per iteration, and every lane's
    state carries from one unit to the next as in the TPU kernel."""
    W, S = words.shape
    dev = words.device
    i64 = torch.int64
    dc = kind in ("dc", "dcref")
    nblk = R * bpm if dc else R
    w = _padded_words(words)
    lanes = torch.arange(S, device=dev)
    nunits = side[0].to(i64)
    pos = side[1].to(i64).clone()
    pred = side[2:6].to(i64).clone()
    eob = torch.zeros(S, dtype=i64, device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    out = torch.empty((nblk, 1 if dc else 64, S), dtype=torch.int16,
                      device=dev)
    tab = tables.to(dev, i64)
    p1 = 1 << al
    zero = torch.zeros(S, dtype=i64, device=dev)

    for j in range(nblk):
        active = nunits > (j // bpm if dc else j)
        if kind == "dc":
            p32 = _peek32(w, lanes, pos)
            ci = comp_map[j % bpm]
            found, ln, t = _huff_decode(p32, tab[ci])
            ok = active & found & (t <= 15)
            err |= active & ~ok
            ln = torch.where(ok, ln, 0)
            t = torch.where(ok, t, 0)
            diff = _extend(_take(p32, ln, t), t)
            pred[ci] = torch.where(ok, pred[ci] + diff, pred[ci])
            out[j, 0] = torch.where(ok, pred[ci] << al, 0).to(torch.int16)
            pos += ln + t
            continue
        if kind == "dcref":
            p32 = _peek32(w, lanes, pos)
            out[j, 0] = torch.where(active, (p32 >> 31) << al,
                                    0).to(torch.int16)
            pos += active.to(i64)
            continue
        act = tab[0]
        k = torch.full_like(zero, ss)  # read only by active lanes
        if kind == "ac":
            regs = torch.zeros((64, S), dtype=i64, device=dev)
            skip = active & (eob > 0)
            eob = torch.where(skip, eob - 1, eob)
            pend = active & ~skip
            while bool(pend.any()):
                p32 = _peek32(w, lanes, pos)
                found, ln, sym = _huff_decode(p32, act)
                bad = pend & ~found
                g = pend & found
                run, size = sym >> 4, sym & 15
                eobn = g & (size == 0) & (run != 15)
                zrl = g & (size == 0) & (run == 15)
                kk = k + run
                over = g & (size != 0) & (kk > se)
                wr = g & (size != 0) & ~over
                ln = torch.where(g, ln, 0)
                nb = torch.where(eobn, run, torch.where(wr, size, 0))
                bits = _take(p32, ln, nb)
                eob = torch.where(eobn,
                                  (torch.ones_like(run) << run) - 1 + bits,
                                  eob)
                val = _extend(bits, torch.where(wr, size, 0)) << al
                regs[kk.clamp(0, 63)[wr], lanes[wr]] = val[wr]
                pos += ln + nb
                k = torch.where(zrl, k + 16, torch.where(wr, kk + 1, k))
                err |= bad | over
                pend &= ~(bad | over | eobn | ((zrl | wr) & (k > se)))
        else:  # acref
            regs = band_in[j].to(dev, i64).clone()
            ineob = active & (eob > 0)
            rrem, sval = zero.clone(), zero.clone()
            pend = active.clone()
            while bool(pend.any()):
                p32 = _peek32(w, lanes, pos)
                # lanes with no run and no pending value decode a symbol
                need = pend & ~ineob & (rrem == 0) & (sval == 0)
                found, ln, sym = _huff_decode(p32, act)
                bad = need & ~found
                okn = need & found
                run, size = sym >> 4, sym & 15
                eobn = okn & (size == 0) & (run != 15)
                zrl = okn & (size == 0) & (run == 15)
                coded = okn & (size != 0)
                ln = torch.where(okn, ln, 0)
                nb = torch.where(eobn, run, coded.to(i64))
                bits = _take(p32, ln, nb)
                eob = torch.where(eobn, (torch.ones_like(run) << run) + bits,
                                  eob)
                ineob |= eobn
                sval = torch.where(coded, torch.where(bits != 0, p1, -p1),
                                   sval)
                rrem = torch.where(coded, run, torch.where(zrl, 16, rrem))
                err |= bad
                # the other lanes step one position
                step = pend & ~need & (k <= se)
                kw = k.clamp(0, 63)
                cur = regs[kw, lanes]
                nonzero = cur != 0
                corr = step & nonzero
                cbit = (p32 >> 31) & corr
                fix = corr & (cbit != 0) & ((cur & p1) == 0)
                new = cur + torch.where(fix, torch.where(cur >= 0, p1, -p1),
                                        0)
                # a zero-history position counts down the run, or takes
                # the pending value once the run is spent
                zstep = step & ~nonzero & ~ineob
                place = zstep & (rrem == 0) & (sval != 0)
                rrem = rrem - (zstep & (rrem > 0)).to(i64)
                new = torch.where(place, sval, new)
                regs[kw[step], lanes[step]] = new[step]
                sval = torch.where(place, 0, sval)
                k = k + step.to(i64)
                over = step & (k > se) & (sval != 0)
                err |= over
                sval = torch.where(over, 0, sval)
                pos += ln + nb + corr.to(i64)
                pend &= ~bad & ~(k > se)
            eob = torch.where(active & ineob, eob - 1, eob)
        out[j] = regs.to(torch.int16)
    return out, err.to(torch.int32)


def decode_prog_scan(kind: str, words: torch.Tensor, side: torch.Tensor,
                     tables: torch.Tensor, R: int, bpm: int, comp_map: tuple,
                     ss: int, se: int, al: int,
                     band_in=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Huffman-decode one progressive scan's S restart segments: words
    [W, S] int32 (uint32 bits), side [6, S] int32 (units per lane, start
    bit, DC seeds), tables from `prog_scan_tables` → (out [NBLK, OUTK, S]
    int16, err [S] int32). "dc"/"dcref": NBLK = R*bpm, OUTK = 1 (values,
    or bit << al to OR in). "ac"/"acref": NBLK = R, OUTK = 64 (zigzag rows
    ss..se filled; "acref" returns band_in [R, 64, S] int16 refined). A CPU
    tensor takes the plain version; a CUDA tensor launches K3
    (csrc/prog_huffman.cu) or raises."""
    if kind not in PROG_KINDS:
        raise ValueError(f"K3: unknown kind {kind!r}")
    if (band_in is not None) != (kind == "acref"):
        raise ValueError("K3: band_in is given for kind 'acref' and no other")
    if words.device.type == "cpu":
        return decode_prog_scan_plain(kind, words, side, tables, R, bpm,
                                      comp_map, ss, se, al, band_in)
    if words.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {words.device}")
    W, S = words.shape
    dev = words.device
    dc = kind in ("dc", "dcref")
    nblk = R * bpm if dc else R
    checks = [("words", words, (W, S), torch.int32),
              ("side", side, (6, S), torch.int32)]
    if band_in is not None:
        checks.append(("band_in", band_in, (R, 64, S), torch.int16))
    for name, t, shape, dtype in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"K3: {name} must be contiguous {dtype} {shape} "
                             f"on {dev}")
    if W < 2 or not 1 <= bpm <= 64 or len(comp_map) != bpm:
        raise ValueError("K3: needs W >= 2 and 1 <= bpm == len(comp_map) "
                         "<= 64")
    ntab = tables.shape[0]
    nv = tables.shape[-1] - TAB_HEADER
    if (tables.dtype != torch.int32 or tables.dim() != 2
            or not 1 <= ntab <= 4 or nv < 1 or tables.device != dev
            or not tables.is_contiguous()):
        raise ValueError("K3: tables must be contiguous int32 "
                         "[ncomp <= 4, 34 + nv] on the words' device")
    if tables.numel() * 4 > 48 * 1024:
        raise ValueError("K3: Huffman tables exceed the shared-memory budget")
    out = torch.empty((nblk, 1 if dc else 64, S), dtype=torch.int16,
                      device=dev)
    err = torch.empty((S,), dtype=torch.int32, device=dev)
    cmap = np.asarray(comp_map, np.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.lib().tic_prog_huffman_decode(
        PROG_KINDS.index(kind), words.data_ptr(), W, S, side.data_ptr(),
        tables.data_ptr(), ntab, nv,
        cmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), bpm, R, ss, se,
        al, band_in.data_ptr() if band_in is not None else None,
        out.data_ptr(), err.data_ptr(), stream)
    _build.check(rc, "K3 progressive huffman launch")
    decode_prog_scan.launches += 1
    return out, err


decode_prog_scan.launches = 0
