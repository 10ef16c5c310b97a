"""K2 (baseline) and K3 (progressive) JPEG Huffman decode, one segment per
lane, stored where the pixel stage reads it.

`decode_segments_into` replaces the Pallas kernel of
nvimagecodec_tpu/ops/pallas_entropy.py (`_build_kernel`) and the reassembly
behind it: words [W, S] (uint32 bits, held as int32), side [6, S] int32 →
per-component zigzag stacks [B, bh, bw, 64] int16 and err [S] int32. A CUDA
tensor goes to the hand-written kernel in csrc/huffman.cu; a CPU tensor goes
to `decode_segments_into_plain`: `decode_segments_plain` (the TPU kernel's
contract, [R*bpm, 64, S], in plain PyTorch, vectorised over lanes with one
symbol step per iteration), then `reassemble_components`, then a copy.

`decode_prog_scan_into` does the same for one progressive scan, in place on
the stream's coefficient planes, and replaces `_build_prog_kernel` with the
gather before it and the scatter after it (csrc/prog_huffman.cu; plain
version `decode_prog_scan_into_plain` around `decode_prog_scan_plain`).

`huffman_tables` turns the numpy table form of `entropy_kernel_spec`
(maxcode/base/values per component) into the int32 table tensor both K2
versions read; `prog_scan_tables` builds K3's from a scan's own table
snapshot; `lookahead_tables` builds the kernels' lookahead rows from either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

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
    """The TPU kernel's contract in plain PyTorch: words [W, S], side
    [6, S], tables [ncomp, 2, 34 + nv] → (coefficients [R*bpm, 64, S]
    int16 zigzag, lane-major, block mcu*bpm+b; err [S] int32)."""
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


# Lookahead rows. L = 9 bits: a row is 1 KB, so K2's rows (two a component)
# and a CTA's staged blocks stay far below the 48 KB a CTA gets without
# asking. On an H100, K2 took 0.435 / 0.434 / 0.423 / 0.419 / 0.421 ms at
# L = 7 / 8 / 9 / 10 / 11 (tools/bench_entropy.py --sweep): flat from 9 on.
LOOK_BITS = 9

_LOOK_CACHE: dict = {}


def lookahead_tables(tables: np.ndarray, L: int = LOOK_BITS) -> np.ndarray:
    """Lookahead rows for canonical table rows [..., 34 + nv] (K2's
    [ncomp, 2, 34 + nv] or K3's [ntab, 34 + nv]) → int16 [rows, 1 << L].
    Entry p is (len << 8) | symbol when the L-bit prefix p starts with a
    code of len <= L bits, and 0 (escape: the kernel walks the canonical
    row) when its code is longer or missing. Built by running the canonical
    walk — the first length l whose l-bit prefix is <= maxcode[l], value
    index code + base[l], an index outside [0, nv) reading 0 — on every
    prefix, so the kernels' two decodes agree by construction. Cached by
    content."""
    if not 1 <= L <= 12:
        raise ValueError("lookahead tables: 1 <= L <= 12")
    rows = np.ascontiguousarray(tables, np.int32).reshape(
        -1, tables.shape[-1])
    key = (L, rows.shape, rows.tobytes())
    hit = _LOOK_CACHE.get(key)
    if hit is not None:
        return hit
    nv = rows.shape[1] - TAB_HEADER
    prefix = np.arange(1 << L, dtype=np.int64)
    out = np.zeros((rows.shape[0], 1 << L), np.int16)
    for r, row in enumerate(rows):
        row = row.astype(np.int64)
        found = np.zeros(1 << L, bool)
        for ln in range(1, L + 1):
            code = prefix >> (L - ln)
            hit_l = ~found & (code <= row[ln])
            idx = code + row[17 + ln]
            inside = (idx >= 0) & (idx < nv)
            sym = np.where(inside, row[TAB_HEADER + np.clip(idx, 0, nv - 1)],
                           0)
            if hit_l.any() and (sym[hit_l].max() > 255
                                or sym[hit_l].min() < 0):
                raise ValueError("lookahead tables: symbol outside a byte")
            out[r, hit_l] = ((ln << 8) | sym[hit_l]).astype(np.int16)
            found |= hit_l
    if len(_LOOK_CACHE) > 4096:
        _LOOK_CACHE.clear()
    _LOOK_CACHE[key] = out
    return out


def comp_map_of(hv) -> tuple:
    """The component of each block of an MCU, for (h, v) per component."""
    return tuple(ci for ci, (h, v) in enumerate(hv) for _ in range(h * v))


def reassemble_components(out: torch.Tensor, hv, mcus_x: int, mcus_y: int,
                          B: int, nsegs: int, R: int) -> List[torch.Tensor]:
    """[R*bpm, 64, S] lane-major output of `decode_segments_plain` →
    per-component [B, mcus_y*v, mcus_x*h, 64] zigzag views (strided; each
    segment is R // mcus_x whole MCU rows, and the rows a short last
    segment pads are dropped)."""
    rows_per_seg = R // mcus_x
    bpm = sum(h * v for h, v in hv)
    S = out.shape[2]
    x = out.reshape(rows_per_seg, mcus_x, bpm, 64, S)[..., :B * nsegs]
    x = x.reshape(rows_per_seg, mcus_x, bpm, 64, B, nsegs)
    coefs = []
    off = 0
    for h, v in hv:
        xc = x[:, :, off:off + h * v]  # [rps, mx, v*h, 64, B, nsegs]
        off += h * v
        xc = xc.reshape(rows_per_seg, mcus_x, v, h, 64, B, nsegs)
        # → [B, nsegs, rps, v, mx, h, 64]
        xc = xc.permute(5, 6, 0, 2, 1, 3, 4)
        xc = xc.reshape(B, nsegs * rows_per_seg * v, mcus_x * h, 64)
        coefs.append(xc[:, :mcus_y * v])
    return coefs


def decode_segments_into_plain(words, side, tables, R: int, hv, mcus_x: int,
                               mcus_y: int, B: int, nsegs: int):
    """K2 in plain PyTorch; same contract as `decode_segments_into`: the
    TPU kernel's lane-major decode, its reassembly, and the copy that made
    the stacks contiguous."""
    out, err = decode_segments_plain(words, side, tables, R, comp_map_of(hv))
    views = reassemble_components(out, hv, mcus_x, mcus_y, B, nsegs, R)
    return [v.contiguous() for v in views], err


# K2's launch shape: lanes a warp (the other threads of the warp help their
# lane move its blocks) and warps a CTA. On an H100, 6144 lanes took 0.61 /
# 0.42 / 0.46 / 0.52 / 0.79 / 1.07 ms at 1 / 2 / 4 / 8 / 16 / 32 lanes a
# warp, 8 warps a CTA (tools/bench_entropy.py --sweep): one lane a warp is
# bound by instruction issue (6144 warps), many lanes a warp by every lane
# waiting at each block's end for the warp's slowest.
K2_LANES_PER_WARP = 2
K2_WARPS = 8

_SMEM_BUDGET = 48 * 1024
_BLK_BYTES = 144  # a staged block in shared memory (csrc/huffman_common.cuh)


def _check_lane_inputs(name, words, side, tables, look, tab_dim):
    """Shape, type and device checks shared by K2 and K3."""
    W, S = words.shape
    dev = words.device
    for what, t, shape in (("words", words, (W, S)), ("side", side, (6, S))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be contiguous int32 "
                             f"{shape} on {dev}")
    if (tables.dtype != torch.int32 or tables.dim() != tab_dim
            or tables.shape[-1] <= TAB_HEADER or tables.device != dev
            or not tables.is_contiguous()):
        raise ValueError(f"{name}: tables must be contiguous int32 "
                         f"[..., 34 + nv] of {tab_dim} axes on the words' "
                         "device")
    rows = tables.numel() // tables.shape[-1]
    L = look.shape[-1].bit_length() - 1 if look.dim() == 2 else 0
    if (look.dtype != torch.int16 or look.dim() != 2
            or tuple(look.shape) != (rows, 1 << L) or not 1 <= L <= 12
            or look.device != dev or not look.is_contiguous()):
        raise ValueError(f"{name}: look must be contiguous int16 "
                         f"[{rows}, 1 << L] on the words' device")
    if W < 2:
        raise ValueError(f"{name}: needs W >= 2")
    return L


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _i32_array(values):
    return (ctypes.c_int32 * len(values))(*values)


def decode_segments_into(words: torch.Tensor, side: torch.Tensor,
                         tables: torch.Tensor, look: torch.Tensor, R: int,
                         hv, mcus_x: int, mcus_y: int, B: int,
                         nsegs: int) -> Tuple[List[torch.Tensor],
                                              torch.Tensor]:
    """Huffman-decode a bucket of B images, nsegs segments of R MCUs (whole
    MCU rows) each, lane b*nsegs + k being segment k of image b: words
    [W, S] int32 (uint32 bits), side [6, S] int32, tables from
    `huffman_tables`, look from `lookahead_tables`, hv the (h, v) sampling
    factors per component → (per-component zigzag stacks
    [B, mcus_y*v, mcus_x*h, 64] int16, contiguous, as the IDCT kernel
    takes them; err [S] int32). A CPU tensor takes the plain version; a
    CUDA tensor launches K2 (csrc/huffman.cu) or raises."""
    hv = tuple((int(h), int(v)) for h, v in hv)
    L = _check_lane_inputs("K2", words, side, tables, look, 3)
    W, S = words.shape
    if (not 1 <= len(hv) <= 4 or tables.shape[0] != len(hv)
            or tables.shape[1] != 2
            or any(not (1 <= h <= 4 and 1 <= v <= 4) for h, v in hv)):
        raise ValueError("K2: 1-4 components with h, v in 1..4 and tables "
                         "[ncomp, 2, 34 + nv]")
    if (mcus_x < 1 or mcus_y < 1 or R < 1 or R % mcus_x or nsegs < 1
            or B < 0 or B * nsegs > S or nsegs * (R // mcus_x) < mcus_y):
        raise ValueError("K2: needs segments of whole MCU rows that cover "
                         "the image, and B * nsegs <= S")
    if words.device.type == "cpu":
        return decode_segments_into_plain(words, side, tables, R, hv, mcus_x,
                                          mcus_y, B, nsegs)
    if words.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {words.device}")
    dev = words.device
    lpw, warps = K2_LANES_PER_WARP, K2_WARPS
    if (tables.numel() * 4 + look.numel() * 2
            + lpw * warps * _BLK_BYTES > _SMEM_BUDGET):
        raise ValueError("K2: Huffman tables exceed the shared-memory budget")
    stacks = [torch.empty((B, mcus_y * v, mcus_x * h, 64), dtype=torch.int16,
                          device=dev) for h, v in hv]
    err = torch.empty((S,), dtype=torch.int32, device=dev)
    # the C entry point launches on the runtime's current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.lib().tic_huffman_decode_into(
            words.data_ptr(), W, S, side.data_ptr(), tables.data_ptr(),
            len(hv), tables.shape[-1] - TAB_HEADER, look.data_ptr(), L,
            _i32_array([x for pair in hv for x in pair]), mcus_x,
            mcus_y, R, B, nsegs, _ptr_array(stacks), err.data_ptr(), lpw,
            warps, stream)
    _build.check(rc, "K2 huffman launch")
    _build.count_launch(decode_segments_into)
    return stacks, err


decode_segments_into.launches = 0

# K3: progressive Huffman decode of one scan, one restart segment per lane.
#
# `decode_prog_scan_into` replaces the Pallas kernel of
# nvimagecodec_tpu/ops/pallas_entropy.py (`_build_prog_kernel`) and the
# gather and scatter around it. Four kinds: "dc" (first DC scan,
# interleaved), "dcref" (DC refinement, one raw bit per block), "ac" (first
# AC band scan of one component) and "acref" (AC refinement, T.81 G.1.2.3,
# which reads the current band). A CUDA tensor goes to
# csrc/prog_huffman.cu; a CPU tensor to `decode_prog_scan_into_plain`, which
# is built on `decode_prog_scan_plain`, the TPU kernel's own contract.

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
    """The TPU kernel's contract in plain PyTorch: → (out [NBLK, OUTK, S]
    int16, err [S] int32). "dc"/"dcref": NBLK = R*bpm, OUTK = 1 (values,
    or bit << al to OR in). "ac"/"acref": NBLK = R, OUTK = 64 (zigzag rows
    ss..se filled; "acref" returns band_in [R, 64, S] int16 refined).
    Lanes advance together, one masked step per iteration, and every
    lane's state carries from one unit to the next as in the TPU kernel."""
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


@functools.lru_cache(maxsize=64)
def _dc_index(mcus_x: int, mcus_y: int, hv: tuple, R: int, S: int,
              device: torch.device):
    """Per component, [mcus_y*v, mcus_x*h] indices into a DC scan's
    flattened [R*bpm, S] output: block (row, col) is block b of MCU g, the
    unit g % R of lane g // R."""
    bpm = sum(h * v for h, v in hv)
    maps = []
    off = 0
    for h, v in hv:
        r = np.arange(mcus_y * v)[:, None]
        q = np.arange(mcus_x * h)[None, :]
        g = (r // v) * mcus_x + q // h
        b = off + (r % v) * h + q % h
        maps.append(torch.from_numpy((g % R * bpm + b) * S + g // R)
                    .to(device))
        off += h * v
    return tuple(maps)


@functools.lru_cache(maxsize=64)
def _ac_index(cbw: int, cbh: int, R: int, S: int, device: torch.device):
    """(gather, band) for an AC scan over a cbh x cbw block grid: gather
    [cbh*cbw] indexes the [R*S] (unit, lane) rows of the output, block g
    being unit g % R of lane g // R; band [R, S] is the block each
    (unit, lane) holds, or cbh*cbw (a zero row) past the last block."""
    units = cbw * cbh
    g = np.arange(units)
    gather = torch.from_numpy(g % R * S + g // R).to(device)
    band = np.arange(R)[:, None] + np.arange(S)[None, :] * R
    band = torch.from_numpy(np.minimum(band, units)).to(device)
    return gather, band


def decode_prog_scan_into_plain(kind: str, words, side, tables, planes,
                                R: int, hv, mcus_x: int, comp: int, grid,
                                ss: int, se: int, al: int) -> torch.Tensor:
    """K3 in plain PyTorch; same contract as `decode_prog_scan_into`: the
    TPU kernel's lane-major decode (`decode_prog_scan_plain`) between the
    gather of the band and the scatter into the planes."""
    S = words.shape[1]
    dev = words.device
    if kind in ("dc", "dcref"):
        mcus_y = planes[0].shape[0] // hv[0][1]
        cmap = comp_map_of(hv)
        out, err = decode_prog_scan_plain(kind, words, side, tables, R,
                                          len(cmap), cmap, ss, se, al)
        flat = out.reshape(-1)
        for plane, idx in zip(planes, _dc_index(mcus_x, mcus_y, tuple(hv), R,
                                                S, dev)):
            if kind == "dc":
                plane[..., 0] = flat[idx]
            else:  # refinement: OR bit << al (T.81 G.1.2.1)
                plane[..., 0] |= flat[idx]
        return err
    cbw, cbh = grid
    units = cbw * cbh
    gather, band = _ac_index(cbw, cbh, R, S, dev)
    band_in = None
    if kind == "acref":
        cur = planes[comp][:cbh, :cbw].reshape(units, 64)
        cur = torch.cat([cur, cur.new_zeros((1, 64))])
        band_in = cur[band].permute(0, 2, 1).contiguous()
    out, err = decode_prog_scan_plain(kind, words, side, tables, R, 1, (0,),
                                      ss, se, al, band_in)
    n = se - ss + 1
    rows = out[:, ss:se + 1].permute(0, 2, 1)
    planes[comp][:cbh, :cbw, ss:se + 1] = (
        rows.reshape(-1, n)[gather].reshape(cbh, cbw, n))
    return err


# K3's launch shape: a scan has few lanes, so a warp serves one and the scan
# spreads over as many SMs as it has segments. Warps a CTA: the 10 scans of
# a 375x500 stream took 0.243 / 0.232 / 0.226 / 0.234 ms at 1 / 2 / 4 / 8 on
# an H100 (tools/bench_entropy.py --sweep).
K3_WARPS = 4


def decode_prog_scan_into(kind: str, words: torch.Tensor, side: torch.Tensor,
                          tables: torch.Tensor, look: torch.Tensor, planes,
                          R: int, hv, mcus_x: int, comp: int, grid, ss: int,
                          se: int, al: int) -> torch.Tensor:
    """Huffman-decode one progressive scan's restart segments (R units a
    lane; lane s holds units s*R on) in place on `planes`, the stream's
    per-component zigzag planes [mcus_y*v, mcus_x*h, 64] int16 (contiguous,
    padded MCU grid): words [W, S] int32 (uint32 bits), side [6, S] int32
    (units per lane, start bit, DC seeds), tables from `prog_scan_tables`,
    look from `lookahead_tables`, hv the (h, v) per component → err [S]
    int32.

    "dc": unit = MCU of the interleaved grid, coefficient 0 of its blocks
    := value; "dcref": coefficient 0 |= bit << al. `comp` and `grid` are
    not read. "ac"/"acref": unit = block of component `comp`'s true block
    grid, grid = (cbw, cbh); positions ss..se of the block are set, or
    refined. A unit of the grid that its lane does not decode (past
    side[0, s]) is zeroed by "dc" and "ac" and left as it is by the
    refinements. A CPU tensor takes the plain version; a CUDA tensor
    launches K3 (csrc/prog_huffman.cu) or raises."""
    if kind not in PROG_KINDS:
        raise ValueError(f"K3: unknown kind {kind!r}")
    dc = kind in ("dc", "dcref")
    hv = tuple((int(h), int(v)) for h, v in hv)
    L = _check_lane_inputs("K3", words, side, tables, look, 2)
    W, S = words.shape
    dev = words.device
    planes = list(planes)
    if (not 1 <= len(hv) <= 4 or len(planes) != len(hv)
            or any(not (1 <= h <= 4 and 1 <= v <= 4) for h, v in hv)):
        raise ValueError("K3: 1-4 components with h, v in 1..4, a plane each")
    if (not 0 <= ss <= se <= 63 or dc != (ss == 0) or not 0 <= al <= 15
            or R < 1 or mcus_x < 1 or not 1 <= tables.shape[0] <= 4):
        raise ValueError("K3: bad band, shift, interval or table count")
    mcus_y = planes[0].shape[0] // hv[0][1] if planes[0].dim() == 3 else 0
    for p, (h, v) in zip(planes, hv):
        if (p.dtype != torch.int16 or p.device != dev
                or tuple(p.shape) != (mcus_y * v, mcus_x * h, 64)
                or not p.is_contiguous()):
            raise ValueError("K3: planes must be contiguous int16 "
                             "[mcus_y*v, mcus_x*h, 64] on the words' device")
    if dc:
        if kind == "dc" and tables.shape[0] < len(hv):
            raise ValueError("K3: a DC scan needs a table row a component")
        width, units = mcus_x, mcus_x * mcus_y
    else:
        cbw, cbh = grid
        if (not 0 <= comp < len(hv) or not 1 <= cbw <= planes[comp].shape[1]
                or not 1 <= cbh <= planes[comp].shape[0]):
            raise ValueError("K3: the block grid must lie inside its plane")
        width, units = cbw, cbw * cbh
    if units > S * R:
        raise ValueError("K3: the scan's units exceed S lanes of R")
    if dev.type == "cpu":
        return decode_prog_scan_into_plain(kind, words, side, tables, planes,
                                           R, hv, mcus_x, comp, grid, ss, se,
                                           al)
    if dev.type != "cuda":
        raise ValueError(f"K3: unsupported device {dev}")
    warps = K3_WARPS
    if (tables.numel() * 4 + look.numel() * 2
            + warps * 128 > _SMEM_BUDGET):  # and a warp's staged words
        raise ValueError("K3: Huffman tables exceed the shared-memory budget")
    mine = planes if dc else [planes[comp]]
    hv_p = _i32_array([x for pair in (hv if dc else [(1, 1)]) for x in pair])
    cols_p = _i32_array([p.shape[1] for p in mine])
    err = torch.empty((S,), dtype=torch.int32, device=dev)
    # the C entry point launches on the runtime's current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.lib().tic_prog_huffman_decode_into(
            PROG_KINDS.index(kind), words.data_ptr(), W, S, side.data_ptr(),
            tables.data_ptr(), tables.shape[0], tables.shape[-1] - TAB_HEADER,
            look.data_ptr(), L, len(mine), hv_p, cols_p, _ptr_array(mine),
            width, units, R, ss, se, al, err.data_ptr(), warps, stream)
    _build.check(rc, "K3 progressive huffman launch")
    _build.count_launch(decode_prog_scan_into)
    return err


decode_prog_scan_into.launches = 0
