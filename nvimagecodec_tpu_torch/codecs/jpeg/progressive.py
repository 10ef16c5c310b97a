"""Progressive JPEG encoding (ITU-T T.81 Annex G) — spectral-selection scan
script with per-scan optimized Huffman tables.

Counterpart of the reference encoder's progressive option
(nvimgcodecJpegEncodeParams_t.progressive, include/nvimgcodec.h:702-714;
extensions/nvjpeg/cuda_encoder.cpp jpeg encoding select). Scan script:
one interleaved DC scan, then one full-band AC scan per component —
spectral selection only (Ah=Al=0), which libjpeg decodes and our own
progressive entropy decoder already handles.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .encode import (
    BitWriter,
    _csize,
    derive_encode_table,
    gen_optimal_table,
    mcu_block_order,
)
from .headers import HuffTable, JpegFrame
from .tables import ZIGZAG


def _dc_symbols(frame: JpegFrame, zz: List[np.ndarray]):
    """(symbol stream for the interleaved DC scan) → per-class counts."""
    order = mcu_block_order(frame)
    pred = [0] * len(frame.components)
    syms = []  # (table_class, ssss, diffbits)
    for ci, bidx in order:
        comp = frame.components[ci]
        dc = int(zz[ci][bidx][0])
        diff = dc - pred[ci]
        pred[ci] = dc
        s = _csize(diff)
        syms.append((comp.dc_tbl, s, diff))
    return syms


def _ac_scan_symbols(blocks: np.ndarray):
    """Symbols for one component's full-band AC scan (Ss=1, Se=63, no
    successive approximation): run/size, ZRL, and EOBn run coding
    (T.81 G.1.2.2). Returns [(sym, extra_value, extra_bits)]."""
    syms: List[Tuple[int, int, int]] = []
    eobrun = 0

    def flush_eob():
        # one EOBn symbol codes the whole run: r = floor(log2(run)), then r
        # extension bits for run - 2^r (run capped at 0x7FFF so r <= 14)
        nonlocal eobrun
        if eobrun > 0:
            r = eobrun.bit_length() - 1
            syms.append((r << 4, eobrun - (1 << r), r))
            eobrun = 0

    for b in range(blocks.shape[0]):
        block = blocks[b]
        nz = np.nonzero(block[1:])[0]
        if len(nz) == 0:
            eobrun += 1
            if eobrun == 0x7FFF:
                flush_eob()
            continue
        flush_eob()
        run = 0
        k = 1
        last = int(nz[-1]) + 1
        while k <= last:
            v = int(block[k])
            if v == 0:
                run += 1
                k += 1
                continue
            while run > 15:
                syms.append((0xF0, 0, 0))
                run -= 16
            s = _csize(v)
            syms.append(((run << 4) | s, v if v >= 0 else v + (1 << s) - 1, s))
            run = 0
            k += 1
        if last < 64:
            eobrun += 1
            if eobrun == 0x7FFF:
                flush_eob()
    flush_eob()
    return syms


def _count_from_syms(syms, idx) -> np.ndarray:
    counts = np.zeros(256, np.int64)
    for t in syms:
        counts[t[idx]] += 1
    return counts


def encode_progressive(frame: JpegFrame, coefs: Sequence[np.ndarray]):
    """Returns [(scan_params, dht_bytes_map, entropy_bytes)] where
    scan_params = (comp_indices, ss, se, dc_or_ac_table_ids)."""
    ncomp = len(frame.components)
    zz = [np.ascontiguousarray(c.reshape(-1, 64)[:, ZIGZAG]) for c in coefs]

    scans = []

    # --- scan 1: interleaved DC, optimized tables per class ---------------
    dc_syms = _dc_symbols(frame, zz)
    counts: Dict[int, np.ndarray] = {}
    for cls, s, _ in dc_syms:
        counts.setdefault(cls, np.zeros(256, np.int64))[s] += 1
    dc_tables = {cls: gen_optimal_table(f) for cls, f in counts.items()}
    enc = {cls: derive_encode_table(t) for cls, t in dc_tables.items()}
    bw = BitWriter()
    for cls, s, diff in dc_syms:
        co, si = enc[cls]
        bw.put(int(co[s]), int(si[s]))
        if s:
            bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
    bw.flush()
    scans.append((
        (list(range(ncomp)), 0, 0, [c.dc_tbl for c in frame.components], True),
        {("dc", cls): t for cls, t in dc_tables.items()},
        bytes(bw.out),
    ))

    # --- one AC scan per component (non-interleaved, true block raster) ---
    for ci, comp in enumerate(frame.components):
        tb_w, tb_h = frame.comp_true_blocks(comp)
        bh, bw_ = coefs[ci].shape[0], coefs[ci].shape[1]
        # non-interleaved scans cover the true block grid, not MCU padding
        grid = zz[ci].reshape(bh, bw_, 64)[:tb_h, :tb_w].reshape(-1, 64)
        syms = _ac_scan_symbols(grid)
        counts_ac = _count_from_syms(syms, 0)
        if counts_ac.sum() == 0:
            counts_ac[0] = 1  # degenerate all-zero scan still needs a table
        table = gen_optimal_table(counts_ac)
        co, si = derive_encode_table(table)
        w = BitWriter()
        for sym, extra, nbits in syms:
            w.put(int(co[sym]), int(si[sym]))
            if nbits:
                w.put(extra, nbits)
        w.flush()
        scans.append((
            ([ci], 1, 63, [0], False),
            {("ac", 0): table},
            bytes(w.out),
        ))
    return scans


def write_progressive_jpeg(frame: JpegFrame, scans) -> bytes:
    """Assemble SOF2 + per-scan DHT/SOS segments."""

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = bytearray(b"\xff\xd8")
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq, q in sorted(frame.quant.items()):
        zzq = np.asarray(q)[ZIGZAG].astype(np.uint8)
        out += seg(0xDB, bytes([tq]) + zzq.tobytes())
    sof = bytes([frame.precision]) + frame.height.to_bytes(2, "big") + \
        frame.width.to_bytes(2, "big") + bytes([len(frame.components)])
    for c in frame.components:
        sof += bytes([c.comp_id, (c.h << 4) | c.v, c.tq])
    out += seg(0xC2, sof)

    for (comp_idx, ss, se, tbl_ids, is_dc), tables, entropy in scans:
        for (kind, tid), t in tables.items():
            tc = 0 if kind == "dc" else 1
            out += seg(0xC4, bytes([(tc << 4) | tid]) + bytes(t.bits) + bytes(t.values))
        sos = bytes([len(comp_idx)])
        for j, ci in enumerate(comp_idx):
            comp = frame.components[ci]
            td_ta = (tbl_ids[j] << 4) if is_dc else tbl_ids[j]
            sos += bytes([comp.comp_id, td_ta])
        sos += bytes([ss, se, 0])
        out += seg(0xDA, sos)
        out += entropy
    out += b"\xff\xd9"
    return bytes(out)


def encode_jpeg_progressive(frame: JpegFrame, coefs) -> bytes:
    for i, c in enumerate(frame.components):
        c.dc_tbl = c.ac_tbl = 0 if i == 0 else 1
    scans = encode_progressive(frame, coefs)
    return write_progressive_jpeg(frame, scans)
