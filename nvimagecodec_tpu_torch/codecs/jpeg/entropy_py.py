"""Reference (pure-Python) JPEG Huffman entropy decode.

Correctness anchor for the fast native path: decodes baseline/extended
sequential and progressive scans into per-component quantized DCT
coefficient blocks, bit-exact vs libjpeg's jpeg_read_coefficients (validated
in tests/test_jpeg_entropy.py).

This is the role the CPU Huffman host stage plays in the reference's hybrid
decoder (extensions/nvjpeg/cuda_decoder.cpp:412-563: nvjpegDecodeJpegHost on
CPU then GPU pixel stage); the port's host route keeps entropy on the host
the same way and ships coefficients to the GPU for dequant+IDCT+color.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .headers import JpegFrame, ScanInfo
from .tables import ZIGZAG

# zigzag index -> natural (row-major) position, as a plain list for fast
# scalar indexing in the hot loop (libjpeg stores blocks in natural order;
# we match so coefficients compare bit-exact against the oracle).
NAT = ZIGZAG.tolist()


class BitReader:
    """MSB-first bit reader over destuffed entropy-coded bytes."""

    __slots__ = ("data", "pos", "acc", "nbits", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self, need: int) -> None:
        while self.nbits < need:
            if self.pos < self.n:
                self.acc = (self.acc << 8) | self.data[self.pos]
                self.pos += 1
            else:
                self.acc = self.acc << 8  # pad with zeros past the end
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill(16)
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, k: int) -> None:
        self.nbits -= k
        self.acc &= (1 << self.nbits) - 1

    def get_bits(self, k: int) -> int:
        if k == 0:
            return 0
        if self.nbits < k:
            self._fill(k)
        v = (self.acc >> (self.nbits - k)) & ((1 << k) - 1)
        self.nbits -= k
        self.acc &= (1 << self.nbits) - 1
        return v

    def get_bit(self) -> int:
        return self.get_bits(1)


def extend(v: int, t: int) -> int:
    """T.81 F.2.2.1 EXTEND: map magnitude bits to signed value."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def split_restarts(data: bytes, start: int, end: int) -> List[bytes]:
    """Split the entropy span into restart segments and destuff each
    (0xFF00 → 0xFF; RSTn markers delimit segments)."""
    segs = []
    raw = data[start:end]
    # fast scan for 0xFF
    parts = []
    cur = bytearray()
    i, n = 0, len(raw)
    while i < n:
        b = raw[i]
        if b == 0xFF and i + 1 < n:
            nb = raw[i + 1]
            if nb == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nb <= 0xD7:
                parts.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            # other marker: end of data
            break
        cur.append(b)
        i += 1
    parts.append(bytes(cur))
    return parts


def _luts_for_scan(scan: ScanInfo):
    dc_luts = {}
    ac_luts = {}
    for t, tbl in scan.dc_huff.items():
        dc_luts[t] = tbl.build_lut()
    for t, tbl in scan.ac_huff.items():
        ac_luts[t] = tbl.build_lut()
    return dc_luts, ac_luts


def _decode_huff(br: BitReader, sym_lut: np.ndarray, len_lut: np.ndarray) -> int:
    idx = br.peek16()
    length = len_lut[idx]
    if length == 0:
        raise ValueError("invalid Huffman code")
    br.skip(int(length))
    return int(sym_lut[idx])


def alloc_coefficients(frame: JpegFrame) -> List[np.ndarray]:
    """Per-component (blocks_h, blocks_w, 64) int16 arrays covering the
    interleaved-MCU-padded grid (matches libjpeg's allocation)."""
    _, _, dims = frame.mcu_geometry()
    return [np.zeros((bh, bw, 64), np.int16) for (bw, bh) in dims]


def decode_scan(
    frame: JpegFrame,
    scan: ScanInfo,
    data: bytes,
    coefs: List[np.ndarray],
    eobrun_state: Dict[int, int] | None = None,
) -> None:
    """Decode one scan (sequential or progressive) into `coefs`."""
    if frame.is_progressive:
        _decode_scan_progressive(frame, scan, data, coefs)
    else:
        _decode_scan_sequential(frame, scan, data, coefs)


def _scan_mcu_layout(frame: JpegFrame, scan: ScanInfo):
    """Return (mcus_x, mcus_y, per-scan-component block coverage).

    Interleaved scans iterate MCUs of h×v blocks per component; a
    single-component scan iterates that component's true blocks one per MCU
    (T.81 A.2.3)."""
    if len(scan.comp_indices) > 1:
        mx, my, _ = frame.mcu_geometry()
        return mx, my, True
    ci = scan.comp_indices[0]
    c = frame.components[ci]
    bw, bh = frame.comp_true_blocks(c)
    return bw, bh, False


def _decode_scan_sequential(frame, scan, data, coefs) -> None:
    dc_luts, ac_luts = _luts_for_scan(scan)
    segments = split_restarts(data, scan.data_start, scan.data_end)
    mcus_x, mcus_y, interleaved = _scan_mcu_layout(frame, scan)
    total_mcus = mcus_x * mcus_y
    ri = scan.restart_interval or total_mcus
    pred = {ci: 0 for ci in scan.comp_indices}

    mcu = 0
    for seg in segments:
        br = BitReader(seg)
        for ci in pred:
            pred[ci] = 0
        seg_end = min(mcu + ri, total_mcus)
        while mcu < seg_end:
            my, mx = divmod(mcu, mcus_x)
            for k, ci in enumerate(scan.comp_indices):
                comp = frame.components[ci]
                dct = dc_luts[scan.dc_tables[k]]
                act = ac_luts[scan.ac_tables[k]]
                if interleaved:
                    nby, nbx = comp.v, comp.h
                else:
                    nby = nbx = 1
                for by in range(nby):
                    for bx in range(nbx):
                        if interleaved:
                            row = my * comp.v + by
                            col = mx * comp.h + bx
                        else:
                            row, col = my, mx
                        block = coefs[ci][row, col]
                        # DC
                        t = _decode_huff(br, *dct)
                        diff = extend(br.get_bits(t), t)
                        pred[ci] += diff
                        block[0] = pred[ci]
                        # AC
                        kk = 1
                        while kk < 64:
                            sym = _decode_huff(br, *act)
                            r, s = sym >> 4, sym & 0xF
                            if s == 0:
                                if r == 15:
                                    kk += 16
                                    continue
                                break  # EOB
                            kk += r
                            if kk > 63:
                                raise ValueError("AC index overflow")
                            block[NAT[kk]] = extend(br.get_bits(s), s)
                            kk += 1
            mcu += 1
        if mcu >= total_mcus:
            break


def _decode_scan_progressive(frame, scan, data, coefs) -> None:
    """T.81 G.2: progressive DC/AC first/refinement scans."""
    dc_luts, ac_luts = _luts_for_scan(scan)
    segments = split_restarts(data, scan.data_start, scan.data_end)
    mcus_x, mcus_y, interleaved = _scan_mcu_layout(frame, scan)
    total_mcus = mcus_x * mcus_y
    ri = scan.restart_interval or total_mcus
    pred = {ci: 0 for ci in scan.comp_indices}
    is_dc = scan.ss == 0

    mcu = 0
    eobrun = 0
    for seg in segments:
        br = BitReader(seg)
        for ci in pred:
            pred[ci] = 0
        eobrun = 0
        seg_end = min(mcu + ri, total_mcus)
        while mcu < seg_end:
            my, mx = divmod(mcu, mcus_x)
            for k, ci in enumerate(scan.comp_indices):
                comp = frame.components[ci]
                if interleaved:
                    nby, nbx = comp.v, comp.h
                else:
                    nby = nbx = 1
                for by in range(nby):
                    for bx in range(nbx):
                        if interleaved:
                            row = my * comp.v + by
                            col = mx * comp.h + bx
                        else:
                            row, col = my, mx
                        block = coefs[ci][row, col]
                        if is_dc:
                            if scan.ah == 0:  # DC first
                                dct = dc_luts[scan.dc_tables[k]]
                                t = _decode_huff(br, *dct)
                                diff = extend(br.get_bits(t), t)
                                pred[ci] += diff
                                block[0] = pred[ci] << scan.al
                            else:  # DC refinement
                                if br.get_bit():
                                    block[0] |= 1 << scan.al
                        else:
                            act = ac_luts[scan.ac_tables[k]]
                            if scan.ah == 0:
                                eobrun = _ac_first(
                                    br, block, scan, act, eobrun
                                )
                            else:
                                eobrun = _ac_refine(
                                    br, block, scan, act, eobrun
                                )
            mcu += 1
        if mcu >= total_mcus:
            break


def _ac_first(br, block, scan, act, eobrun) -> int:
    if eobrun > 0:
        return eobrun - 1
    kk = scan.ss
    while kk <= scan.se:
        sym = _decode_huff(br, *act)
        r, s = sym >> 4, sym & 0xF
        if s == 0:
            if r == 15:
                kk += 16
                continue
            eobrun = (1 << r) - 1
            if r:
                eobrun += br.get_bits(r)
            return eobrun
        kk += r
        if kk > scan.se:
            raise ValueError("AC index overflow (progressive)")
        block[NAT[kk]] = extend(br.get_bits(s), s) << scan.al
        kk += 1
    return 0


def _ac_refine(br, block, scan, act, eobrun) -> int:
    """T.81 G.2.4 AC refinement: corrections for already-nonzero coefs,
    insertion of newly significant ones."""
    p1 = 1 << scan.al
    m1 = -1 << scan.al
    kk = scan.ss
    if eobrun == 0:
        while kk <= scan.se:
            sym = _decode_huff(br, *act)
            r, s = sym >> 4, sym & 0xF
            if s == 0:
                if r != 15:
                    # full run count; current block's remaining corrections are
                    # consumed below and the run is then decremented by one
                    eobrun = 1 << r
                    if r:
                        eobrun += br.get_bits(r)
                    break
                # ZRL: skip 16 zero-history coefs, applying corrections
            else:
                s_val = p1 if br.get_bit() else m1
            # advance over r zero-history coefficients
            while kk <= scan.se:
                pos = NAT[kk]
                if block[pos] != 0:
                    if br.get_bit() and (block[pos] & p1) == 0:
                        block[pos] += p1 if block[pos] >= 0 else m1
                else:
                    if r == 0:
                        break
                    r -= 1
                kk += 1
            if s:
                if kk > scan.se:
                    raise ValueError("AC refine overflow")
                block[NAT[kk]] = s_val
            kk += 1
    if eobrun > 0:
        # remaining coefficients: corrections only
        while kk <= scan.se:
            pos = NAT[kk]
            if block[pos] != 0:
                if br.get_bit() and (block[pos] & p1) == 0:
                    block[pos] += p1 if block[pos] >= 0 else m1
            kk += 1
        eobrun -= 1
    return eobrun


def decode_coefficients(frame: JpegFrame, data: bytes) -> List[np.ndarray]:
    """Run all scans; return per-component coefficient blocks (natural
    order within each 64-vector)."""
    coefs = alloc_coefficients(frame)
    for scan in frame.scans:
        decode_scan(frame, scan, data, coefs)
    return coefs
