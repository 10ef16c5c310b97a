"""ctypes bridge to the native EBCOT Tier-1 coder (native/j2k_t1.cpp),
fanned over a thread pool per codeblock — the analog of the
reference's per-tile executor fan-out
(extensions/nvjpeg2k/cuda_decoder.cpp:601-640)."""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from ...core.trace import collecting
from ...native import lib
from ...ops import j2k_t1

# Shared thread budget across concurrently decoding images: when the
# Decoder's outer pool runs several J2K decodes at once, each batch gets
# cpu_count // active_jobs native workers instead of cpu_count each
# (prevents quadratic oversubscription; ADVICE r3).
_budget_lock = threading.Lock()
_active_batches = 0


class _ThreadBudget:
    """Context manager yielding this batch's fair share of CPU threads."""

    def __enter__(self) -> int:
        global _active_batches
        with _budget_lock:
            _active_batches += 1
            active = _active_batches
        ncpu = os.cpu_count() or 1
        return max(1, ncpu // active)

    def __exit__(self, *exc) -> None:
        global _active_batches
        with _budget_lock:
            _active_batches -= 1


def t1_decode(data: bytes, w: int, h: int, band: int, num_bps: int,
              num_passes: int) -> np.ndarray:
    """Decode one codeblock → signed int32 [h, w] (no dequant)."""
    L = lib()
    out = np.zeros((h, w), np.int32)
    rc = L.tic_j2k_t1_decode(
        data, len(data), w, h, band, num_bps, num_passes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"J2K T1 decode failed rc={rc}")
    return out


def ht_decode(cup: bytes, ref: bytes, num_passes: int, w: int, h: int,
              B: int, ucap: int) -> np.ndarray:
    """Decode one HT (T.814) codeblock → signed int32 [h, w] at plane 0
    (mid-bin reconstruction for truncated streams, matching openjpeg).
    B = Mb - zero_bitplanes; ucap = zero_bitplanes + 1."""
    L = lib()
    out = np.zeros((h, w), np.int32)
    rc = L.tic_ht_decode_block(
        cup, len(cup), ref if ref else None, len(ref or b""),
        num_passes, w, h, B, ucap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"HTJ2K block decode failed rc={rc}")
    return out


def ht_encode(coefs: np.ndarray,
              num_passes: int = 1) -> Tuple[bytes, bytes, int, int]:
    """Encode one codeblock of signed int32 with the HT (T.814) coder.
    Returns (cleanup_seg, refinement_seg, B, Umax): signal
    zero_bitplanes = Mb - B with Mb >= Umax + (B - 1)."""
    L = lib()
    h, w = coefs.shape
    coefs = np.ascontiguousarray(coefs, np.int32)
    cap = w * h * 8 + 4096
    out = np.zeros(cap, np.uint8)
    lcup = ctypes.c_int32()
    lref = ctypes.c_int32()
    B = ctypes.c_int32()
    umax = ctypes.c_int32()
    rc = L.tic_ht_encode_block(
        coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w, h,
        num_passes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(lcup), ctypes.byref(lref), ctypes.byref(B),
        ctypes.byref(umax),
    )
    if rc != 0:
        raise ValueError(f"HTJ2K block encode failed rc={rc}")
    return (bytes(out[:lcup.value].tobytes()),
            bytes(out[lcup.value:lcup.value + lref.value].tobytes()),
            B.value, umax.value)


def decode_rows_into(rows, tdata: bytes, nthreads: int = 0) -> int:
    """Decodes every block of a tile's rows (`t2.TileRows`, segment offsets
    counting from `tdata`, its side area after it) in ONE native call a
    kind (native/j2k_block_batch.cpp) with internal work-stealing threads,
    HT blocks first, each block written straight into its subband plane
    (a row's destination is an element offset of memory: the address over
    4); the planes must outlive the call. This replaces ~O(blocks) ctypes
    calls and Python futures (the host analog of nvjpeg2k's whole-tile
    batching, extensions/nvjpeg2k/cuda_decoder.cpp:601-640). Returns the
    CPU time (ns) of the native threads it started (the calling thread's
    not included), measured only while spans are collected (0
    otherwise)."""
    data = (tdata if not len(rows.side)
            else bytes(tdata) + rows.side.tobytes())
    cpu_ns = 0
    with _ThreadBudget() as fair:
        for kind, r, width in (("HT", rows.ht, 9),
                               ("T1", rows.t1, j2k_t1.META)):
            if len(r):
                cpu_ns += j2k_t1.decode_batch_into(
                    kind, data, r[:, :width], 0,
                    j2k_t1.row_dest(r[:, width + 1], r[:, width + 2]),
                    r[:, width], nthreads if nthreads > 0 else fair,
                    count_cpu=collecting())
    return cpu_ns


class EncodeBatch:
    """Encode-side twin of decode_rows_into: every code-block of a tile in
    one native call (tic_t1_encode_batch / tic_ht_encode_batch) with
    internal work-stealing threads. All-zero HT blocks are skipped here
    (they stay not-included, like the EBCOT path)."""

    def __init__(self, ht: bool, ht_passes: int = 1):
        self.ht = ht
        self.ht_passes = ht_passes
        self._seg = False  # any block coded with TERMALL/BYPASS (0x05)
        self._refs: list = []     # keeps block views (and bases) alive
        self._addrs: list = []
        self._strides: list = []  # row stride in ELEMENTS per block
        self._meta: list = []
        self._outs: list = []
        self._out_bytes = 0
        self._results: list = []  # (key, kind) kind: 0 batch idx, -1 zero

    def add(self, key, blk: np.ndarray, band_btype: int,
            min_bps: int = 0, style: int = 0) -> None:
        h, w = blk.shape
        if self.ht and not blk.any():
            self._results.append((key, -1, 0, 0))
            return
        # address-based: the native batch reads the strided block straight
        # out of the band array (rows memcpy'd in C), so no per-block
        # numpy copy/ravel/concatenate happens here
        if blk.dtype != np.int32 or blk.strides[1] != 4:
            blk = np.ascontiguousarray(blk, np.int32)
        self._refs.append(blk)
        self._addrs.append(blk.ctypes.data)
        self._strides.append(blk.strides[0] // 4)
        cap = w * h * 8 + 4096 if self.ht else w * h * 6 + 1024
        oo = self._out_bytes
        self._out_bytes += cap
        if self.ht:
            self._meta += [w, h, self.ht_passes, 0]
        else:
            if style & 0x05:
                self._seg = True
            self._meta += [w, h,
                           band_btype | (min_bps << 8) | (style << 16), 0]
        idx = len(self._outs) // 2
        self._outs += [oo, cap]
        self._results.append((key, idx, oo, cap))

    def run(self, nthreads: int = 0):
        """Yields (key, result) in add order — result is
        (cup, ref, B, umax) for HT or (seg, nbps, npasses) for EBCOT;
        when any block uses TERMALL/BYPASS the EBCOT result grows a 4th
        element: the list of cumulative codeword-segment end offsets."""
        L = lib()
        n = len(self._outs) // 2
        out = np.empty(self._out_bytes, np.uint8) if n else None
        res = np.zeros(((4 if self.ht else 3) * n,), np.int32)
        segres = (np.zeros(113 * n, np.int32)
                  if (self._seg and not self.ht and n) else None)
        if n:
            srcs = np.asarray(self._addrs, np.uint64)
            sstrides = np.asarray(self._strides, np.int64)
            meta = np.asarray(self._meta, np.int64)
            outs = np.asarray(self._outs, np.int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            srcp = srcs.ctypes.data_as(ctypes.POINTER(i32p))
            with _ThreadBudget() as fair:
                nt = nthreads if nthreads > 0 else fair
                if self.ht:
                    rc = L.tic_ht_encode_batch_addr(
                        n, srcp, sstrides.ctypes.data_as(i64p),
                        meta.ctypes.data_as(i64p),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        outs.ctypes.data_as(i64p),
                        res.ctypes.data_as(i32p), nt)
                else:
                    rc = L.tic_t1_encode_batch_addr(
                        n, srcp, sstrides.ctypes.data_as(i64p),
                        meta.ctypes.data_as(i64p),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        outs.ctypes.data_as(i64p),
                        res.ctypes.data_as(i32p),
                        segres.ctypes.data_as(i32p) if segres is not None
                        else None, nt)
            if rc != 0:
                raise ValueError(f"J2K block encode failed rc={rc}")
        for (key, idx, oo, cap) in self._results:
            if idx < 0:
                yield key, ((b"", b"", 1, 0) if self.ht else None)
                continue
            if self.ht:
                lcup, lref, B, umax = res[4 * idx:4 * idx + 4]
                seg = out[oo:oo + lcup + lref].tobytes()
                yield key, (seg[:lcup], seg[lcup:], int(B), int(umax))
            else:
                outlen, nbps, npasses = res[3 * idx:3 * idx + 3]
                data = out[oo:oo + outlen].tobytes()
                if segres is None:
                    yield key, (data, int(nbps), int(npasses))
                else:
                    ns = int(segres[113 * idx])
                    ends = [int(v) for v in
                            segres[113 * idx + 1:113 * idx + 1 + ns]]
                    yield key, (data, int(nbps), int(npasses), ends)


def idwt53(LL: np.ndarray, bands_f, out_shape: Tuple[int, int],
           origin: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Native multi-level inverse 5/3 DWT (native/j2k_idwt.cpp) —
    bit-identical to ops/dwt.idwt2d(reversible=True) incl. odd-origin
    parity, the host fast path. bands_f finest-first [(HL, LH, HH)]."""
    L = lib()
    th, tw = out_shape
    out = np.empty((th, tw), np.int32)
    keep = []
    ptrs = []
    for (HL, LH, HH) in bands_f:
        for a in (HL, LH, HH):
            a = np.ascontiguousarray(a, np.int32)
            keep.append(a)
            ptrs.append(a.ctypes.data)
    arr = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    LLc = np.ascontiguousarray(LL, np.int32)
    rc = L.tic_idwt53(
        LLc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), arr,
        len(bands_f), th, tw, origin[0], origin[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"native IDWT failed rc={rc}")
    return out


def fdwt53(plane: np.ndarray, levels: int,
           origin: Tuple[int, int] = (0, 0)):
    """Native multi-level forward 5/3 DWT (native/j2k_idwt.cpp) —
    bit-identical to ops/dwt.dwt2d(reversible=True). Returns
    (LL, [(HL, LH, HH) finest-first])."""
    from ...ops.dwt import _level_parity, subband_dims

    L = lib()
    th, tw = plane.shape
    dims = subband_dims(th, tw, levels, origin)

    def _nlow(n, p):
        return n // 2 if p else (n + 1) // 2

    bands = []
    ptrs = []
    for s in range(levels):
        h, w = dims[s]
        pyy, pxx = _level_parity(origin, s)
        nly, nlx = _nlow(h, pyy), _nlow(w, pxx)
        HL = np.empty((nly, w - nlx), np.int32)
        LH = np.empty((h - nly, nlx), np.int32)
        HH = np.empty((h - nly, w - nlx), np.int32)
        bands.append((HL, LH, HH))
        ptrs.extend([HL.ctypes.data, LH.ctypes.data, HH.ctypes.data])
    LL = np.empty(dims[levels], np.int32)
    arr = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    pc = np.ascontiguousarray(plane, np.int32)
    rc = L.tic_fdwt53(
        pc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), levels, th, tw,
        origin[0], origin[1],
        LL.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), arr)
    if rc != 0:
        raise ValueError(f"native FDWT failed rc={rc}")
    return LL, bands


def t1_encode(coefs: np.ndarray, band: int) -> Tuple[bytes, int, int]:
    """Encode one codeblock of signed int32 → (segment, num_bps, num_passes)."""
    L = lib()
    h, w = coefs.shape
    coefs = np.ascontiguousarray(coefs, np.int32)
    cap = w * h * 6 + 1024
    out = (ctypes.c_uint8 * cap)()
    outlen = ctypes.c_int()
    nbps = ctypes.c_int()
    npasses = ctypes.c_int()
    rc = L.tic_j2k_t1_encode(
        coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w, h, band,
        out, cap, ctypes.byref(outlen), ctypes.byref(nbps),
        ctypes.byref(npasses), 0, 0,
    )
    if rc != 0:
        raise ValueError(f"J2K T1 encode failed rc={rc}")
    return bytes(out[: outlen.value]), nbps.value, npasses.value
