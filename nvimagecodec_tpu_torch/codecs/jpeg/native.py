"""ctypes bridge to the native JPEG entropy decoder
(nvimagecodec_tpu/native/jpeg_entropy.cpp)."""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from ...native import c_i16p, lib
from .headers import JpegFrame


def decode_coefficients_native(frame: JpegFrame, data: bytes) -> List[np.ndarray]:
    """Decode all scans in C++; returns per-component [bh, bw, 64] int16."""
    if is_arith(frame):
        return decode_coefficients_arith(frame, data)
    L = lib()
    coefs = (c_i16p * 4)()
    bw = (ctypes.c_int32 * 4)()
    bh = (ctypes.c_int32 * 4)()
    ncomp = ctypes.c_int32()
    rc = L.tic_jpeg_decode_coefficients(
        data, len(data), coefs,
        ctypes.cast(bw, ctypes.POINTER(ctypes.c_int32)),
        ctypes.cast(bh, ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(ncomp),
    )
    if rc != 0:
        raise ValueError("native JPEG entropy decode failed")
    out = []
    for c in range(ncomp.value):
        n = bw[c] * bh[c] * 64
        arr = np.ctypeslib.as_array(coefs[c], (n,)).copy().reshape(bh[c], bw[c], 64)
        L.tic_free(coefs[c])
        out.append(arr)
    return out


def is_arith(frame: JpegFrame) -> bool:
    """Arithmetic-coded (T.81 Annex K) sequential or progressive frame."""
    return frame.marker in (0xC9, 0xCA)


def decode_coefficients_arith(frame: JpegFrame, data: bytes) -> List[np.ndarray]:
    """Arithmetic-coded entropy decode (native/jpeg_arith.cpp) — same
    output contract as decode_coefficients_native."""
    L = lib()
    coefs = (c_i16p * 4)()
    bw = (ctypes.c_int32 * 4)()
    bh = (ctypes.c_int32 * 4)()
    ncomp = ctypes.c_int32()
    rc = L.tic_jpeg_arith_decode_coefficients(
        data, len(data), coefs,
        ctypes.cast(bw, ctypes.POINTER(ctypes.c_int32)),
        ctypes.cast(bh, ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(ncomp),
    )
    if rc != 0:
        raise ValueError(f"arithmetic JPEG entropy decode failed (rc={rc})")
    out = []
    for c in range(ncomp.value):
        n = bw[c] * bh[c] * 64
        arr = np.ctypeslib.as_array(coefs[c], (n,)).copy().reshape(
            bh[c], bw[c], 64)
        L.tic_free(coefs[c])
        out.append(arr)
    return out


def decode_coefficients_into(frame: JpegFrame, data: bytes, slots) -> None:
    """Decode directly into preallocated per-component [bh, bw, 64] int16
    views (one batch slot each) — zero-copy into the stacked batch array.
    The ctypes call releases the GIL, so a thread pool scales this."""
    if is_arith(frame):
        for s, arr in zip(slots, decode_coefficients_arith(frame, data)):
            s[...] = arr
        return
    L = lib()
    ncomp = len(frame.components)
    bufs = (c_i16p * 4)()
    bw = (ctypes.c_int32 * 4)()
    bh = (ctypes.c_int32 * 4)()
    for c, s in enumerate(slots):
        assert s.dtype == np.int16 and s.flags.c_contiguous
        bufs[c] = s.ctypes.data_as(c_i16p)
        bh[c], bw[c] = s.shape[0], s.shape[1]
    rc = L.tic_jpeg_decode_coefficients_into(
        data, len(data), bufs,
        ctypes.cast(bw, ctypes.POINTER(ctypes.c_int32)),
        ctypes.cast(bh, ctypes.POINTER(ctypes.c_int32)),
        ncomp,
    )
    if rc != 0:
        raise ValueError(f"native JPEG entropy decode failed (rc={rc})")
