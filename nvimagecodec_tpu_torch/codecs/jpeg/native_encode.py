"""ctypes bridge to the native JPEG Huffman entropy encoder
(nvimagecodec_tpu/native/jpeg_huffman_encode.cpp)."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np

from ...native import lib
from .headers import HuffTable, JpegFrame

_i32 = ctypes.c_int32


def _geometry(frame: JpegFrame):
    ncomp = len(frame.components)
    mcus_x, mcus_y, dims = frame.mcu_geometry()
    h = (_i32 * ncomp)(*[c.h for c in frame.components])
    v = (_i32 * ncomp)(*[c.v for c in frame.components])
    bw = (_i32 * ncomp)(*[d[0] for d in dims])
    bh = (_i32 * ncomp)(*[d[1] for d in dims])
    dct = (_i32 * ncomp)(*[c.dc_tbl for c in frame.components])
    act = (_i32 * ncomp)(*[c.ac_tbl for c in frame.components])
    return ncomp, mcus_x, mcus_y, h, v, bw, bh, dct, act


def _coef_ptrs(coefs: Sequence[np.ndarray]):
    arrs = [np.ascontiguousarray(c.reshape(-1), dtype=np.int16) for c in coefs]
    PtrT = ctypes.POINTER(ctypes.c_int16) * len(arrs)
    ptrs = PtrT(*[a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for a in arrs])
    return arrs, ptrs  # keep arrs alive


def _table_blob(dc: Dict[int, HuffTable], ac: Dict[int, HuffTable]) -> bytes:
    blob = bytearray(8 * 272)
    for base, tables in ((0, dc), (4, ac)):
        for tid, t in tables.items():
            off = (base + tid) * 272
            blob[off : off + 16] = bytes(t.bits)
            blob[off + 16 : off + 16 + len(t.values)] = bytes(t.values)
    return bytes(blob)


def encode_pixels_native(img: np.ndarray, frame: JpegFrame):
    """Full native pixel stage: u8 [H,W(,C)] → per-component [bh, bw, 64]
    int16 quantized coefficient blocks (natural order). Raises ValueError
    for layouts the native stage does not cover (caller falls back to the
    array path). GIL-released."""
    L = lib()
    if img.dtype != np.uint8:
        raise ValueError("native encode pixels: uint8 only")
    img = np.ascontiguousarray(img)
    nchan = 1 if img.ndim == 2 else img.shape[-1]
    H, W = img.shape[:2]
    ncomp = len(frame.components)
    _, _, dims = frame.mcu_geometry()
    h = (_i32 * ncomp)(*[c.h for c in frame.components])
    v = (_i32 * ncomp)(*[c.v for c in frame.components])
    bw = (_i32 * ncomp)(*[d[0] for d in dims])
    bh = (_i32 * ncomp)(*[d[1] for d in dims])
    qinv = np.concatenate([
        (1.0 / frame.quant[c.tq].astype(np.float64)).astype(np.float32)
        for c in frame.components
    ])
    outs = [np.empty((d[1], d[0], 64), np.int16) for d in dims]
    PtrT = ctypes.POINTER(ctypes.c_int16) * 4
    ptrs = PtrT(*([o.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
                   for o in outs] + [None] * (4 - ncomp)))
    rc = L.tic_jpeg_encode_pixels(
        img.ctypes.data_as(ctypes.c_char_p), H, W, nchan, ncomp, h, v,
        np.ascontiguousarray(qinv).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        ptrs, bw, bh,
    )
    if rc != 0:
        raise ValueError(f"native encode pixels unsupported (rc={rc})")
    return outs


_AAN_SCALE = np.array([1.0, 1.387039845, 1.306562965, 1.175875602,
                       1.0, 0.785694958, 0.541196100, 0.275899379])


def aan_qinv(quant: np.ndarray) -> np.ndarray:
    """Natural-order quant reciprocals with the AAN fDCT scale folded in:
    1 / (q[u][v] * aan[u] * aan[v] * 8), f32 — the divisors the fused
    encoder's AAN flowgraph needs (libjpeg jcdctmgr.c float convention)."""
    q = np.asarray(quant, np.float64).reshape(8, 8)
    return (1.0 / (q * np.outer(_AAN_SCALE, _AAN_SCALE) * 8.0)).astype(
        np.float32).reshape(64)


def encode_scan_fused(img: np.ndarray, frame: JpegFrame,
                      dc_tables: Dict[int, HuffTable],
                      ac_tables: Dict[int, HuffTable],
                      restart_interval: int = 0,
                      setup=None) -> bytes:
    """Single native call: uint8 image → entropy-coded scan bytes (fused
    color/downsample/AAN-fDCT/quant/Huffman, jpeg_encode_fast.cpp). Raises
    ValueError for layouts it does not cover — caller falls back to the
    staged path. `setup` may carry precomputed (h, v, dct, act, qs, blob)
    ctypes arrays for the frame (cached by the batch encoder)."""
    L = lib()
    if img.dtype != np.uint8:
        raise ValueError("fused encode: uint8 only")
    img = np.ascontiguousarray(img)
    nchan = 1 if img.ndim == 2 else img.shape[-1]
    H, W = img.shape[:2]
    if setup is None:
        setup = fused_setup(frame, dc_tables, ac_tables)
    h, v, dct, act, qs, blob = setup
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = L.tic_jpeg_encode_baseline(
        img.ctypes.data_as(ctypes.c_char_p), H, W, nchan,
        len(frame.components), h, v,
        qs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), blob, dct, act,
        restart_interval, ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"fused encode unsupported (rc={rc})")
    data = ctypes.string_at(out, out_len.value)
    L.tic_free(out)
    return data


def fused_setup(frame: JpegFrame, dc_tables: Dict[int, HuffTable],
                ac_tables: Dict[int, HuffTable]):
    """Precompute the ctypes arguments of encode_scan_fused for a frame
    (cacheable per geometry/quality bucket)."""
    ncomp = len(frame.components)
    h = (_i32 * ncomp)(*[c.h for c in frame.components])
    v = (_i32 * ncomp)(*[c.v for c in frame.components])
    dct = (_i32 * ncomp)(*[c.dc_tbl for c in frame.components])
    act = (_i32 * ncomp)(*[c.ac_tbl for c in frame.components])
    qs = np.concatenate([aan_qinv(frame.quant[c.tq])
                         for c in frame.components])
    blob = _table_blob(dc_tables, ac_tables)
    return h, v, dct, act, np.ascontiguousarray(qs), blob


def count_symbols_native(frame: JpegFrame, coefs: Sequence[np.ndarray]):
    """({table_id: dc_counts[256]}, {table_id: ac_counts[256]})."""
    L = lib()
    ncomp, mx, my, h, v, bw, bh, dct, act = _geometry(frame)
    arrs, ptrs = _coef_ptrs(coefs)
    dcc = np.zeros(4 * 256, np.int64)
    acc = np.zeros(4 * 256, np.int64)
    rc = L.tic_jpeg_count_symbols(
        ncomp, h, v, bw, bh, dct, act, mx, my, ptrs,
        dcc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise ValueError("native symbol count failed")
    ids_dc = {c.dc_tbl for c in frame.components}
    ids_ac = {c.ac_tbl for c in frame.components}
    return (
        {i: dcc[i * 256 : (i + 1) * 256] for i in ids_dc},
        {i: acc[i * 256 : (i + 1) * 256] for i in ids_ac},
    )


def scan_setup(frame: JpegFrame, dc_tables: Dict[int, HuffTable],
               ac_tables: Dict[int, HuffTable]):
    """Precompute the ctypes arguments of entropy_encode_native that depend
    on the frame and the tables alone (cacheable per bucket of same-geometry
    samples encoded with the same tables)."""
    return _geometry(frame), _table_blob(dc_tables, ac_tables)


def entropy_encode_native(
    frame: JpegFrame,
    coefs: Sequence[np.ndarray],
    dc_tables: Dict[int, HuffTable],
    ac_tables: Dict[int, HuffTable],
    restart_interval: int = 0,
    setup=None,
) -> bytes:
    """`setup` may carry `scan_setup(frame, dc_tables, ac_tables)`."""
    L = lib()
    geometry, blob = setup or scan_setup(frame, dc_tables, ac_tables)
    ncomp, mx, my, h, v, bw, bh, dct, act = geometry
    arrs, ptrs = _coef_ptrs(coefs)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = L.tic_jpeg_encode_scan(
        ncomp, h, v, bw, bh, dct, act, mx, my, restart_interval,
        ptrs, blob, ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError("native entropy encode failed")
    data = ctypes.string_at(out, out_len.value)
    L.tic_free(out)
    return data
