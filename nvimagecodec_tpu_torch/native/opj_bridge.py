"""Optional system-openjpeg bridge (native/optional/opj_shim.cpp).

Built lazily against the system libopenjp2 (no headers shipped — the shim
declares the minimal public API locally). Because the opj_image struct
layout is declared by hand, the bridge SELF-VALIDATES on first use: it
decodes a tiny lossless stream of known pixels through the shim, and only
reports available if the pixels come back exactly. Used by the
JPEG2000 fallback plugin (HTJ2K + stream features our native decoder
rejects) and by the conformance test-suite."""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from . import BUILD_DIR, build_shared, needs_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "optional",
                    "opj_shim.cpp")
_SO = os.path.join(BUILD_DIR, "libtic_opj.so")

_lock = threading.Lock()
_lib = None
_validated = False


def _build() -> None:
    build_shared(_SO, [_SRC], ["-O2"], ["-l:libopenjp2.so.7"])


def _declare(L: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    L.tic_opj_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, i32p, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p,
    ]
    L.tic_opj_decode.restype = ctypes.c_int
    L.tic_opj_encode_lossless.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.tic_opj_encode_lossless.restype = ctypes.c_int
    L.tic_opj_decode_comp.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.c_int64, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    L.tic_opj_decode_comp.restype = ctypes.c_int
    L.tic_opj_encode_planes.argtypes = [
        ctypes.POINTER(i32p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.tic_opj_encode_planes.restype = ctypes.c_int
    L.tic_opj_encode_offsets.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.tic_opj_encode_offsets.restype = ctypes.c_int
    L.tic_opj_encode_mode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.tic_opj_encode_mode.restype = ctypes.c_int
    L.tic_opj_encode_poc.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.tic_opj_encode_poc.restype = ctypes.c_int


def lib() -> ctypes.CDLL:
    """Load (building if needed) and self-validate; raises if unusable."""
    global _lib, _validated
    with _lock:
        if _lib is None:
            if needs_build(_SO, [_SRC]):
                _build()
            L = ctypes.CDLL(_SO)
            _declare(L)
            _lib = L
        if not _validated:
            _self_validate(_lib)
            _validated = True
        return _lib


def decode(data: bytes) -> Tuple[np.ndarray, int, int]:
    """J2K/JP2 bytes → (interleaved int32 [H, W, C], precision, signed)."""
    L = lib()
    is_jp2 = 1 if data[:4] == b"\x00\x00\x00\x0c" else 0
    # generous output capacity guess: grow on rc=7
    cap = max(1 << 20, len(data) * 64)
    for _ in range(3):
        out = np.zeros(cap, np.int32)
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        nc = ctypes.c_int32()
        pr = ctypes.c_int32()
        sg = ctypes.c_int32()
        rc = L.tic_opj_decode(
            data, len(data), is_jp2,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
            ctypes.byref(pr), ctypes.byref(sg),
        )
        if rc == 7:
            cap *= 8
            continue
        if rc != 0:
            raise ValueError(f"openjpeg decode failed rc={rc}")
        n = w.value * h.value * nc.value
        return (
            out[:n].reshape(h.value, w.value, nc.value),
            pr.value,
            sg.value,
        )
    raise ValueError("openjpeg decode: image too large")


def encode_lossless(pix: np.ndarray, stream_type: str = "j2k") -> bytes:
    """u8/u16 [H,W(,C)] → lossless J2K/JP2 via openjpeg (test oracle)."""
    L = lib()
    if pix.ndim == 2:
        pix = pix[:, :, None]
    h, w, nc = pix.shape
    if pix.dtype == np.uint16:
        prec = 16
        body = np.ascontiguousarray(pix).tobytes()
    else:
        prec = 8
        body = np.ascontiguousarray(pix, np.uint8).tobytes()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = L.tic_opj_encode_lossless(
        body, w, h, nc,
        1 if stream_type == "jp2" else 0, prec,
        ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueError(f"openjpeg encode failed rc={rc}")
    data = ctypes.string_at(out, n.value)
    # shim allocates with malloc; free through libc
    ctypes.CDLL(None).free(out)
    return data


def encode_mode(pix: np.ndarray, mode: int, nlayers: int = 1) -> bytes:
    """u8 [H,W(,C)] → lossless J2K with the given SPcod code-block style
    (mode switches) via openjpeg — oracle for TERMALL/BYPASS decode.
    nlayers > 1 produces rate-allocated quality layers (exercises MQ
    codeword segments spanning layers under BYPASS)."""
    L = lib()
    if pix.ndim == 2:
        pix = pix[:, :, None]
    h, w, nc = pix.shape
    body = np.ascontiguousarray(pix, np.uint8).tobytes()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = L.tic_opj_encode_mode(body, w, h, nc, 8, mode, nlayers,
                               ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"openjpeg mode encode failed rc={rc}")
    data = ctypes.string_at(out, n.value)
    ctypes.CDLL(None).free(out)
    return data


def encode_poc(pix: np.ndarray, poc_list, nlayers: int = 2,
               levels: int = 2) -> bytes:
    """Lossless-encode with progression-order changes via openjpeg —
    oracle for our POC packet-order iterator. poc_list: [(RSpoc, CSpoc,
    LYEpoc, REpoc, CEpoc, Ppoc)] exactly as in the POC marker segment."""
    L = lib()
    pix = np.ascontiguousarray(pix, np.uint8)
    h, w = pix.shape[:2]
    nc = 1 if pix.ndim == 2 else pix.shape[2]
    flat = np.array([v for e in poc_list for v in e], np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = L.tic_opj_encode_poc(
        pix.tobytes(), w, h, nc, nlayers, flat.ctypes.data_as(i32p),
        len(poc_list), levels, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"openjpeg POC encode failed rc={rc}")
    data = ctypes.string_at(out, n.value)
    ctypes.CDLL(None).free(out)
    return data


def encode_lossless_offsets(pix: np.ndarray, ox: int, oy: int,
                            tile=None, stream_type: str = "j2k") -> bytes:
    """Lossless encode with explicit reference-grid offsets (odd XOsiz/
    YOsiz/XTOsiz/YTOsiz oracle streams for T.800 B.3/B.4 parity tests).

    tile: optional (tx0, ty0, tdx, tdy)."""
    L = lib()
    if pix.ndim == 2:
        pix = pix[:, :, None]
    h, w, nc = pix.shape
    prec = 16 if pix.dtype == np.uint16 else 8
    body = np.ascontiguousarray(pix.astype(np.int32)).tobytes()
    tx0, ty0, tdx, tdy = tile if tile else (0, 0, 0, 0)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = L.tic_opj_encode_offsets(
        body, w, h, nc, ox, oy, tx0, ty0, tdx, tdy, prec,
        1 if stream_type == "jp2" else 0, ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueError(f"openjpeg offset encode failed rc={rc}")
    data = ctypes.string_at(out, n.value)
    ctypes.CDLL(None).free(out)
    return data


def decode_comp(data: bytes, comp: int):
    """Decode ONE component plane of a J2K/JP2 stream (works for streams
    with per-component dims, i.e. subsampled, which the interleaved decode
    rejects). Returns (plane int32 [h, w], prec, signed, dx, dy, ncomp)."""
    L = lib()
    is_jp2 = 1 if data[:4] == b"\x00\x00\x00\x0c" else 0
    cap = max(1 << 20, len(data) * 64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for _ in range(3):
        out = np.zeros(cap, np.int32)
        vals = [ctypes.c_int32() for _ in range(7)]
        rc = L.tic_opj_decode_comp(
            data, len(data), is_jp2, comp,
            out.ctypes.data_as(i32p), out.size,
            *[ctypes.byref(v) for v in vals],
        )
        if rc == 7:
            cap *= 8
            continue
        if rc != 0:
            raise ValueError(f"openjpeg comp decode failed rc={rc}")
        w, h, prec, sgnd, dx, dy, nc = [v.value for v in vals]
        return out[: w * h].reshape(h, w), prec, sgnd, dx, dy, nc
    raise ValueError("openjpeg comp decode: image too large")


def encode_planes(planes, sub, prec: int = 8, sgnd: int = 0,
                  stream_type: str = "j2k", size=None,
                  clrspc: int = -1) -> bytes:
    """Lossless-encode planar int32 components with per-component
    subsampling/signedness via openjpeg (oracle generator for
    subsampled/signed conformance streams). planes: list of [h, w] arrays
    (comp c sized ceil(W/dx[c]) x ceil(H/dy[c])); sub: [(dx, dy)] per comp;
    size: full-grid (H, W), default derived from plane 0; clrspc:
    OPJ_CLRSPC (1=SRGB, 2=GRAY, 3=SYCC — sets the JP2 colr enumCS), -1
    for the ncomp default."""
    L = lib()
    nc = len(planes)
    dx = np.array([s[0] for s in sub], np.int32)
    dy = np.array([s[1] for s in sub], np.int32)
    if size is not None:
        h, w = int(size[0]), int(size[1])
    else:
        w = int(planes[0].shape[1] * dx[0])
        h = int(planes[0].shape[0] * dy[0])
    bufs = [np.ascontiguousarray(p, np.int32) for p in planes]
    i32p = ctypes.POINTER(ctypes.c_int32)
    arr = (i32p * nc)(*[b.ctypes.data_as(i32p) for b in bufs])
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = L.tic_opj_encode_planes(
        arr, w, h, nc, dx.ctypes.data_as(i32p), dy.ctypes.data_as(i32p),
        prec, sgnd, 1 if stream_type == "jp2" else 0, clrspc,
        ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueError(f"openjpeg planes encode failed rc={rc}")
    data = ctypes.string_at(out, n.value)
    ctypes.CDLL(None).free(out)
    return data


def _self_validate(L: ctypes.CDLL) -> None:
    """Layout check: the port's encoder's tiny lossless stream must
    round-trip exactly through the shim (guards the hand-declared opj_image
    layout)."""
    from ..codecs.jpeg2000.core import encode_j2k

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 9, 3)).astype(np.uint8)
    data = encode_j2k(img, reversible=True, levels=1, stream_type="j2k")
    out = np.zeros(8 * 9 * 3, np.int32)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    nc = ctypes.c_int32()
    pr = ctypes.c_int32()
    sg = ctypes.c_int32()
    rc = L.tic_opj_decode(
        data, len(data), 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        ctypes.byref(pr), ctypes.byref(sg),
    )
    if rc != 0 or (w.value, h.value, nc.value) != (9, 8, 3):
        raise RuntimeError("opj bridge self-validation failed (layout)")
    if not np.array_equal(out.reshape(8, 9, 3), img.astype(np.int32)):
        raise RuntimeError("opj bridge self-validation failed (pixels)")
