"""Native (C++) host components, built on demand with the system compiler.

The port's own copy of nvimagecodec_tpu/native: the host stages where Python
costs real time (JPEG entropy decode and encode, index scan, restart split,
arithmetic and lossless JPEG, PNG defilter, TIFF LZW/fax, WebP VP8). At first
use `c++` compiles the `*.cpp` beside this file into
`nvimagecodec_tpu_torch/build/libtic_host.so`; the library is rebuilt when a
source is newer than it. The build writes a temporary file and renames it
into place (`build_shared`), so concurrent processes never load a
half-written library. The JPEG2000 sources (`j2k_*.cpp`) are not part of the
port yet.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
from typing import Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_SO = os.path.join(BUILD_DIR, "libtic_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(_DIR, "*.cpp")))


def _headers():
    return sorted(glob.glob(os.path.join(_DIR, "*.inc")))


def needs_build(so: str, deps: Sequence[str]) -> bool:
    """True when `so` is missing or older than one of `deps`."""
    if not os.path.exists(so):
        return True
    so_m = os.path.getmtime(so)
    return any(os.path.getmtime(s) > so_m for s in deps)


def build_shared(so: str, sources: Sequence[str],
                 flags: Sequence[str] = (), libs: Sequence[str] = ()) -> None:
    """Compile `sources` into the shared library `so` with the system `c++`:
    the output goes to a temporary name of this process and thread and is
    renamed into place."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["c++", *flags, "-std=c++17", "-shared", "-fPIC", *sources,
           "-o", tmp, *libs]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build of {os.path.basename(so)} "
                               f"failed:\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build() -> None:
    build_shared(_SO, _sources(), ["-O3", "-march=native", "-pthread"])


def lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            if needs_build(_SO, _sources() + _headers()):
                build()
            L = ctypes.CDLL(_SO)
            _declare(L)
            _lib = L
        return _lib


c_i16p = ctypes.POINTER(ctypes.c_int16)


def _declare(L: ctypes.CDLL) -> None:
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    L.tic_free.argtypes = [ctypes.c_void_p]
    L.tic_jpeg_decode_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4, c_i32p, c_i32p, c_i32p,
    ]
    L.tic_jpeg_decode_coefficients.restype = ctypes.c_int
    L.tic_jpeg_decode_coefficients_into.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4, c_i32p, c_i32p,
        ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_into.restype = ctypes.c_int
    L.tic_jpeg_decode_coefficients_roi_into.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4, c_i32p, c_i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_roi_into.restype = ctypes.c_int
    L.tic_jpeg_decode_coefficients_packed.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, u8p * 4,
        ctypes.POINTER(ctypes.c_int8) * 4, c_i32p, c_i32p, c_i32p,
        ctypes.c_int32,
    ]
    L.tic_jpeg_decode_coefficients_packed.restype = ctypes.c_int
    L.tic_jpeg_pack_coefficients.argtypes = [
        c_i16p, ctypes.c_int64, u8p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8),
    ]
    L.tic_jpeg_pack_coefficients.restype = ctypes.c_int
    L.tic_jpeg_split_segments.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    L.tic_jpeg_split_segments.restype = ctypes.c_int
    L.tic_jpeg_index_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int32, u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        c_i32p, ctypes.c_int32,
    ]
    L.tic_jpeg_index_scan.restype = ctypes.c_int
    L.tic_jpeg_pack_indexed.argtypes = [
        u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, c_i32p,
    ]
    L.tic_jpeg_pack_indexed.restype = ctypes.c_int
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.tic_jpeg_index_scan_batch.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), i64p, ctypes.c_int32,
        u8p, i64p, i64p, i64p, c_i32p, ctypes.c_int32, c_i32p, ctypes.c_int32,
    ]
    L.tic_jpeg_index_scan_batch.restype = ctypes.c_int
    L.tic_jpeg_pack_indexed_batch.argtypes = [
        ctypes.c_int32, u8p, i64p, i64p, i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int32,
        c_i32p, c_i32p, ctypes.c_int32,
    ]
    L.tic_jpeg_pack_indexed_batch.restype = ctypes.c_int
    L.tic_jpeg_encode_pixels.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, c_i32p, c_i32p, ctypes.POINTER(ctypes.c_float),
        c_i16p * 4, c_i32p, c_i32p,
    ]
    L.tic_jpeg_encode_pixels.restype = ctypes.c_int
    L.tic_jpeg_count_symbols.argtypes = [
        ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(c_i16p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    L.tic_jpeg_count_symbols.restype = ctypes.c_int
    L.tic_jpeg_encode_scan.argtypes = [
        ctypes.c_int, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p, c_i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(c_i16p),
        ctypes.c_char_p, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
    ]
    L.tic_jpeg_encode_scan.restype = ctypes.c_int
    L.tic_jpeg_encode_baseline.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, c_i32p, c_i32p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p, c_i32p, c_i32p, ctypes.c_int32,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
    ]
    L.tic_jpeg_encode_baseline.restype = ctypes.c_int
    L.tic_png_defilter.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, u8p,
    ]
    L.tic_png_defilter.restype = ctypes.c_int
    L.tic_tiff_lzw_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    L.tic_tiff_lzw_decode.restype = ctypes.c_int64
    L.tic_tiff_fax_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    L.tic_tiff_fax_decode.restype = ctypes.c_int32
    L.tic_jpeg_arith_decode_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_i16p * 4, c_i32p, c_i32p, c_i32p,
    ]
    L.tic_jpeg_arith_decode_coefficients.restype = ctypes.c_int
    L.tic_vp8_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, u8p, u8p, u8p, ctypes.c_int64,
        c_i32p, c_i32p, ctypes.c_int32,
    ]
    L.tic_vp8_decode.restype = ctypes.c_int
    L.tic_vp8_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, c_i32p,
    ]
    L.tic_vp8_encode.restype = ctypes.c_int
    L.tic_jpeg_lossless_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32, c_i32p, c_i32p, c_i32p, c_i32p,
    ]
    L.tic_jpeg_lossless_decode.restype = ctypes.c_int
