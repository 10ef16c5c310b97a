"""Native (C++) host components, built on demand with the system compiler.

The port's own copy of nvimagecodec_tpu/native: the host stages where Python
costs real time (JPEG marker walk, entropy decode and encode, index scan,
restart split, arithmetic and lossless JPEG, PNG defilter, TIFF LZW/fax,
WebP VP8, JPEG2000 Tier-1/Tier-2). At first
use `c++` compiles the `*.cpp` beside this file into
`nvimagecodec_tpu_torch/build/libtic_host.so`; the library is rebuilt when a
source is newer than it. The build writes a temporary file and renames it
into place (`build_shared`), so concurrent processes never load a
half-written library. The JPEG2000 sources (`j2k_*.cpp`: Tier-1 EBCOT and HT
block coders, the batched block entries, Tier-2 packet headers, the 5/3
transforms and the reversible epilogue) are part of it.
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
    # the int64 arrays as addresses (c_void_p): one numpy buffer holds all
    L.tic_jpeg_parse_batch.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    L.tic_jpeg_parse_batch.restype = ctypes.c_int
    _declare_j2k(L)


def _declare_j2k(L: ctypes.CDLL) -> None:
    """Every `tic_*` entry of `j2k_*.cpp` that codecs/jpeg2000 calls."""
    c_int, c_i32, c_i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32pp = ctypes.POINTER(i32p)
    vpp = ctypes.POINTER(vp)
    intp = ctypes.POINTER(c_int)
    sigs = {
        # Tier-1, one block
        "tic_j2k_t1_decode": [cp, c_int, c_int, c_int, c_int, c_int, c_int,
                              i32p],
        "tic_j2k_t1_encode": [i32p, c_int, c_int, c_int, u8p, c_int, intp,
                              intp, intp, c_int, c_int],
        "tic_ht_decode_block": [cp, c_i32, cp, c_i32, c_i32, c_i32, c_i32,
                                c_i32, c_i32, i32p],
        "tic_ht_encode_block": [i32p, c_i32, c_i32, c_i32, u8p, c_i32, i32p,
                                i32p, i32p, i32p],
        # Tier-1, a tile's blocks in one call; the last argument of the
        # decodes takes the CPU time of the workers they start (or None)
        "tic_t1_decode_batch_into": [c_i32, cp, i32p, i32pp, i64p, i32p,
                                     c_i32, i64p],
        "tic_ht_decode_batch_into": [c_i32, cp, i32p, i32pp, i64p, i32p,
                                     c_i32, i64p],
        "tic_t1_encode_batch_addr": [c_i32, i32pp, i64p, i64p, u8p, i64p,
                                     i32p, i32p, c_i32],
        "tic_ht_encode_batch_addr": [c_i32, i32pp, i64p, i64p, u8p, i64p,
                                     i32p, c_i32],
        # 5/3 transforms and the reversible epilogue
        "tic_idwt53": [i32p, vpp, c_int, c_int, c_int, c_int, c_int, i32p],
        "tic_fdwt53": [i32p, c_int, c_int, c_int, c_int, c_int, i32p, vpp],
        "tic_j2k_rct_shift_u8": [i32p, i32p, i32p, c_i64, u8p],
        "tic_j2k_shift_u8": [i32p, c_i64, c_i32, u8p],
        # Tier-2 packet headers: reader, then writer
        "tic_t2_read_packets": [vp, cp, c_i64, cp, c_i64, vp, c_int, c_int],
        "tic_t2e_add_precband": [vp, c_int, c_int, i32p, i32p],
        "tic_t2e_write_packet": [vp, i32p, c_int, i32p, c_int, i32p, u8p,
                                 c_int],
    }
    for name, argtypes in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    for name in ("tic_t2_create", "tic_t2e_create"):
        getattr(L, name).argtypes = []
        getattr(L, name).restype = vp
    for name in ("tic_t2_free", "tic_t2e_free"):
        getattr(L, name).argtypes = [vp]
        getattr(L, name).restype = None
    # the code-block rows of a tile (arrays passed as addresses)
    L.tic_t2_add_resolutions.argtypes = [vp, c_int, vp]
    L.tic_t2_side.argtypes = [vp, vp]
    L.tic_t2_rows.argtypes = [vp, cp, c_i64, c_i64, vp, c_int, vp, vp, vp]
    for name in ("tic_t2_add_resolutions", "tic_t2_side", "tic_t2_rows"):
        getattr(L, name).restype = None
    L.tic_t2_blocks.argtypes = [vp]
    L.tic_t2_blocks.restype = c_i64
    L.tic_t1_rows_check.argtypes = [vp, c_i64, vp, c_i64]
    L.tic_t1_rows_check.restype = c_i64
