"""The codestreams of the digital-cinema cell: 2K DCI picture frames, made
from the pool's JPEG streams and written by OpenJPEG itself, as
`opj_compress -cinema2K 24` writes them. Never by the measured program.

Each JPEG stream is decoded to RGB by Pillow, taken to 12-bit X'Y'Z' by
SMPTE ST 428-1 (`xyz12`), and encoded by `libopenjp2` through ctypes with
what `opj_compress -cinema2K 24` sets (opj_j2k_set_cinema_parameters then
sets the rest): the Profile-3 capability, 250 Mbit/s at 24 frames a second
(1,302,083 B a frame, 1,041,666 B a component), ICT, 12-bit unsigned
components. OpenJPEG writes 9/7, 5 levels, 32x32 code-blocks, precincts of
128x128 at the LL resolution and 256x256 above it, CPRL, one layer, one
tile in three tile-parts (one a component). A frame smaller than 2K keeps
the bit rate: its caps scale with its area (`caps`).

`check` reads every stream's markers and raises where one is not a
Profile-3 2K stream of the caps; `opj_decode` is OpenJPEG's own decode at
12 bits, the answer the cell's check compares with. `Converter` makes the
codestreams in worker processes, so that a pool of frames adds little to
set-up.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import io
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import NamedTuple, Tuple

import numpy as np

# the 2K frame and its caps at 24 frames a second (DCI; OpenJPEG's
# OPJ_CINEMA_24_CS and OPJ_CINEMA_24_COMP)
FRAME = (1080, 2048)
CINEMA_24_CS = 1302083
CINEMA_24_COMP = 1041666
DEPTH = 12
LEVELS = 5
OPJ_PROFILE_CINEMA_2K = 0x0003
OPJ_CODEC_J2K = 0
OPJ_CLRSPC_UNSPECIFIED = 0  # X'Y'Z': OpenJPEG applies no colour conversion

# SMPTE ST 428-1: the reference white's luminance and the normalising
# constant of the X'Y'Z' code values, the 1/2.6 power, and BT.709's primaries
# with D65 white (sRGB's) for the RGB -> XYZ matrix
WHITE_CD_M2 = 48.0
NORM_CD_M2 = 52.37
GAMMA = 2.6
RGB_TO_XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]])


# ------------------------------------------------ OpenJPEG 2.x public API
class _Poc(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in (
        "resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
        "precno0", "precno1")]
        + [("prg1", ctypes.c_int), ("prg", ctypes.c_int),
           ("progorder", ctypes.c_char * 5), ("tile", ctypes.c_uint32)]
        + [(n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")]
        + [(n, ctypes.c_uint32) for n in (
            "layS", "resS", "compS", "prcS", "layE", "resE", "compE",
            "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
            "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")])


_PATH_LEN = 4096
_MAXRLVLS = 33
_JPWL_TILES = _JPWL_PACKS = 16


class _CParams(ctypes.Structure):
    """opj_cparameters_t of openjpeg.h (2.x)."""
    _fields_ = [
        ("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int),
        ("cp_ty0", ctypes.c_int), ("cp_tdx", ctypes.c_int),
        ("cp_tdy", ctypes.c_int), ("cp_disto_alloc", ctypes.c_int),
        ("cp_fixed_alloc", ctypes.c_int), ("cp_fixed_quality", ctypes.c_int),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
        ("csty", ctypes.c_int), ("prog_order", ctypes.c_int),
        ("POC", _Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100),
        ("numresolution", ctypes.c_int), ("cblockw_init", ctypes.c_int),
        ("cblockh_init", ctypes.c_int), ("mode", ctypes.c_int),
        ("irreversible", ctypes.c_int), ("roi_compno", ctypes.c_int),
        ("roi_shift", ctypes.c_int), ("res_spec", ctypes.c_int),
        ("prcw_init", ctypes.c_int * _MAXRLVLS),
        ("prch_init", ctypes.c_int * _MAXRLVLS),
        ("infile", ctypes.c_char * _PATH_LEN),
        ("outfile", ctypes.c_char * _PATH_LEN),
        ("index_on", ctypes.c_int), ("index", ctypes.c_char * _PATH_LEN),
        ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int),
        ("subsampling_dx", ctypes.c_int), ("subsampling_dy", ctypes.c_int),
        ("decod_format", ctypes.c_int), ("cod_format", ctypes.c_int),
        ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * _JPWL_TILES),
        ("jpwl_hprot_TPH", ctypes.c_int * _JPWL_TILES),
        ("jpwl_pprot_tileno", ctypes.c_int * _JPWL_PACKS),
        ("jpwl_pprot_packno", ctypes.c_int * _JPWL_PACKS),
        ("jpwl_pprot", ctypes.c_int * _JPWL_PACKS),
        ("jpwl_sens_size", ctypes.c_int), ("jpwl_sens_addr", ctypes.c_int),
        ("jpwl_sens_range", ctypes.c_int), ("jpwl_sens_MH", ctypes.c_int),
        ("jpwl_sens_TPH_tileno", ctypes.c_int * _JPWL_TILES),
        ("jpwl_sens_TPH", ctypes.c_int * _JPWL_TILES),
        ("cp_cinema", ctypes.c_int), ("max_comp_size", ctypes.c_int),
        ("cp_rsiz", ctypes.c_int), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
        ("jpip_on", ctypes.c_int), ("mct_data", ctypes.c_void_p),
        ("max_cs_size", ctypes.c_int), ("rsiz", ctypes.c_uint16),
        # room for what later versions append
        ("_spare", ctypes.c_char * 4096)]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")]
        + [("data", ctypes.POINTER(ctypes.c_int32)),
           ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_SIZE_T = ctypes.c_size_t
_OFF_T = ctypes.c_int64
_READ = ctypes.CFUNCTYPE(_SIZE_T, ctypes.c_void_p, _SIZE_T, ctypes.c_void_p)
_WRITE = _READ
_SKIP = ctypes.CFUNCTYPE(_OFF_T, _OFF_T, ctypes.c_void_p)
_SEEK = ctypes.CFUNCTYPE(ctypes.c_int, _OFF_T, ctypes.c_void_p)

_LIB = [None]


def library_path() -> str:
    """The libopenjp2 that Pillow carries (pillow.libs), else the
    system's."""
    import PIL

    site = os.path.dirname(os.path.dirname(os.path.abspath(PIL.__file__)))
    found = sorted(glob.glob(os.path.join(site, "pillow.libs",
                                          "libopenjp2*.so*")))
    if found:
        return found[-1]
    name = ctypes.util.find_library("openjp2")
    if name is None:
        raise OSError("no libopenjp2: neither Pillow's nor the system's")
    return name


def _lib() -> ctypes.CDLL:
    if _LIB[0] is not None:
        return _LIB[0]
    L = ctypes.CDLL(library_path())
    vp, b = ctypes.c_void_p, ctypes.c_int
    sig = {
        "opj_version": ([], ctypes.c_char_p),
        "opj_create_compress": ([b], vp),
        "opj_create_decompress": ([b], vp),
        "opj_set_default_encoder_parameters": ([ctypes.POINTER(_CParams)],
                                               None),
        "opj_set_default_decoder_parameters": ([vp], None),
        "opj_setup_encoder": ([vp, ctypes.POINTER(_CParams),
                               ctypes.POINTER(_Image)], b),
        "opj_setup_decoder": ([vp, vp], b),
        "opj_image_create": ([ctypes.c_uint32, ctypes.POINTER(_CmptParm), b],
                             ctypes.POINTER(_Image)),
        "opj_image_destroy": ([ctypes.POINTER(_Image)], None),
        "opj_stream_create": ([_SIZE_T, b], vp),
        "opj_stream_destroy": ([vp], None),
        "opj_stream_set_read_function": ([vp, _READ], None),
        "opj_stream_set_write_function": ([vp, _WRITE], None),
        "opj_stream_set_skip_function": ([vp, _SKIP], None),
        "opj_stream_set_seek_function": ([vp, _SEEK], None),
        "opj_stream_set_user_data": ([vp, vp, vp], None),
        "opj_stream_set_user_data_length": ([vp, ctypes.c_uint64], None),
        "opj_start_compress": ([vp, ctypes.POINTER(_Image), vp], b),
        "opj_encode": ([vp, vp], b),
        "opj_end_compress": ([vp, vp], b),
        "opj_read_header": ([vp, vp, ctypes.POINTER(ctypes.POINTER(_Image))],
                            b),
        "opj_decode": ([vp, vp, ctypes.POINTER(_Image)], b),
        "opj_end_decompress": ([vp, vp], b),
        "opj_destroy_codec": ([vp], None),
    }
    for name, (args, res) in sig.items():
        fn = getattr(L, name)
        fn.argtypes, fn.restype = args, res
    _LIB[0] = L
    return L


class _Memory:
    """An in-memory OpenJPEG stream: its callbacks over a bytearray."""

    def __init__(self, L, data: bytes = None):
        self.buf = bytearray(data or b"")
        self.pos = 0
        self.reading = data is not None
        self.stream = L.opj_stream_create(1 << 20, int(self.reading))
        if not self.stream:
            raise MemoryError("opj_stream_create")
        self._cbs = (_READ(self._read), _WRITE(self._write),
                     _SKIP(self._skip), _SEEK(self._seek))
        if self.reading:
            L.opj_stream_set_read_function(self.stream, self._cbs[0])
            L.opj_stream_set_user_data_length(self.stream, len(self.buf))
        else:
            L.opj_stream_set_write_function(self.stream, self._cbs[1])
        L.opj_stream_set_skip_function(self.stream, self._cbs[2])
        L.opj_stream_set_seek_function(self.stream, self._cbs[3])

    def _read(self, dst, n, _user):
        k = min(n, len(self.buf) - self.pos)
        if k <= 0:
            return _SIZE_T(-1).value  # (OPJ_SIZE_T)-1: the end
        ctypes.memmove(dst, (ctypes.c_char * k).from_buffer(self.buf,
                                                            self.pos), k)
        self.pos += k
        return k

    def _write(self, src, n, _user):
        end = self.pos + n
        if end > len(self.buf):
            self.buf.extend(b"\0" * (end - len(self.buf)))
        self.buf[self.pos:end] = ctypes.string_at(src, n)
        self.pos = end
        return n

    def _skip(self, n, _user):
        if self.reading and self.pos + n > len(self.buf):
            n = len(self.buf) - self.pos
            if n <= 0:
                return -1
        self.pos += n
        return n

    def _seek(self, n, _user):
        if self.reading and n > len(self.buf):
            return 0
        self.pos = n
        return 1


# ------------------------------------------------------------ the frames
def source_pixels(jpeg: bytes) -> np.ndarray:
    """The RGB uint8 [H, W, 3] pixels of a JPEG stream, as Pillow decodes
    them."""
    from PIL import Image

    with Image.open(io.BytesIO(jpeg)) as im:
        return np.asarray(im.convert("RGB"))


def xyz12(rgb: np.ndarray) -> np.ndarray:
    """sRGB uint8 [H, W, 3] to 12-bit X'Y'Z' code values (uint16): the
    sRGB curve undone, BT.709 primaries to XYZ, white at 48 cd/m^2, then
    SMPTE ST 428-1's X' = round(4095 (L X / 52.37)^(1/2.6))."""
    c = rgb.astype(np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    xyz = lin @ RGB_TO_XYZ.T
    v = np.clip(xyz * (WHITE_CD_M2 / NORM_CD_M2), 0.0, 1.0) ** (1.0 / GAMMA)
    return np.rint(4095.0 * v).astype(np.uint16)


def caps(height: int, width: int) -> Tuple[int, int]:
    """(bytes a frame, bytes a component) at 24 frames a second for a
    frame of height x width: DCI's caps for a 2K frame, scaled by area for
    a smaller one (the same bits a sample of its data, `check`)."""
    share = height * width / (FRAME[0] * FRAME[1])
    if share >= 1.0:
        return CINEMA_24_CS, CINEMA_24_COMP
    return int(CINEMA_24_CS * share), int(CINEMA_24_COMP * share)


def encode(xyz: np.ndarray) -> bytes:
    """The Profile-3 codestream of a 12-bit X'Y'Z' frame [H, W, 3] (uint16)
    by OpenJPEG at `opj_compress -cinema2K 24`'s settings, with the caps
    `caps(H, W)`. Checked (`check`) before it is returned."""
    xyz = np.ascontiguousarray(xyz)
    h, w, ncomp = xyz.shape
    if ncomp != 3 or xyz.dtype != np.uint16 or int(xyz.max()) >= 1 << DEPTH:
        raise ValueError("a frame is [H, W, 3] 12-bit X'Y'Z' in uint16")
    max_cs, max_comp = caps(h, w)
    L = _lib()
    p = _CParams()
    L.opj_set_default_encoder_parameters(ctypes.byref(p))
    if (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno,
            p.subsampling_dx, p.decod_format, p.cod_format) != (
            6, 64, 64, -1, 1, -1, -1):
        raise RuntimeError("opj_cparameters_t does not match this "
                           f"libopenjp2 ({L.opj_version().decode()})")
    # opj_compress -cinema2K 24: the profile, the frame and component
    # caps, MCT on; the encoder's cinema settings do the rest
    p.rsiz = OPJ_PROFILE_CINEMA_2K
    p.max_cs_size = max_cs
    p.max_comp_size = max_comp
    p.tcp_mct = 1
    parms = (_CmptParm * 3)()
    for c in range(3):
        parms[c] = _CmptParm(1, 1, w, h, 0, 0, DEPTH, DEPTH, 0)
    img = L.opj_image_create(3, parms, OPJ_CLRSPC_UNSPECIFIED)
    if not img:
        raise MemoryError("opj_image_create")
    codec = None
    mem = None
    try:
        im = img.contents
        im.x0, im.y0, im.x1, im.y1 = 0, 0, w, h
        for c in range(3):
            dst = np.ctypeslib.as_array(im.comps[c].data, (h * w,))
            dst[:] = xyz[:, :, c].reshape(-1)
        codec = L.opj_create_compress(OPJ_CODEC_J2K)
        if not L.opj_setup_encoder(codec, ctypes.byref(p), img):
            raise RuntimeError("opj_setup_encoder refused the frame")
        mem = _Memory(L)
        if not (L.opj_start_compress(codec, img, mem.stream)
                and L.opj_encode(codec, mem.stream)
                and L.opj_end_compress(codec, mem.stream)):
            raise RuntimeError("OpenJPEG failed to encode the frame")
        data = bytes(mem.buf)
    finally:
        if mem is not None:
            L.opj_stream_destroy(mem.stream)
        if codec:
            L.opj_destroy_codec(codec)
        L.opj_image_destroy(img)
    check(data, (h, w), max_cs, max_comp)
    return data


def opj_decode(data: bytes) -> np.ndarray:
    """OpenJPEG's own decode of a 3-component codestream: [H, W, 3] uint16
    samples (inverse ICT and DC shift its own, clamped to the depth)."""
    L = _lib()
    params = ctypes.create_string_buffer(1 << 16)
    codec = L.opj_create_decompress(OPJ_CODEC_J2K)
    mem = _Memory(L, data)
    img = ctypes.POINTER(_Image)()
    try:
        L.opj_set_default_decoder_parameters(params)
        if not (L.opj_setup_decoder(codec, params)
                and L.opj_read_header(mem.stream, codec, ctypes.byref(img))
                and L.opj_decode(codec, mem.stream, img)
                and L.opj_end_decompress(codec, mem.stream)):
            raise ValueError("OpenJPEG failed to decode the codestream")
        im = img.contents
        comps = [im.comps[c] for c in range(im.numcomps)]
        out = np.stack([np.ctypeslib.as_array(k.data, (k.h, k.w)).copy()
                        for k in comps], axis=-1)
        return out.astype(np.uint16)
    finally:
        if img:
            L.opj_image_destroy(img)
        L.opj_stream_destroy(mem.stream)
        L.opj_destroy_codec(codec)


# ------------------------------------------------------------ the checks
class Markers(NamedTuple):
    """What `check` read of a codestream."""
    rsiz: int
    size: Tuple[int, int]  # (height, width)
    depths: Tuple[int, ...]
    signed: Tuple[bool, ...]
    progression: int
    layers: int
    mct: int
    levels: int
    cblk: Tuple[int, int]  # (width, height)
    style: int
    transform: int  # 0: 9/7, 1: 5/3
    precincts: Tuple[Tuple[int, int], ...]  # (PPx, PPy) a resolution
    tile_parts: Tuple[int, ...]  # the bytes after SOD of each
    tlm: bool


def read_markers(data: bytes) -> Markers:
    """SIZ, COD and the tile-parts of a raw codestream (T.800 A.5-A.6)."""
    if data[:2] != b"\xff\x4f":
        raise ValueError("not a raw J2K codestream (no SOC)")
    pos, siz, cod, tlm = 2, None, None, False
    while True:
        marker, length = struct.unpack(">HH", data[pos:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xFF51:
            rsiz, xs, ys, xo, yo = struct.unpack(">HIIII", body[:18])
            ncomp = struct.unpack(">H", body[34:36])[0]
            ss = [body[36 + 3 * c] for c in range(ncomp)]
            siz = (rsiz, (ys - yo, xs - xo), tuple((s & 0x7F) + 1 for s in ss),
                   tuple(bool(s & 0x80) for s in ss))
        elif marker == 0xFF52:
            scod, prog, layers, mct, levels, xcb, ycb, style, tr = (
                struct.unpack(">BBHBBBBBB", body[:10]))
            pp = tuple((b & 0xF, b >> 4) for b in body[10:11 + levels]) \
                if scod & 1 else ()
            cod = (prog, layers, mct, levels, (1 << (xcb + 2), 1 << (ycb + 2)),
                   style, tr, pp)
        elif marker == 0xFF55:
            tlm = True
        elif marker == 0xFF90:
            break
        pos += 2 + length
    if siz is None or cod is None:
        raise ValueError("no SIZ or no COD before the first tile-part")
    parts = []
    while data[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack(">I", data[pos + 6:pos + 10])[0]
        if psot == 0:
            psot = len(data) - 2 - pos
        # the tile-part header's marker segments, then SOD and the data
        at = pos + 12
        while data[at:at + 2] != b"\xff\x93":
            if at >= pos + psot:
                raise ValueError("a tile-part without SOD")
            at += 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
        parts.append(pos + psot - (at + 2))
        pos += psot
    if data[pos:pos + 2] != b"\xff\xd9":
        raise ValueError("the tile-parts do not end at EOC")
    return Markers(*siz, *cod, tuple(parts), tlm)


def check(data: bytes, shape: Tuple[int, int], max_cs: int,
          max_comp: int) -> Markers:
    """Raises ValueError unless `data` is a Profile-3 2K codestream of a
    frame of `shape` (height, width) as the cell states it: Rsiz 0x0003,
    three unsigned 12-bit components, CPRL, one layer, ICT, 5 levels, 32x32
    code-blocks, no mode switch, 9/7, precincts 128x128 at the LL
    resolution and 256x256 above it, three tile-parts, at most `max_cs`
    bytes in all (of tile-part data below 2K) and `max_comp` of data a
    tile-part (a component's packets, which OpenJPEG's cinema rate control
    bounds)."""
    m = read_markers(data)
    want = dict(rsiz=OPJ_PROFILE_CINEMA_2K, size=tuple(shape),
                depths=(DEPTH,) * 3, signed=(False,) * 3, progression=4,
                layers=1, mct=1, levels=LEVELS, cblk=(32, 32), style=0,
                transform=0, precincts=((7, 7),) + ((8, 8),) * LEVELS)
    bad = {k: (getattr(m, k), v) for k, v in want.items()
           if getattr(m, k) != v}
    if len(m.tile_parts) != 3:
        bad["tile_parts"] = (len(m.tile_parts), 3)
    # a 2K frame's whole codestream; a smaller frame's data (its headers
    # do not shrink with it)
    frame = len(data) if tuple(shape) == FRAME else sum(m.tile_parts)
    if frame > max_cs:
        bad["bytes"] = (frame, max_cs)
    if max(m.tile_parts, default=0) > max_comp:
        bad["tile_part_bytes"] = (max(m.tile_parts), max_comp)
    if bad:
        raise ValueError("not a Profile-3 2K codestream of the cell: "
                         + ", ".join(f"{k} {got} (want {v})"
                                     for k, (got, v) in bad.items()))
    return m


# ------------------------------------------------------- from the corpus
def frame(jpeg: bytes) -> np.ndarray:
    """The 12-bit X'Y'Z' frame of a JPEG stream of the pool."""
    return xyz12(source_pixels(jpeg))


def convert(jpeg: bytes) -> bytes:
    """The checked Profile-3 codestream of a JPEG stream's frame."""
    return encode(frame(jpeg))


def answer(jpeg: bytes) -> np.ndarray:
    """OpenJPEG's decode of `convert(jpeg)`: what the cell's check holds
    the program to."""
    return opj_decode(convert(jpeg))


class Converter:
    """`convert` (or another function of a JPEG stream) over worker
    processes that start at once (at most `workers`, one a core by
    default); `close()` ends them."""

    def __init__(self, workers: int = 0):
        workers = workers or os.cpu_count() or 1
        self.pool = ProcessPoolExecutor(workers,
                                        mp_context=get_context("spawn"))

    def map(self, jpegs, fn=convert):
        return list(self.pool.map(fn, jpegs))

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None
