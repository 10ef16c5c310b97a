"""TIFF decoder: strips + tiles, LZW/Deflate/PackBits, predictor, palette,
planar configs, 1/4/8/16-bit — the feature envelope of the reference's
libtiff extension (reference: extensions/libtiff/libtiff_decoder.cpp —
scanline/tile paths, palette, planar configs, bitdepth conversion).

CPU backend like the reference's (libtiff ext is CPU_ONLY NORMAL priority).
The serial decompression (LZW) is native C++ (native/tiff_lzw.cpp) with a
Python fallback; predictor undo and layout assembly are vectorized numpy.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeResult,
    EncoderPlugin,
)
from ..core.types import BackendKind, Priority, ProcessingStatus

# tag ids
T_WIDTH, T_HEIGHT = 256, 257
T_BPS, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_FILLORDER = 266
T_STRIP_OFFSETS, T_ORIENTATION, T_SPP, T_ROWS_PER_STRIP, T_STRIP_COUNTS = (
    273, 274, 277, 278, 279,
)
T_PLANAR, T_PREDICTOR, T_COLORMAP = 284, 317, 320
T_T4_OPTIONS, T_T6_OPTIONS = 292, 293
T_TILE_W, T_TILE_H, T_TILE_OFFSETS, T_TILE_COUNTS = 322, 323, 324, 325
T_EXTRA_SAMPLES, T_SAMPLE_FORMAT = 338, 339
T_JPEG_TABLES = 347
T_JPEG_IF, T_JPEG_IF_LEN = 513, 514  # old-style (compression 6) JPEG

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8}


def _read_ifd(data: bytes, le: bool) -> Dict[int, list]:
    e = "<" if le else ">"
    (ifd_off,) = struct.unpack_from(e + "I", data, 4)
    tags: Dict[int, list] = {}
    (count,) = struct.unpack_from(e + "H", data, ifd_off)
    for i in range(count):
        off = ifd_off + 2 + 12 * i
        tag, typ, n = struct.unpack_from(e + "HHI", data, off)
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= 4:
            voff = off + 8
        else:
            (voff,) = struct.unpack_from(e + "I", data, off + 8)
        if typ == 3:
            vals = list(struct.unpack_from(e + f"{n}H", data, voff))
        elif typ == 4:
            vals = list(struct.unpack_from(e + f"{n}I", data, voff))
        elif typ == 1:
            vals = list(data[voff : voff + n])
        elif typ == 8:
            vals = list(struct.unpack_from(e + f"{n}h", data, voff))
        elif typ == 9:
            vals = list(struct.unpack_from(e + f"{n}i", data, voff))
        else:
            vals = [data[voff : voff + size]]
        tags[tag] = vals
    return tags


def _unpackbits(src: bytes, expected: int) -> bytes:
    """PackBits (Apple RLE) decompression — TIFF 6.0 spec §9."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expected:
        b = src[i]
        i += 1
        if b < 128:
            out += src[i : i + b + 1]
            i += b + 1
        elif b > 128:
            out += bytes([src[i]]) * (257 - b)
            i += 1
        # 128: no-op
    return bytes(out[:expected])


def _lzw_decode_py(src: bytes, expected: int) -> bytes:
    """Python TIFF-LZW fallback (spec §13, MSB-first, early change)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    acc = nbits = 0
    prev: Optional[bytes] = None
    for byte in src:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 257:  # EOI
                return bytes(out[:expected])
            if code == 256:  # Clear
                table = table[:258]
                width = 9
                prev = None
                continue
            if code < len(table):
                entry = table[code]
            elif code == len(table) and prev is not None:
                entry = prev + prev[:1]
            else:
                raise ValueError("LZW: bad code")
            out += entry
            if prev is not None:
                table.append(prev + entry[:1])
                if len(table) + 1 == (1 << width) and width < 12:
                    width += 1
            prev = entry
            if len(out) >= expected:
                return bytes(out[:expected])
    return bytes(out[:expected])


def _lzw_decode(src: bytes, expected: int) -> bytes:
    try:
        import ctypes

        from ..native import lib

        L = lib()
    except Exception:
        return _lzw_decode_py(src, expected)
    dst = ctypes.create_string_buffer(expected)
    n = L.tic_tiff_lzw_decode(src, len(src), dst, expected)
    if n < 0:
        raise ValueError("LZW: malformed stream")
    return dst.raw[:n]


def _decompress(src: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return src[:expected]
    if compression == 5:
        return _lzw_decode(src, expected)
    if compression in (8, 32946):  # Deflate (Adobe / legacy)
        return zlib.decompress(src)[:expected]
    if compression == 32773:
        return _unpackbits(src, expected)
    raise ValueError(f"TIFF: unsupported compression {compression}")


_BITREV = None


def _bitrev(src: bytes) -> bytes:
    """FillOrder 2 (LSB-first) → MSB-first byte bit reversal."""
    global _BITREV
    if _BITREV is None:
        _BITREV = np.array(
            [int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8
        )
    return _BITREV[np.frombuffer(src, np.uint8)].tobytes()


def _fax_decode_rows(src: bytes, w: int, nrows: int, compression: int,
                     opts: int, fill_order: int) -> bytes:
    """CCITT MH/G3/G4 strip → packed 1-bit rows (native/tiff_fax.cpp).

    Covers the fax-class compressions the reference's libtiff extension
    decodes (extensions/libtiff/libtiff_decoder.cpp hands compression 2/3/4
    entirely to libtiff). Returns (w+7)//8 * nrows bytes, bit 1 = black —
    the MINISWHITE convention, inverted by the photometric-0 handling."""
    import ctypes

    from ..native import lib

    if fill_order == 2:
        src = _bitrev(src)
    rowbytes = (w + 7) // 8
    dst = np.zeros(nrows * rowbytes, np.uint8)
    L = lib()
    n = L.tic_tiff_fax_decode(
        src, len(src), w, nrows, compression, opts,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise ValueError("TIFF: malformed CCITT fax data")
    return dst.tobytes()


def _merge_jpeg_tables(tables: Optional[bytes], strip: bytes) -> bytes:
    """Combine the JPEGTables tag stream with a per-strip abbreviated JPEG
    (TIFF TechNote 2): tables is SOI..EOI carrying DQT/DHT; the strip's SOI
    is replaced by SOI + table segments."""
    if not tables or len(tables) < 4:
        return strip
    body = tables[2:]
    if body[-2:] == b"\xff\xd9":
        body = body[:-2]
    if strip[:2] == b"\xff\xd8":
        return b"\xff\xd8" + body + strip[2:]
    return b"\xff\xd8" + body + strip + b"\xff\xd9"


def _decode_jpeg_unit(stream: bytes, rgb_direct: bool = False) -> np.ndarray:
    """Decode one JPEG-compressed strip/tile via the native JPEG path.

    rgb_direct: photometric 2 — components are stored R,G,B (no YCbCr
    transform), so assemble planes without the colour conversion."""
    from .jpeg import _entropy_decode
    from .jpeg.headers import parse_jpeg_structure
    from .jpeg.pixel import decode_pixels

    import torch

    frame = parse_jpeg_structure(stream)
    coefs = [torch.from_numpy(c) for c in _entropy_decode(frame, stream)]
    if rgb_direct and len(frame.components) == 3:
        from ..ops import resample as resample_ops
        from .jpeg.pixel import idct_planes

        planes = idct_planes(frame, coefs)
        H, W = frame.height, frame.width
        full = []
        for c, plane in zip(frame.components, planes):
            vf, hf = frame.vmax // c.v, frame.hmax // c.h
            p = resample_ops.upsample_to(plane, vf, hf)
            full.append(p[..., :H, :W].numpy())
        return np.clip(np.stack(full, axis=-1), 0, 255).astype(np.uint8)
    return decode_pixels(frame, coefs).numpy()


def _undo_predictor_fp(rows: np.ndarray, spp: int) -> np.ndarray:
    """Predictor 3 (TIFF TechNote: floating-point horizontal differencing)
    undo: byte-delta accumulate with stride spp over the scanline, then
    reassemble the per-row byte planes (MSB plane first) into IEEE floats.
    rows: [h, rowbytes] u8 → float32 [h, rowbytes // 4]."""
    h, rb = rows.shape
    acc = rows.copy()
    for s in range(spp):
        acc[:, s::spp] = np.cumsum(
            acc[:, s::spp].astype(np.int64), axis=1).astype(np.uint8)
    wc = rb // 4
    planes = acc.reshape(h, 4, wc)
    be = np.ascontiguousarray(planes.transpose(0, 2, 1))  # [h, wc, 4] MSB..
    return be.reshape(h, wc * 4).view(">f4").astype(np.float32)


def _undo_predictor(rows: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing undo: cumulative sum along x per channel
    (vectorized; wraps naturally in the sample dtype)."""
    h, w = rows.shape[:2]
    r = rows.reshape(h, w // spp, spp) if spp > 1 else rows[:, :, None]
    r = np.cumsum(r.astype(np.int64), axis=1)
    return (r % (1 << (rows.itemsize * 8))).astype(rows.dtype).reshape(h, w)


class TiffDirectory:
    """One parsed IFD with decode geometry."""

    def __init__(self, data: bytes):
        if data[:2] == b"II":
            self.le = True
        elif data[:2] == b"MM":
            self.le = False
        else:
            raise ValueError("not a TIFF")
        self.data = data
        t = _read_ifd(data, self.le)
        self.tags = t
        self.width = t[T_WIDTH][0]
        self.height = t[T_HEIGHT][0]
        self.spp = t.get(T_SPP, [1])[0]
        bps = t.get(T_BPS, [1])
        if len(set(bps)) > 1:
            raise ValueError("TIFF: heterogeneous BitsPerSample")
        self.bps = bps[0]
        self.compression = t.get(T_COMPRESSION, [1])[0]
        self.photometric = t.get(T_PHOTOMETRIC, [1])[0]
        self.planar = t.get(T_PLANAR, [1])[0]
        self.predictor = t.get(T_PREDICTOR, [1])[0]
        self.fill_order = t.get(T_FILLORDER, [1])[0]
        self.sample_format = t.get(T_SAMPLE_FORMAT, [1])[0]
        self.orientation = t.get(T_ORIENTATION, [1])[0]
        self.tiled = T_TILE_OFFSETS in t
        self.colormap = t.get(T_COLORMAP)
        self.t4_options = t.get(T_T4_OPTIONS, [0])[0]
        self.t6_options = t.get(T_T6_OPTIONS, [0])[0]
        jt = t.get(T_JPEG_TABLES)
        self.jpeg_tables = bytes(jt[0]) if jt else None


def decode_tiff(data: bytes, region=None, work=None) -> np.ndarray:
    """Decode the first IFD to [H, W(, C)] u8/u16 natural samples.

    region: optional (y0, x0, y1, x1) true-ROI decode — only strips/tiles
    that intersect the region are decompressed; returns exactly the region
    (reference analog: the libtiff extension's region decode,
    extensions/libtiff/libtiff_decoder.cpp). Bit-identical to cropping a
    full decode (strip rows are predictor-independent; predictor-2 rows are
    undone full-width before the column crop).

    work: optional dict, filled with {"units": decompressed strip/tile
    count, "units_total": total in the file} — lets tests assert ROI skips
    work without flaky wall-clock timing."""
    d = TiffDirectory(data)
    W, H, spp, bps = d.width, d.height, d.spp, d.bps
    is_float = bps == 32 and d.sample_format == 3
    if bps not in (1, 2, 4, 8, 16) and not is_float:
        raise ValueError(
            f"TIFF: unsupported BitsPerSample {bps} "
            f"(SampleFormat {d.sample_format})")
    dtype = (np.float32 if is_float
             else np.uint16 if bps == 16 else np.uint8)
    e = "<" if d.le else ">"
    if d.compression in (2, 3, 4) and (bps != 1 or spp != 1):
        raise ValueError("TIFF: CCITT compression requires bilevel data")
    if d.photometric == 6 and d.compression not in (6, 7):
        raise ValueError("TIFF: raw YCbCr (photometric 6) unsupported")

    nplanes = spp if d.planar == 2 else 1
    cpp = 1 if d.planar == 2 else spp  # channels per stored plane

    if region is not None:
        ry0, rx0, ry1, rx1 = region
        ry0, rx0 = max(0, int(ry0)), max(0, int(rx0))
        ry1, rx1 = min(H, int(ry1)), min(W, int(rx1))
        if not (ry0 < ry1 and rx0 < rx1):
            raise ValueError("TIFF: empty region")
    else:
        ry0, rx0, ry1, rx1 = 0, 0, H, W
    rh, rw = ry1 - ry0, rx1 - rx0

    def bits_to_bytes(nbits: int) -> int:
        return (nbits + 7) // 8

    def expand_row_bytes(raw: np.ndarray, width_samples: int) -> np.ndarray:
        """Packed row bytes [h, rowbytes] → samples [h, width_samples]."""
        if bps == 8:
            return raw[:, :width_samples]
        if bps == 16:
            arr = raw.reshape(raw.shape[0], -1).view(e + "u2")
            return arr[:, :width_samples].astype(np.uint16)
        if bps == 32:
            arr = raw.reshape(raw.shape[0], -1).view(e + "f4")
            return arr[:, :width_samples].astype(np.float32)
        per = 8 // bps
        shifts = (np.arange(per - 1, -1, -1) * bps).astype(np.uint8)
        expanded = (raw[:, :, None] >> shifts[None, None, :]) & ((1 << bps) - 1)
        return expanded.reshape(raw.shape[0], -1)[:, :width_samples]

    # Old-style JPEG (compression 6) with a whole-image interchange stream
    # (tags 513/514): decode once, crop (reference: libtiff's OJPEG codec).
    if d.compression == 6 and T_JPEG_IF in d.tags:
        off = d.tags[T_JPEG_IF][0]
        ln = d.tags.get(T_JPEG_IF_LEN, [len(data) - off])[0]
        img = _decode_jpeg_unit(data[off:off + ln],
                                rgb_direct=(d.photometric == 2))
        img = img[ry0:ry1, rx0:rx1]
        if work is not None:
            work["units"] = work["units_total"] = 1
        if d.photometric == 0:
            img = (255 - img).astype(np.uint8)
        return img

    jpeg_unit = d.compression in (6, 7)

    def decode_unit(src: bytes, uw: int, uh: int, unit_rowbytes: int):
        """One strip/tile → samples [uh, uw*cpp] in natural dtype."""
        if jpeg_unit:
            u = _decode_jpeg_unit(_merge_jpeg_tables(d.jpeg_tables, src),
                                  rgb_direct=(d.photometric == 2))
            if u.ndim == 2:
                u = u[:, :, None]
            s = np.zeros((uh, uw, cpp), np.uint8)
            ch = min(uh, u.shape[0])
            cw = min(uw, u.shape[1])
            s[:ch, :cw] = u[:ch, :cw, :cpp]
            return s.reshape(uh, uw * cpp)
        if d.compression in (2, 3, 4):
            opts = d.t4_options if d.compression == 3 else d.t6_options
            raw = _fax_decode_rows(src, uw, uh, d.compression, opts,
                                   d.fill_order)
        else:
            raw = _decompress(src, d.compression, unit_rowbytes * uh)
            raw = raw.ljust(unit_rowbytes * uh, b"\0")
        rows = np.frombuffer(raw, np.uint8).reshape(uh, unit_rowbytes)
        if d.predictor == 3:
            if not is_float:
                raise ValueError("TIFF: predictor 3 requires float samples")
            return _undo_predictor_fp(rows, cpp)[:, :uw * cpp]
        samples = expand_row_bytes(rows, uw * cpp)
        if d.predictor == 2:
            samples = _undo_predictor(samples.astype(dtype), cpp)
        return samples

    planes = None  # allocated when a unit loop needs it (the fast path
    units = units_total = 0  # below builds it from one buffer view)

    if d.tiled:
        planes = np.zeros((nplanes, rh, rw * cpp), dtype)
        tw = d.tags[T_TILE_W][0]
        th = d.tags[T_TILE_H][0]
        offsets = d.tags[T_TILE_OFFSETS]
        counts = d.tags[T_TILE_COUNTS]
        tiles_x = (W + tw - 1) // tw
        tiles_y = (H + th - 1) // th
        rowbytes = bits_to_bytes(tw * cpp * bps)
        units_total = nplanes * tiles_y * tiles_x
        for s in range(nplanes):
            for ty in range(tiles_y):
                iy0 = max(ry0, ty * th)
                iy1 = min(ry1, min(H, (ty + 1) * th))
                if iy0 >= iy1:
                    continue
                for tx in range(tiles_x):
                    ix0 = max(rx0, tx * tw)
                    ix1 = min(rx1, min(W, (tx + 1) * tw))
                    if ix0 >= ix1:
                        continue
                    idx = (s * tiles_y + ty) * tiles_x + tx
                    src = data[offsets[idx] : offsets[idx] + counts[idx]]
                    samples = decode_unit(src, tw, th, rowbytes)
                    units += 1
                    planes[s, iy0 - ry0 : iy1 - ry0,
                           (ix0 - rx0) * cpp : (ix1 - rx0) * cpp] = samples[
                        iy0 - ty * th : iy1 - ty * th,
                        (ix0 - tx * tw) * cpp : (ix1 - tx * tw) * cpp]
    else:
        offsets = d.tags[T_STRIP_OFFSETS]
        counts = d.tags.get(T_STRIP_COUNTS, [len(data) - offsets[0]])
        rps = d.tags.get(T_ROWS_PER_STRIP, [H])[0]
        rps = min(rps, H)
        strips_per_plane = (H + rps - 1) // rps
        rowbytes = bits_to_bytes(W * cpp * bps)
        units_total = nplanes * strips_per_plane
        # uncompressed strips laid out back-to-back: the whole plane is
        # ONE buffer view + reshape instead of a per-strip python loop
        # with two copies each (libtiff reads these at memcpy speed; we
        # were 3x behind on exactly this layout)
        need = H * rowbytes
        if (d.compression == 1 and not jpeg_unit and region is None
                and nplanes == 1 and d.predictor in (1, 2)
                and len(offsets) >= strips_per_plane
                and len(counts) >= strips_per_plane
                and offsets[0] + need <= len(data)
                # every strip must carry EXACTLY its rows (StripByteCounts
                # with trailing padding would shift later rows) and sit
                # back-to-back in the file
                and all(counts[k] == min(rps, H - k * rps) * rowbytes
                        for k in range(strips_per_plane))
                and all(offsets[k + 1] == offsets[k] + counts[k]
                        for k in range(strips_per_plane - 1))):
            rows = np.frombuffer(data, np.uint8, need,
                                 offsets[0]).reshape(H, rowbytes)
            samples = expand_row_bytes(rows, W * cpp)
            if d.predictor == 2:
                samples = _undo_predictor(samples.astype(dtype), cpp)
            # samples may be a read-only view of the input bytes —
            # materialize one writable copy (the only copy on this path)
            planes = np.ascontiguousarray(samples)
            if not planes.flags.writeable:
                planes = planes.copy()
            planes = planes.reshape(1, rh, rw * cpp)
            units = units_total
            strips_per_plane = 0  # loop below: nothing left to do
        if planes is None:
            planes = np.zeros((nplanes, rh, rw * cpp), dtype)
        for s in range(nplanes):
            for si in range(strips_per_plane):
                y0 = si * rps
                nrows = min(rps, H - y0)
                iy0, iy1 = max(ry0, y0), min(ry1, y0 + nrows)
                if iy0 >= iy1:
                    continue  # strip outside the region: never decompressed
                idx = s * strips_per_plane + si
                src = data[offsets[idx] : offsets[idx] + counts[idx]]
                samples = decode_unit(src, W, nrows, rowbytes)
                units += 1
                planes[s, iy0 - ry0 : iy1 - ry0] = samples[
                    iy0 - y0 : iy1 - y0, rx0 * cpp : rx1 * cpp]

    if work is not None:
        work["units"] = units
        work["units_total"] = units_total

    # assemble channels
    if d.planar == 2:
        img = np.stack([planes[s].reshape(rh, rw) for s in range(spp)], axis=-1)
    else:
        img = planes[0].reshape(rh, rw, spp)

    # photometric handling
    if d.photometric == 0:  # white-is-zero
        maxv = (1 << bps) - 1
        img = (maxv - img).astype(dtype)
    elif d.photometric == 3:  # palette
        if d.colormap is None:
            raise ValueError("TIFF: palette image without ColorMap")
        cm = np.asarray(d.colormap, np.uint32)
        n = len(cm) // 3
        lut = (cm.reshape(3, n).T >> 8).astype(np.uint8)  # 16-bit → 8-bit
        img = lut[img[..., 0].astype(np.int32)]
        return img

    if bps in (1, 2, 4) and d.photometric in (0, 1):
        img = (img * (255 // ((1 << bps) - 1))).astype(np.uint8)

    if img.shape[-1] == 1:
        img = img[..., 0]
    return img


# ------------------------------------------------------------------ encode
def encode_tiff(img: np.ndarray, compression: int = 8,
                rows_per_strip: int = 64) -> bytes:
    """Encode [H,W] / [H,W,C] u8/u16 → little-endian TIFF (strips; 
    compression 1 = none or 8 = Deflate). The reference has no TIFF encoder
    (its matrix is bmp/pnm/jpeg/jpeg2k); provided for drop-in completeness.
    """
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    bd = 16 if img.dtype == np.uint16 else 8
    body = np.ascontiguousarray(img)
    if bd == 16:
        body = body.astype("<u2")

    strips = []
    for y0 in range(0, h, rows_per_strip):
        raw = body[y0 : y0 + rows_per_strip].tobytes()
        strips.append(zlib.compress(raw) if compression == 8 else raw)

    extra = ch in (2, 4)  # alpha channel → ExtraSamples tag
    ntags = 11 + (1 if extra else 0)
    # layout: header(8) + IFD + offset arrays + pixel data
    ifd_off = 8
    after_ifd = ifd_off + 2 + ntags * 12 + 4
    nstrips = len(strips)
    counts_off = after_ifd
    offsets_off = counts_off + 4 * nstrips
    data_off = offsets_off + 4 * nstrips
    strip_offsets = []
    pos = data_off
    for sdata in strips:
        strip_offsets.append(pos)
        pos += len(sdata)

    def tag(tid, typ, n, val):
        return struct.pack("<HHI", tid, typ, n) + val

    def short(v):
        return struct.pack("<HH", v, 0)

    def long_(v):
        return struct.pack("<I", v)

    bps_off = None
    entries = []
    entries.append(tag(256, 3, 1, short(w)))
    entries.append(tag(257, 3, 1, short(h)))
    if ch == 1:
        entries.append(tag(258, 3, 1, short(bd)))
    else:
        # per-channel BitsPerSample array lives after strip offsets
        bps_off = pos
        entries.append(tag(258, 3, ch, long_(bps_off)))
        pos += 2 * ch
    entries.append(tag(259, 3, 1, short(compression)))
    entries.append(tag(262, 3, 1, short(2 if ch >= 3 else 1)))
    entries.append(tag(273, 4, nstrips, long_(
        offsets_off if nstrips > 1 else strip_offsets[0])))
    entries.append(tag(277, 3, 1, short(ch)))
    entries.append(tag(278, 3, 1, short(rows_per_strip)))
    entries.append(tag(279, 4, nstrips, long_(
        counts_off if nstrips > 1 else len(strips[0]))))
    entries.append(tag(284, 3, 1, short(1)))
    if extra:
        entries.append(tag(338, 3, 1, short(2)))  # unassociated alpha
    entries.append(tag(339, 3, 1, short(1)))  # unsigned integer samples

    out = bytearray(b"II*\x00" + struct.pack("<I", ifd_off))
    out += struct.pack("<H", ntags) + b"".join(entries) + struct.pack("<I", 0)
    for sdata in strips:
        out += struct.pack("<I", len(sdata))
    for off in strip_offsets:
        out += struct.pack("<I", off)
    for sdata in strips:
        out += sdata
    if bps_off is not None:
        out += struct.pack(f"<{ch}H", *([bd] * ch))
    return bytes(out)


class TiffEncoder(EncoderPlugin):
    codec = "tiff"
    plugin_id = "cpu_tiff_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_encode(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            a = np.asarray(img)
            ok = a.dtype in (np.uint8, np.uint16) and (
                a.ndim == 2 or (a.ndim == 3 and a.shape[-1] in (1, 2, 3, 4))
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params):
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(
                        ProcessingStatus.SUCCESS, encode_tiff(np.asarray(img))
                    )
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


class TiffCpuDecoder(DecoderPlugin):
    codec = "tiff"
    plugin_id = "cpu_tiff_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            head = bytes(data[:4])
            ok = head in (b"II*\x00", b"MM\x00*")
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                # true ROI: skip strips/tiles outside the region (reference:
                # libtiff extension region decode). Declined on rotated
                # images — the region is in display space, strips are in
                # stream space (same policy as the JPEG codec).
                region = None
                if params.enable_roi and params.region is not None:
                    o = getattr(info, "orientation", None)
                    if (not params.apply_exif_orientation or o is None
                            or int(o) == 1):
                        rg = params.region
                        region = (rg.start_y, rg.start_x, rg.end_y, rg.end_x)
                img = decode_tiff(bytes(data), region=region)
                if not params.allow_any_depth and img.dtype == np.uint16:
                    img = (img >> 8).astype(np.uint8)
                out.append(DecodeResult(ProcessingStatus.SUCCESS, img))
            except Exception as exc:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(exc),
                    )
                )
        return out


def register(registry) -> None:
    registry.codec("tiff").register_decoder(TiffCpuDecoder())
    registry.codec("tiff").register_encoder(TiffEncoder())
