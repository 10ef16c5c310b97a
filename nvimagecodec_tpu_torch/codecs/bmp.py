"""BMP decode/encode (CPU backend).

Counterpart of the reference's example BMP extension
(reference: extensions/nvbmp/{decoder,encoder}.cpp — 8-bit BMP read/write in
P_RGB/I_RGB). Ours goes further, matching what the reference gets from its
OpenCV fallback (extensions/opencv/opencv_decoder.cpp): 1/4/8-bit palette,
16/24/32 bpp, top-down and bottom-up rows, RLE8 — vectorized with numpy;
pixel data for BMP is uncompressed so there is no device win to chase here.
"""
from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from ..core.image_info import ImageInfo
from ..core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeParams,
    EncodeResult,
    EncoderPlugin,
)
from ..core.types import BackendKind, Priority, ProcessingStatus


def decode_bmp(data: memoryview) -> np.ndarray:
    raw = bytes(data)
    magic, _fsize, _r1, _r2, data_offset = struct.unpack_from("<2sIHHI", raw, 0)
    if magic != b"BM":
        raise ValueError("not a BMP")
    (hdr_size,) = struct.unpack_from("<I", raw, 14)
    compression = 0
    ncolors = 0
    if hdr_size == 12:
        w, h, _planes, bpp = struct.unpack_from("<HHHH", raw, 18)
        topdown = False
        pal_entry = 3
    else:
        w, h, _planes, bpp, compression = struct.unpack_from("<iiHHI", raw, 18)
        (ncolors,) = struct.unpack_from("<I", raw, 46)
        topdown = h < 0
        h = abs(h)
        pal_entry = 4

    pal = None
    if bpp <= 8:
        n = ncolors or (1 << bpp)
        pal_off = 14 + hdr_size
        pal_raw = np.frombuffer(raw, np.uint8, n * pal_entry, pal_off)
        pal = pal_raw.reshape(n, pal_entry)[:, :3][:, ::-1]  # BGR(A) → RGB

    if compression == 1:  # RLE8
        idx = _decode_rle8(raw[data_offset:], w, h)
        img = pal[idx]
        if not topdown:
            img = img[::-1]
        return _collapse_gray(img)
    if compression not in (0, 3):
        raise ValueError(f"unsupported BMP compression {compression}")

    row_bytes = (w * bpp + 31) // 32 * 4
    rows = np.frombuffer(raw, np.uint8, row_bytes * h, data_offset).reshape(h, row_bytes)
    if bpp == 24:
        img = rows[:, : w * 3].reshape(h, w, 3)[:, :, ::-1]
    elif bpp == 32:
        img = rows[:, : w * 4].reshape(h, w, 4)[:, :, [2, 1, 0, 3]][:, :, :3]
    elif bpp == 16:
        px = rows[:, : w * 2].reshape(h, w, 2).astype(np.uint16)
        v = px[..., 0] | (px[..., 1] << 8)
        r = ((v >> 10) & 31) * 255 // 31
        g = ((v >> 5) & 31) * 255 // 31
        b = (v & 31) * 255 // 31
        img = np.stack([r, g, b], -1).astype(np.uint8)
    elif bpp == 8:
        img = pal[rows[:, :w]]
    elif bpp == 4:
        hi = rows >> 4
        lo = rows & 0xF
        idx = np.empty((h, row_bytes * 2), np.uint8)
        idx[:, 0::2] = hi
        idx[:, 1::2] = lo
        img = pal[idx[:, :w]]
    elif bpp == 1:
        bits = np.unpackbits(rows, axis=1)
        img = pal[bits[:, :w]]
    else:
        raise ValueError(f"unsupported BMP bpp {bpp}")

    if not topdown:
        img = img[::-1]
    return _collapse_gray(np.ascontiguousarray(img))


def _collapse_gray(img: np.ndarray) -> np.ndarray:
    """Palette images whose palette is gray collapse to one channel
    (parity with the parser's channel count)."""
    if img.ndim == 3 and img.shape[2] == 3:
        if np.array_equal(img[..., 0], img[..., 1]) and np.array_equal(
            img[..., 1], img[..., 2]
        ):
            return np.ascontiguousarray(img[..., 0])
    return img


def _decode_rle8(raw: bytes, w: int, h: int) -> np.ndarray:
    out = np.zeros((h, w), np.uint8)
    x = y = i = 0
    n = len(raw)
    while i + 1 < n and y < h:
        cnt, val = raw[i], raw[i + 1]
        i += 2
        if cnt > 0:
            end = min(x + cnt, w)
            out[y, x:end] = val
            x = end
        elif val == 0:  # end of line
            x, y = 0, y + 1
        elif val == 1:  # end of bitmap
            break
        elif val == 2:  # delta
            x += raw[i]
            y += raw[i + 1]
            i += 2
        else:  # absolute run
            m = min(val, w - x)
            out[y, x : x + m] = np.frombuffer(raw, np.uint8, m, i)
            x += m
            i += val + (val & 1)
    return out


def encode_bmp(img: np.ndarray) -> bytes:
    """24bpp (RGB) / 8bpp-gray BMP writer
    (reference: extensions/nvbmp/encoder.cpp)."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if img.dtype != np.uint8:
        raise ValueError("BMP encoder supports uint8 only")
    if c == 1:
        row_bytes = (w + 3) // 4 * 4
        pal = bytes(bytearray().join(bytes([i, i, i, 0]) for i in range(256)))
        pixel_off = 14 + 40 + len(pal)
        rows = np.zeros((h, row_bytes), np.uint8)
        rows[:, :w] = img[::-1, :, 0]
        hdr = struct.pack("<2sIHHI", b"BM", pixel_off + rows.nbytes, 0, 0, pixel_off)
        dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.nbytes, 2835, 2835, 256, 0)
        return hdr + dib + pal + rows.tobytes()
    if c != 3:
        raise ValueError("BMP encoder supports 1 or 3 channels")
    row_bytes = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    pixel_off = 14 + 40
    hdr = struct.pack("<2sIHHI", b"BM", pixel_off + rows.nbytes, 0, 0, pixel_off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.nbytes, 2835, 2835, 0, 0)
    return hdr + dib + rows.tobytes()


class BmpDecoder(DecoderPlugin):
    codec = "bmp"
    plugin_id = "tpu_bmp_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        return [ProcessingStatus.SUCCESS] * len(data_batch)

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                out.append(DecodeResult(ProcessingStatus.SUCCESS, decode_bmp(data)))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class BmpEncoder(EncoderPlugin):
    codec = "bmp"
    plugin_id = "tpu_bmp_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for img in image_batch:
            ok = np.asarray(img).dtype == np.uint8
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        out = []
        for img in image_batch:
            try:
                out.append(
                    EncodeResult(ProcessingStatus.SUCCESS, encode_bmp(np.asarray(img)))
                )
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out
