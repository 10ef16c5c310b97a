"""BMP header parser.

Counterpart of src/parsers/bmp.cpp (371 LoC): detects the "BM"
magic and handles core/info/v4/v5 header variants, palette detection, and
bpp → channel mapping.
"""
from __future__ import annotations

import struct

from ..core.image_info import ImageInfo, make_planes
from ..core.interfaces import ParserPlugin
from ..core.types import (
    ChromaSubsampling,
    ColorSpec,
    Priority,
    SampleDataType,
    SampleFormat,
)

_FILE_HEADER = struct.Struct("<2sIHHI")  # magic, file size, res, res, data offset


class BmpParser(ParserPlugin):
    codec = "bmp"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        return len(data) >= 18 and bytes(data[:2]) == b"BM"

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data[:256])
        (hdr_size,) = struct.unpack_from("<I", raw, 14)
        ncolors = 0
        if hdr_size == 12:  # BITMAPCOREHEADER
            w, h, _planes, bpp = struct.unpack_from("<HHHH", raw, 18)
        elif hdr_size >= 40:  # BITMAPINFOHEADER / v4 / v5
            w, h, _planes, bpp = struct.unpack_from("<iiHH", raw, 18)
            if hdr_size >= 40 and len(raw) >= 50:
                (ncolors,) = struct.unpack_from("<I", raw, 46)
            h = abs(h)
            w = abs(w)
        else:
            raise ValueError(f"unsupported BMP header size {hdr_size}")

        palette = bpp <= 8
        if palette:
            # palette entries expand to RGB unless the palette is gray
            nch = 3
        elif bpp == 16 or bpp == 24 or bpp == 32:
            nch = bpp // 8
        else:
            nch = 3
        # Grayscale palettes stay 1-channel (parity with reference bmp parser
        # which inspects palette entries; we check the common 8-bit case).
        if palette and bpp == 8 and hdr_size >= 40:
            pal_off = 14 + hdr_size
            n = ncolors or 256
            pal = bytes(data[pal_off : pal_off + 4 * n])
            if len(pal) == 4 * n and all(
                pal[4 * i] == pal[4 * i + 1] == pal[4 * i + 2] for i in range(n)
            ):
                nch = 1

        gray = nch == 1
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=nch,
            planes=make_planes(h, w, nch, SampleDataType.UINT8),
            sample_format=SampleFormat.P_Y if gray else SampleFormat.I_RGB,
            color_spec=ColorSpec.GRAY if gray else ColorSpec.SRGB,
            chroma_subsampling=ChromaSubsampling.GRAY if gray else ChromaSubsampling.NONE,
        )
