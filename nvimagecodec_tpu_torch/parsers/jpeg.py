"""JPEG header parser.

Counterpart of src/parsers/jpeg.cpp (448 LoC): SOI detect; marker
walk; SOF dims/precision/ncomp with sampling factors → chroma enum
(jpeg.cpp:70-114); EXIF APP1 orientation; Adobe APP14 transform → CMYK/YCCK;
SOF marker id → JpegEncoding (jpeg.cpp:346-353).
"""
from __future__ import annotations

import struct
from typing import Optional

from ..core.image_info import ImageInfo, PlaneInfo
from ..core.interfaces import ParserPlugin
from ..core.types import (
    ChromaSubsampling,
    ColorSpec,
    JpegEncoding,
    Orientation,
    Priority,
    SampleDataType,
    SampleFormat,
)
from .exif import parse_exif_orientation

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
_SOF_MARKERS = {
    0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF,
}


def sampling_to_css(factors) -> ChromaSubsampling:
    """Map per-component (h, v) sampling factors to the chroma enum
    (reference: src/parsers/jpeg.cpp:70-114)."""
    if len(factors) == 1:
        return ChromaSubsampling.GRAY
    if len(factors) not in (3, 4):
        return ChromaSubsampling.UNSUPPORTED
    (h0, v0), (h1, v1), (h2, v2) = factors[:3]
    if (h1, v1) != (h2, v2):
        return ChromaSubsampling.UNSUPPORTED
    ratio = (h0 // max(h1, 1), v0 // max(v1, 1))
    if h0 % max(h1, 1) or v0 % max(v1, 1):
        return ChromaSubsampling.UNSUPPORTED
    return {
        (1, 1): ChromaSubsampling.CSS_444,
        (2, 1): ChromaSubsampling.CSS_422,
        (2, 2): ChromaSubsampling.CSS_420,
        (1, 2): ChromaSubsampling.CSS_440,
        (4, 1): ChromaSubsampling.CSS_411,
        (4, 2): ChromaSubsampling.CSS_410,
        (2, 4): ChromaSubsampling.CSS_410V,
    }.get(ratio, ChromaSubsampling.UNSUPPORTED)


class JpegParser(ParserPlugin):
    codec = "jpeg"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        return (
            len(data) >= 3
            and data[0] == 0xFF
            and data[1] == SOI
            and data[2] == 0xFF
        )

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data)
        n = len(raw)
        pos = 2  # past SOI
        orientation = Orientation.NORMAL
        adobe_transform: Optional[int] = None
        sof = None  # (marker, precision, h, w, factors)

        while pos + 4 <= n:
            if raw[pos] != 0xFF:
                pos += 1
                continue
            marker = raw[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            if marker in (SOI, EOI) or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if pos + 4 > n:
                break
            (seglen,) = struct.unpack_from(">H", raw, pos + 2)
            seg = raw[pos + 4 : pos + 2 + seglen]
            if marker in _SOF_MARKERS:
                precision, h, w, ncomp = struct.unpack_from(">BHHB", seg, 0)
                factors = []
                for c in range(ncomp):
                    hv = seg[7 + 3 * c]  # [id, h<<4|v, tq] per component
                    factors.append((hv >> 4, hv & 0xF))
                sof = (marker, precision, h, w, factors)
                # components' quant table ids unneeded for info
            elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
                o = parse_exif_orientation(memoryview(seg)[6:])
                if o is not None:
                    orientation = o
            elif marker == 0xEE and seg[:5] == b"Adobe":
                if len(seg) >= 12:
                    adobe_transform = seg[11]
            elif marker == SOS:
                break
            pos += 2 + seglen

        if sof is None:
            raise ValueError("JPEG: no SOF marker found")
        marker, precision, h, w, factors = sof
        ncomp = len(factors)
        css = sampling_to_css(factors)

        # Color spec routing incl. Adobe transform
        # (reference: src/parsers/jpeg.cpp APP14 handling → CMYK/YCCK).
        if ncomp == 1:
            color = ColorSpec.GRAY
        elif ncomp == 4:
            color = ColorSpec.YCCK if adobe_transform == 2 else ColorSpec.CMYK
        else:
            color = ColorSpec.SYCC

        st = SampleDataType.UINT16 if precision > 8 else SampleDataType.UINT8
        hmax = max(f[0] for f in factors)
        vmax = max(f[1] for f in factors)
        planes = tuple(
            PlaneInfo(
                height=(h * fv + vmax - 1) // vmax,
                width=(w * fh + hmax - 1) // hmax,
                num_channels=1,
                sample_type=st,
                precision=precision if precision not in (8, 16) else 0,
            )
            for fh, fv in factors
        )
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=ncomp,
            planes=planes,
            sample_format=SampleFormat.P_Y if ncomp == 1 else SampleFormat.I_RGB,
            color_spec=color,
            chroma_subsampling=css,
            orientation=orientation,
            jpeg_encoding=JpegEncoding(marker),
            extras={"jpeg_adobe_transform": adobe_transform},
        )
