"""ImageInfo: the parsed description of one image.

Counterpart of nvimgcodecImageInfo_t
(reference: include/nvimgcodec.h:790-828). Instead of a C struct with
plane-strided raw buffers, we carry a plain dataclass; decoded pixels travel
as numpy arrays or torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from .types import (
    ChromaSubsampling,
    ColorSpec,
    JpegEncoding,
    Orientation,
    Region,
    SampleDataType,
    SampleFormat,
)


@dataclass
class PlaneInfo:
    """One image plane (reference: nvimgcodecImagePlaneInfo_t)."""

    height: int
    width: int
    num_channels: int = 1
    sample_type: SampleDataType = SampleDataType.UINT8
    precision: int = 0  # 0 → full dtype precision


@dataclass
class ImageInfo:
    """Parsed image description (reference: nvimgcodecImageInfo_t,
    include/nvimgcodec.h:790-828; filled by parsers per src/parsers/*)."""

    codec: str = ""
    height: int = 0
    width: int = 0
    num_planes: int = 1
    planes: Tuple[PlaneInfo, ...] = ()
    sample_format: SampleFormat = SampleFormat.I_RGB
    color_spec: ColorSpec = ColorSpec.SRGB
    chroma_subsampling: ChromaSubsampling = ChromaSubsampling.NONE
    orientation: Orientation = Orientation.NORMAL
    region: Optional[Region] = None
    # JPEG-specific extension (reference: nvimgcodecJpegImageInfo_t via
    # struct_next, src/parsers/jpeg.cpp:346-353)
    jpeg_encoding: JpegEncoding = JpegEncoding.UNKNOWN
    # Free-form codec-specific details (tile geometry for J2K, etc.)
    extras: dict = field(default_factory=dict)

    @property
    def num_channels(self) -> int:
        if self.planes:
            return sum(p.num_channels for p in self.planes)
        return 0

    @property
    def sample_type(self) -> SampleDataType:
        if self.planes:
            return self.planes[0].sample_type
        return SampleDataType.UINT8

    @property
    def precision(self) -> int:
        if self.planes:
            return self.planes[0].precision
        return 0

    def with_(self, **kw) -> "ImageInfo":
        return replace(self, **kw)


def make_planes(
    height: int,
    width: int,
    num_components: int,
    sample_type: SampleDataType = SampleDataType.UINT8,
    precision: int = 0,
    subsampling: ChromaSubsampling = ChromaSubsampling.NONE,
) -> Tuple[PlaneInfo, ...]:
    """Build per-component planes at full resolution for luma and scaled for
    chroma according to `subsampling` (first plane always full-size)."""
    def css_divisors(css: ChromaSubsampling) -> Tuple[int, int]:
        # (y_div, x_div) for chroma planes
        return {
            ChromaSubsampling.NONE: (1, 1),
            ChromaSubsampling.CSS_422: (1, 2),
            ChromaSubsampling.CSS_420: (2, 2),
            ChromaSubsampling.CSS_440: (2, 1),
            ChromaSubsampling.CSS_411: (1, 4),
            ChromaSubsampling.CSS_410: (2, 4),
            ChromaSubsampling.CSS_410V: (2, 4),
            ChromaSubsampling.GRAY: (1, 1),
        }.get(css, (1, 1))

    ydiv, xdiv = css_divisors(subsampling)
    planes = []
    for c in range(num_components):
        if c == 0 or subsampling in (ChromaSubsampling.NONE, ChromaSubsampling.GRAY):
            h, w = height, width
        else:
            h = (height + ydiv - 1) // ydiv
            w = (width + xdiv - 1) // xdiv
        planes.append(
            PlaneInfo(height=h, width=w, num_channels=1,
                      sample_type=sample_type, precision=precision)
        )
    return tuple(planes)
