"""Builtin format parsers (reference: src/parsers/, registered as the builtin
extension `nvimgcodec_builtin_parsers` via src/builtin_modules.cpp:25-34)."""
from .bmp import BmpParser
from .jpeg import JpegParser
from .jpeg2k import Jpeg2kParser
from .png import PngParser
from .pnm import PnmParser
from .tiff import TiffParser
from .webp import WebpParser

ALL_PARSERS = (
    JpegParser,
    Jpeg2kParser,
    PngParser,
    TiffParser,
    BmpParser,
    PnmParser,
    WebpParser,
)

__all__ = [
    "BmpParser",
    "JpegParser",
    "Jpeg2kParser",
    "PngParser",
    "PnmParser",
    "TiffParser",
    "WebpParser",
    "ALL_PARSERS",
]
