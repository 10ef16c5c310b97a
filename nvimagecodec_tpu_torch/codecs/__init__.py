"""The port's codec registry.

Registers the port's parsers and plugins: the host codecs (BMP, PNM, PNG,
TIFF, WebP, the system-library rungs, the JPEG CPU and lossless decoders and
the CPU JPEG encoder; the counterpart of nvimagecodec_tpu/codecs/__init__.py)
and the GPU plugins: JPEG, and JPEG2000 (`cuda_jpeg2k_hybrid_decoder`, which
stands above the system-openjpeg rung, and the host J2K encoder).
"""
from __future__ import annotations

from ..core.registry import CodecRegistry, global_registry
from ..parsers import ALL_PARSERS
from . import jpeg, jpeg2000, png, system_codecs, tiff, webp
from .bmp import BmpDecoder, BmpEncoder
from .pnm import PnmDecoder, PnmEncoder


def register_port_codecs(registry: CodecRegistry) -> None:
    for parser_cls in ALL_PARSERS:
        p = parser_cls()
        registry.codec(p.codec).register_parser(p)
    registry.codec("bmp").register_decoder(BmpDecoder())
    registry.codec("bmp").register_encoder(BmpEncoder())
    registry.codec("pnm").register_decoder(PnmDecoder())
    registry.codec("pnm").register_encoder(PnmEncoder())
    jpeg.register(registry)
    png.register(registry)
    tiff.register(registry)
    webp.register(registry)
    jpeg2000.register(registry)
    # system-library rungs, lowest on the ladder; each skips itself when
    # its library is absent
    system_codecs.register(registry)


def port_registry() -> CodecRegistry:
    """The port's registry, built at first use."""
    return global_registry()
