"""Codec registry: per-format priority-ordered factories + parser probing.

Counterpart of the reference registry
(reference: src/codec.cpp:26-135 — priority multimaps of parser/decoder/
encoder factories; src/codec_registry.cpp:33-59 — codec-name → Codec map with
JPEG forced to the front of the parser probe order).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .interfaces import DecoderPlugin, EncoderPlugin, ParserPlugin
from .image_info import ImageInfo
from .logger import get_logger

log = get_logger(__name__)


class Codec:
    """One image format: priority-sorted parsers/decoders/encoders
    (reference: src/codec.cpp:26-135)."""

    def __init__(self, name: str):
        self.name = name
        self.parsers: List[ParserPlugin] = []
        self.decoders: List[DecoderPlugin] = []
        self.encoders: List[EncoderPlugin] = []

    def register_parser(self, parser: ParserPlugin) -> None:
        self.parsers.append(parser)
        self.parsers.sort(key=lambda p: p.priority)

    def register_decoder(self, dec: DecoderPlugin) -> None:
        self.decoders.append(dec)
        self.decoders.sort(key=lambda d: d.priority)

    def register_encoder(self, enc: EncoderPlugin) -> None:
        self.encoders.append(enc)
        self.encoders.sort(key=lambda e: e.priority)


class CodecRegistry:
    """Name → Codec map + parser probe (reference: src/codec_registry.cpp:33-78).

    JPEG is probed first as the statistically most likely format
    (reference: src/codec_registry.cpp:39-43).
    """

    def __init__(self):
        self._codecs: Dict[str, Codec] = {}
        self._lock = threading.Lock()

    def codec(self, name: str) -> Codec:
        with self._lock:
            if name not in self._codecs:
                self._codecs[name] = Codec(name)
            return self._codecs[name]

    def codecs(self) -> List[Codec]:
        with self._lock:
            return list(self._codecs.values())

    def probe_order(self) -> List[Codec]:
        cs = self.codecs()
        cs.sort(key=lambda c: (c.name != "jpeg",))  # jpeg first
        return cs

    def find_parser(self, data: memoryview) -> Optional[ParserPlugin]:
        """Probe parsers in codec order then per-codec priority order
        (reference: src/codec_registry.cpp:47-59, src/codec.cpp:32-44)."""
        for codec in self.probe_order():
            for parser in codec.parsers:
                try:
                    if parser.can_parse(data):
                        return parser
                except Exception:  # malformed header in probe is not fatal
                    continue
        return None


_global_registry: Optional[CodecRegistry] = None
_global_lock = threading.Lock()


def global_registry() -> CodecRegistry:
    """Composition root, lazily built: the port's parsers and plugins, then
    the extensions of TPUIMGCODEC_TORCH_EXTENSIONS_PATH
    (core/plugin_framework.py; reference: NvImgCodecDirector registers
    builtin modules then discovers extensions,
    src/nvimgcodec_director.cpp:30-66)."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            from .plugin_framework import register_builtin_modules

            reg = CodecRegistry()
            register_builtin_modules(reg)
            _global_registry = reg
        return _global_registry
