"""Byte-stream abstractions.

Counterpart of the reference IoStream family
(reference: src/mem_io_stream.h:28 with zero-copy map() at :122,
src/std_file_io_stream.h:24, src/mmaped_file_io_stream.h:24,
src/iostream_factory.h). We expose one concept: anything that can produce a
zero-copy `memoryview` of encoded bytes. Parsers are pure functions over that
view, so the elaborate seek/read vtable is unnecessary.
"""
from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Union


class IoStream:
    """A readable, seekable view over encoded bytes with zero-copy `view()`."""

    def view(self) -> memoryview:
        raise NotImplementedError

    def size(self) -> int:
        return len(self.view())


class MemIoStream(IoStream):
    """Wraps bytes/bytearray/memoryview without copying
    (reference: src/mem_io_stream.h:28,122)."""

    def __init__(self, data: Union[bytes, bytearray, memoryview]):
        self._view = memoryview(data)

    def view(self) -> memoryview:
        return self._view


class FileIoStream(IoStream):
    """mmap-backed file stream (reference: src/mmaped_file_io_stream.h:24;
    falls back to a plain read like src/std_file_io_stream.h on failure)."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        try:
            with open(self.path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._view = memoryview(self._mm)
        except (ValueError, OSError):  # empty file or mmap unsupported
            with open(self.path, "rb") as f:
                self._view = memoryview(f.read())
            self._mm = None

    def view(self) -> memoryview:
        return self._view


class OutputStream:
    """Growable output sink for encoders
    (reference: encoders write via io_stream write/putc,
    e.g. extensions/nvpnm/encoder.cpp)."""

    def __init__(self):
        self._buf = io.BytesIO()

    def write(self, data) -> int:
        return self._buf.write(data)

    def pack(self, fmt: str, *vals) -> None:
        self._buf.write(struct.pack(fmt, *vals))

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


def as_iostream(src) -> IoStream:
    """Factory (reference: src/iostream_factory.h)."""
    if isinstance(src, IoStream):
        return src
    if isinstance(src, (bytes, bytearray, memoryview)):
        return MemIoStream(src)
    if isinstance(src, (str, os.PathLike)):
        return FileIoStream(src)
    raise TypeError(f"cannot make IoStream from {type(src)!r}")
