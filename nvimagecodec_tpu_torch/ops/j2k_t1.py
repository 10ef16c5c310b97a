"""J2K Tier-1 on the card: the code-block table and the kernel's wrapper.

`BlockTable` describes the code-blocks of a tile, or of every tile of a
uniform grid, instead of decoding them: a row of ROW int32 a block (the
native batch decoder's meta row, `t1_row`, then where its coefficients go),
as Tier-2 writes them for a whole tile in one native pass
(codecs/jpeg2000/t2.py `PacketDecoder.rows`), which checks every row with
the rules of the native decoder (native/j2k_t1.cpp; `check_rows` applies
them to rows made elsewhere), and `add_tile` raises that decoder's
ValueError, so a malformed stream fails on the host before any launch and
the kernel needs no error path. `staged` lays out the table, sorted
longest segment first, and the codestream bytes in one buffer (pinned for
a CUDA device) that goes up in one copy.

`decode_codeblocks` decodes every row of a staged table into a zeroed flat
int32 buffer. A CUDA buffer launches csrc/j2k_t1.cu (one warp a code-block)
or raises; a CPU buffer takes the plain version, the native host decoder on
the same rows (`decode_batch_into`, which the host Tier-1 calls too).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..native import lib as _native_lib

# int32 a row of the native batch decoder (native/j2k_block_batch.cpp):
# segment offset in the data (bytes) and length, w, h, band | style << 8,
# bit-planes, passes
META = 7
# int32 a row of the staged table: the META row, then the destination's row
# stride and its offset in the flat buffer (elements, low and high 32 bits)
ROW = META + 3
# the most coefficients a code-block may have (T.800 A.6.1: xcb + ycb <= 12),
# which the kernel keeps in shared memory
MAX_BLOCK_AREA = 4096


class Layout(NamedTuple):
    """What the kernel needs to read a staged buffer: its rows, where the
    data starts (bytes), and the most flag words and coefficients of any
    row (its shared memory)."""
    rows: int
    data_start: int
    flag_words: int
    mag_words: int


def t1_row(off: int, length: int, w: int, h: int, band: int, nbps: int,
           passes: int, style: int) -> tuple:
    """The META row of a part-1 code-block whose segment is `length` bytes
    at `off` of its batch's data."""
    return (off, length, w, h, band | (style << 8), nbps, passes)


def row_dest(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """A row's destination, the int64 element offset whose low and high
    32 bits its last two int32 hold."""
    return lo.view(np.uint32).astype(np.int64) | (hi.astype(np.int64) << 32)


def check_rows(rows: np.ndarray, data) -> int:
    """The first of the part-1 rows ([n, ROW] int32, segment offsets into
    `data`) the native decoder would refuse or whose segment lies outside
    `data`; -1 for none."""
    rows = np.ascontiguousarray(rows, np.int32)
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1,
                                                                   np.uint8)
    return int(_native_lib().tic_t1_rows_check(
        rows.ctypes.data, len(rows), buf.ctypes.data, len(data)))


# the native batch decoders that write each block in place, and their rows
_ENTRIES = {"T1": ("tic_t1_decode_batch_into", META),
            "HT": ("tic_ht_decode_batch_into", 9)}


def decode_batch_into(kind: str, data, meta, bases, offsets, strides,
                      nthreads: int, count_cpu: bool = False) -> int:
    """One call of the native batch decoder of `kind` ("T1": META ints a
    row; "HT": its own rows of 9) on the blocks whose rows `meta` holds
    (flat or [n, width]) and whose segments are in `data` (bytes, or a
    c_char_p to them): block i goes to address bases[i] + 4 * offsets[i]
    (`bases` may be one address), its rows strides[i] int32 apart. Raises
    the decoder's ValueError for the first block it refused. Returns the CPU
    time (ns) of the worker threads it started where `count_cpu`, else 0."""
    entry, width = _ENTRIES[kind]
    meta = np.ascontiguousarray(np.asarray(meta, np.int32).reshape(-1, width))
    n = len(meta)
    addrs = (np.asarray(bases, np.uint64)
             + (np.asarray(offsets, np.int64) * 4).astype(np.uint64))
    strides = np.ascontiguousarray(strides, np.int64)
    if addrs.shape != (n,) or strides.shape != (n,):
        raise ValueError(f"J2K {kind} batch: {n} rows, {addrs.shape} "
                         f"addresses, {strides.shape} strides")
    if n == 0:
        return 0
    rcs = np.zeros(n, np.int32)
    cpu = np.zeros(1, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = getattr(_native_lib(), entry)(
        n, data, meta.ctypes.data_as(i32p),
        addrs.ctypes.data_as(ctypes.POINTER(i32p)),
        strides.ctypes.data_as(i64p), rcs.ctypes.data_as(i32p), nthreads,
        cpu.ctypes.data_as(i64p) if count_cpu else None)
    if rc != 0:
        i = int(np.nonzero(rcs)[0][0])
        raise ValueError(f"J2K {kind} block decode failed rc={rcs[i]} "
                         f"(block {i} of {n})")
    return int(cpu[0])


class BlockTable:
    """The code-blocks of one tile, or of the tiles of a uniform grid, as
    rows for the device decoder (see the module's note)."""

    def __init__(self):
        self._parts: list = []  # the data: tile data and side areas
        self.size = 0           # bytes of the data so far
        self._rows: list = []   # [n, ROW] int32 a tile

    def __len__(self) -> int:
        return sum(len(r) for r in self._rows)

    def add_tile(self, rows: np.ndarray, parts, bad: int) -> int:
        """A tile's rows, [n, ROW] int32 whose segment offsets count from
        the table's data, where `parts` (bytes-like) go, at `size`. `bad`
        is the first row the native decoder would refuse (-1 none), as
        Tier-2's rows or `check_rows` give it: raises that decoder's
        ValueError for it. Returns n."""
        n = len(rows)
        if bad >= 0:
            raise ValueError(f"J2K T1 block decode failed rc=1 "
                             f"(block {bad} of {n})")
        self._rows.append(rows)
        for p in parts:
            self._parts.append(p)
            self.size += len(p)
        return n

    def rows(self) -> np.ndarray:
        """[n, ROW] int32, in the order added."""
        return (np.concatenate(self._rows) if self._rows
                else np.zeros((0, ROW), np.int32))

    def staged(self, alloc=None):
        """(uint8 buffer, Layout): the table, longest segment first, then
        the data, in a buffer of `alloc(nbytes)` (a CPU tensor by
        default)."""
        t = self.rows()
        n = len(t)
        t = np.ascontiguousarray(t[np.argsort(-t[:, 1], kind="stable")])
        head = -(-t.nbytes // 16) * 16
        nbytes = head + self.size
        buf = (alloc(nbytes) if alloc is not None
               else torch.empty(nbytes, dtype=torch.uint8))
        v = buf.numpy()
        v[:t.nbytes] = t.reshape(-1).view(np.uint8)
        pos = head
        for p in self._parts:
            v[pos:pos + len(p)] = np.frombuffer(p, np.uint8)
            pos += len(p)
        w, h = t[:, 2].astype(np.int64), t[:, 3].astype(np.int64)
        flags = int(((((h + 3) >> 2) + 2) * (w + 2)).max()) if n else 0
        mags = int((w * h).max()) if n else 0
        return buf, Layout(n, head, flags, mags)


def decode_codeblocks_plain(buf: torch.Tensor, layout: Layout,
                            out: torch.Tensor) -> None:
    """The native host decoder on the rows of a staged CPU buffer, into
    the CPU int32 buffer `out`."""
    n = layout.rows
    t = buf.numpy()[:n * ROW * 4].view(np.int32).reshape(n, ROW)
    dest = row_dest(t[:, META + 1], t[:, META + 2])
    decode_batch_into(
        "T1", ctypes.cast(buf.data_ptr() + layout.data_start,
                          ctypes.c_char_p),
        t[:, :META], out.data_ptr(), dest, t[:, META], os.cpu_count() or 1)


def decode_codeblocks(buf: torch.Tensor, layout: Layout,
                      out: torch.Tensor) -> None:
    """Decodes every code-block of a staged buffer (`BlockTable.staged`,
    uploaded) into `out`, a zeroed contiguous int32 flat buffer on the same
    device. A CPU buffer takes the plain version; a CUDA buffer launches
    csrc/j2k_t1.cu on the current stream, without synchronising, or
    raises."""
    if out.device.type == "cpu":
        return decode_codeblocks_plain(buf, layout, out)
    if out.device.type != "cuda":
        raise ValueError(f"J2K Tier-1: unsupported device {out.device}")
    if (buf.dtype != torch.uint8 or buf.device != out.device
            or not buf.is_contiguous()):
        raise ValueError("J2K Tier-1: the staged table must be contiguous "
                         "uint8 on the output's device")
    if out.dtype != torch.int32 or not out.is_contiguous():
        raise ValueError("J2K Tier-1: the output must be contiguous int32")
    if layout.mag_words > MAX_BLOCK_AREA:
        raise ValueError(f"J2K Tier-1: a code-block of {layout.mag_words} "
                         f"coefficients (at most {MAX_BLOCK_AREA})")
    if layout.rows == 0:
        return
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = _build.lib().tic_j2k_t1_decode_blocks(
            buf.data_ptr(), layout.rows, buf.data_ptr() + layout.data_start,
            out.data_ptr(), layout.flag_words, layout.mag_words, stream)
    _build.check(rc, "J2K Tier-1 launch")
    _build.count_launch(decode_codeblocks)


decode_codeblocks.launches = 0
