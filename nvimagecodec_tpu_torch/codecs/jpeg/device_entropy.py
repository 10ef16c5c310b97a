"""Device entropy routes: host glue in numpy, device work on tensors.

The host half (route plan, native index scan, word packing) is the numpy
and ctypes code of nvimagecodec_tpu/codecs/jpeg/device_entropy.py, copied:
`device_entropy_plan`, `frame_segments`, `index_scan_batch`,
`pack_indexed_batch`, `indexed_words_needed_batch`. The torch half:

- `stage` / `upload`: pinned host staging and its asynchronous upload;
- `split_staged`: the restart-marker split of scans into staged words and
  side, shared by the dri route and the progressive route;
- `staged_tables` / `uploaded_tables`: a bucket's or a scan's Huffman
  tables and their lookahead rows as one pinned upload;
- `decode_progressive_device` (the reference's :315-422): a progressive
  stream with restart markers decoded scan by scan with K3, which reads and
  writes the coefficient planes kept on the device in place.

The reference's `reassemble_components` (:285-312) and its per-scan gather
and scatter are part of the kernels' plain versions now
(ops/entropy_kernels.py); K2 and K3 store their blocks where the pixel stage
reads them.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ...core import trace
from ...core.trace import span
from ...native import lib as native_lib
from ...ops.entropy_kernels import (
    decode_prog_scan_into,
    entropy_kernel_spec,
    lookahead_tables,
    make_side,
    prog_scan_kind,
    prog_scan_specs,
    prog_scan_tables,
)
from .headers import JpegFrame
from .pixel import geometry_key


def device_entropy_key(frame: JpegFrame):
    """Extended bucket key: geometry + DRI + scan/table content (one K2
    launch reads one set of Huffman tables)."""
    try:
        R, comp_map, tables, total = entropy_kernel_spec(frame)
    except ValueError:
        return None
    mcus_x = -(-frame.width // (8 * frame.hmax))
    if R % mcus_x != 0:
        return None  # need whole-MCU-row segments for the static reassembly
    return (geometry_key(frame), R, comp_map, tables)


def device_entropy_plan(frame: JpegFrame):
    """Route description for the on-device entropy decoder, or None when
    the stream must take the host path. Returns (kind, key, R, nsegs):

    - kind "dri": the stream has restart markers — segments are the restart
      intervals, byte-aligned, DC predictors reset (T.81 §F.2.1.3).
    - kind "idx": baseline stream WITHOUT restart markers — the host index
      scan (tic_jpeg_index_scan) finds MCU-row split bits + DC predictor
      seeds, so the kernel still decodes one MCU row per lane: no special
      bitstream required (the modelled library needs its HW engine for
      this, extensions/nvjpeg/hw_decoder.cpp:349-404).

    Memoized on the frame object — the batch router calls this per sample.
    """
    p = getattr(frame, "_de_plan", False)
    if p is not False:
        return p
    p = _device_entropy_plan_uncached(frame)
    frame._de_plan = p
    return p


def _device_entropy_plan_uncached(frame: JpegFrame):
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    if frame.restart_interval > 0:
        key = device_entropy_key(frame)
        if key is None:
            return None
        nsegs, _ = frame_segments(frame)
        return ("dri", key, frame.restart_interval, nsegs)
    R = mcus_x  # one MCU row per segment: max lane parallelism, min W
    try:
        spec = entropy_kernel_spec(frame, R)
    except ValueError:
        return None
    return ("idx", (geometry_key(frame), R, spec[1], spec[2]), R, mcus_y)


def frame_segments(frame: JpegFrame) -> Tuple[int, int]:
    """(nsegs, total_mcus) for one frame."""
    R = frame.restart_interval
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    total = mcus_x * mcus_y
    return -(-total // R), total


def index_scan_batch(frames, raws, idxs, rows_per_seg: int, nsegs: int,
                     nthreads: int):
    """Batched host index scan: every image of a geometry bucket in one
    native call (native/jpeg_entropy.cpp tic_jpeg_index_scan_batch) with
    internal work-stealing threads — replaces the per-image ctypes +
    thread-pool round trip. Returns {i: (destuffed, dlen, bits, preds)}
    with None entries for images the scanner declined."""
    L = native_lib()
    n = len(idxs)
    if n == 0:
        return {}
    max_segs = nsegs + 1
    datas = (ctypes.c_char_p * n)(*[raws[i] for i in idxs])
    lens = np.asarray([len(raws[i]) for i in idxs], np.int64)
    offs = np.zeros(n + 1, np.int64)
    for k, i in enumerate(idxs):
        sc = frames[i].scans[0]
        offs[k + 1] = offs[k] + int(sc.data_end - sc.data_start) + 8
    arena = np.empty(int(offs[-1]), np.uint8)
    dlens = np.zeros(n, np.int64)
    bits = np.zeros((n, max_segs), np.int64)
    preds = np.zeros((n, max_segs * 4), np.int32)
    nout = np.zeros(n, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    L.tic_jpeg_index_scan_batch(
        n, datas, lens.ctypes.data_as(i64p), rows_per_seg,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(i64p), dlens.ctypes.data_as(i64p),
        bits.ctypes.data_as(i64p), preds.ctypes.data_as(i32p),
        max_segs, nout.ctypes.data_as(i32p), nthreads)
    out = {}
    for k, i in enumerate(idxs):
        if nout[k] != nsegs:
            out[i] = None
            continue
        m = int(nout[k])
        out[i] = (arena[offs[k]:offs[k + 1]], int(dlens[k]),
                  bits[k, :m], preds[k, :m * 4].reshape(m, 4))
    return out, (arena, offs, dlens, bits, preds, nout)


def pack_indexed_batch(arena, offs, dlens, bits, ks, nsegs: int,
                       words: np.ndarray, max_words: int,
                       start_bits: np.ndarray, nthreads: int):
    """Pack sub-bucket images (rows ks of the scan-batch arrays) into the
    [W, S] matrix in one native call. Returns the list of sub-local j
    indices whose segments overflowed max_words."""
    L = native_lib()
    n = len(ks)
    max_segs = bits.shape[1]
    offs_sub = np.ascontiguousarray(offs[ks], np.int64)
    dlens_sub = np.ascontiguousarray(dlens[ks], np.int64)
    bits_sub = np.ascontiguousarray(bits[ks])
    rcs = np.zeros(n, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    L.tic_jpeg_pack_indexed_batch(
        n, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs_sub.ctypes.data_as(i64p), dlens_sub.ctypes.data_as(i64p),
        bits_sub.ctypes.data_as(i64p), max_segs, nsegs,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        words.shape[1], max_words,
        start_bits.ctypes.data_as(i32p), rcs.ctypes.data_as(i32p),
        nthreads)
    return [int(j) for j in np.flatnonzero(rcs)]


def indexed_words_needed_batch(dlens: np.ndarray, bits: np.ndarray,
                               nsegs: int) -> int:
    """Vectorized max words-per-segment over scan-batch rows (valid rows
    only — caller pre-selects)."""
    end_bits = np.empty_like(bits[:, :nsegs])
    end_bits[:, :-1] = bits[:, 1:nsegs]
    end_bits[:, -1] = dlens * 8
    w0 = bits[:, :nsegs] // 32
    w1 = np.minimum((end_bits + 96 + 31) // 32,
                    ((dlens + 3) // 4)[:, None])
    return int(np.maximum(w1 - w0, 1).max()) if len(dlens) else 1


def stage(shape, dtype, device) -> torch.Tensor:
    """Host staging for a device upload. For CUDA it is pinned memory from
    PyTorch's caching host allocator, which hands a block out again only
    after the events recorded on the copies that read it have completed."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def upload(bufs: List[torch.Tensor], device) -> List[torch.Tensor]:
    """Host staging → device tensors: asynchronous copies on the current
    stream. On the CPU the buffers are the device tensors."""
    with span("imgcodec.jpeg.upload"):
        if device.type != "cuda":
            return bufs
        trace.add_count("imgcodec.jpeg.h2d_bytes",
                        sum(b.nbytes for b in bufs))
        return [b.to(device, non_blocking=True) for b in bufs]


def words_estimate(scan_bytes: int, nsegs: int) -> int:
    """First guess of the word rows a restart segment needs: twice the
    mean segment and 16 more (the reference's guess), rounded up to 16, not
    to the reference's 256: every row is zeroed, filled and uploaded for
    all S lanes, and a progressive scan's segments are a few dozen words.
    Callers double it when a segment does not fit."""
    est = scan_bytes // 4 // nsegs * 2 + 16
    return -(-est // 16) * 16


# a restart-segment word matrix larger than this is refused (a corrupt
# stream can make one segment as long as its whole scan)
MAX_WORD_BYTES = 1 << 30


def split_staged(datas, nsegs: int, R: int, units: int, S: int, device):
    """Split entropy-coded scans of `units` units each at their restart
    markers (every R units) into staged [W, S] words and [6, S] side (units
    per lane, start bit 0, zero DC seeds), scan k in lanes k*nsegs on. W
    starts at `words_estimate` of the longest scan and doubles until every
    segment fits. Returns (words, side, counts), counts[k] the segments
    scan k split into (a scan with counts[k] != nsegs has a malformed
    restart structure and lanes of 0 units), or None when the words would
    exceed MAX_WORD_BYTES."""
    L = native_lib()
    W = words_estimate(max(len(d) for d in datas), nsegs)
    while W * S * 4 <= MAX_WORD_BYTES:
        words = stage((W, S), torch.int32, device)
        wnp = words.numpy().view(np.uint32)
        wnp[:, len(datas) * nsegs:] = 0
        ptr = wnp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        counts = []
        for k, d in enumerate(datas):
            n = L.tic_jpeg_split_segments(d, len(d), ptr, S, k * nsegs,
                                          nsegs, W)
            if n == -1:  # a segment outgrew W
                break
            counts.append(n)
        else:
            seg_units = np.zeros(S, np.int32)
            for k, n in enumerate(counts):
                if n == nsegs:
                    col = k * nsegs
                    seg_units[col:col + nsegs] = R
                    seg_units[col + nsegs - 1] = units - (nsegs - 1) * R
            side = stage((6, S), torch.int32, device)
            side.numpy()[:] = make_side(seg_units)
            return words, side, counts
        W *= 2
    return None


def staged_tables(tables: np.ndarray, device) -> torch.Tensor:
    """Huffman tables [..., 34 + nv] and their lookahead rows in one pinned
    int32 staging buffer (the rows behind the tables, two int16 entries a
    word), to go up with `upload`; `uploaded_tables` splits it again."""
    look = lookahead_tables(tables)
    t = stage((tables.size + look.size // 2,), torch.int32, device)
    t.numpy()[:tables.size] = tables.reshape(-1)
    t.numpy()[tables.size:] = look.reshape(-1).view(np.int32)
    return t


def uploaded_tables(buf: torch.Tensor, tables: np.ndarray):
    """(tables, look) views of an uploaded `staged_tables` buffer."""
    rows = tables.size // tables.shape[-1]
    look = buf[tables.size:].view(torch.int16).view(rows, -1)
    return buf[:tables.size].view(tables.shape), look


def decode_progressive_device(frame, raw: bytes, device) -> List[torch.Tensor]:
    """Decode a Huffman-coded progressive stream with restart markers in
    every scan on `device`, scan by scan with K3 (each scan's words, side
    and tables go up in pinned, asynchronous copies; the kernel reads and
    writes the planes in place): the DC scan, the AC band scans and the
    successive-approximation refinement scans. Returns
    per-component zigzag [mcus_y*v, mcus_x*h, 64] int16 planes (padded MCU
    grid) on the device. Raises ValueError outside K3's scope, when a scan
    does not split into its restart segments, or when K3 flags a lane."""
    if frame.marker != 0xC2:
        raise ValueError("prog device entropy: Huffman-coded progressive "
                         "(SOF2) only")
    scans = prog_scan_specs(frame)
    if any(s.ss > s.se or s.se > 63 for s in scans):
        raise ValueError("prog device entropy: bad spectral band")
    device = torch.device(device)
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    hv = tuple((c.h, c.v) for c in frame.components)
    planes = [torch.zeros((mcus_y * v, mcus_x * h, 64), dtype=torch.int16,
                          device=device) for h, v in hv]
    flags = []
    for scan in scans:
        kind = prog_scan_kind(scan)
        R = scan.restart_interval
        if scan.ss == 0:
            ci, cbw, cbh = 0, mcus_x, mcus_y  # not read by a DC scan
            units = mcus_x * mcus_y
        else:
            ci = scan.comp_indices[0]
            cbw, cbh = frame.comp_true_blocks(frame.components[ci])
            units = cbw * cbh
        nsegs = -(-units // R)
        S = -(-nsegs // 128) * 128
        with span("imgcodec.jpeg.prog_split"):
            split = split_staged([raw[scan.data_start:scan.data_end]], nsegs,
                                 R, units, S, device)
            if split is None:
                raise ValueError("prog device entropy: restart segment "
                                 "too long")
            words, side, (n,) = split
            if n != nsegs:
                raise ValueError(f"prog device entropy: scan split into {n} "
                                 f"segments, expected {nsegs}")
            tables = prog_scan_tables(frame, scan)
            staged = staged_tables(tables, device)
        with span("imgcodec.jpeg.prog_kernel"):
            words_d, side_d, tabs_d = upload([words, side, staged], device)
            tables_d, look_d = uploaded_tables(tabs_d, tables)
            err = decode_prog_scan_into(
                kind, words_d, side_d, tables_d, look_d, planes, R, hv,
                mcus_x, ci, (cbw, cbh), scan.ss, scan.se, scan.al)
            flags.append(err[:nsegs])
    with span("imgcodec.jpeg.prog_flags"):
        flagged = bool(torch.cat(flags).any())  # the stream's one sync
    if flagged:
        raise ValueError("prog device entropy: kernel flagged error")
    return planes
