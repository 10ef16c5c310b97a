"""Batched JPEG decode on a CUDA device.

The port of nvimagecodec_tpu/codecs/jpeg/batch.py (`decode_batch_tpu`,
:394-628 and :746-1072). Samples are parsed in one native marker walk
(`headers.parse_jpeg_batch`, on the calling thread) and bucketed by
geometry (dimensions, sampling factors, quant tables). Each bucket then takes
one of three routes, all ending in the same pixel stage (K1, upsample,
colour), and comes out as one [B, H, W(, C)] tensor whose rows are the
samples' images:

- idx: a bucket of >= _MIN_BATCH same-table baseline streams without
  restart markers. The native index scan finds each MCU row's bit offset
  and DC predictors on the host, the destuffed bits ship as a [W, S] word
  matrix, and K2 decodes one MCU row per lane (one launch per bucket).
- dri: the same for streams whose restart interval is whole MCU rows. The
  host only splits the scans at their restart markers, so K2 decodes one
  restart interval per lane with zero DC seeds, and its error flags are the
  only validation: a flagged sample is decoded again on the host route.
- host: everything else. Native entropy decode writes int16 coefficients
  into pinned staging, which is copied to the device.

`decode_progressive` is the explicit progressive entry (K3 scan by scan,
then the same pixel stage); the Decoder keeps progressive streams on the
host route, as the reference's router does.

On a CPU device every route runs with the kernels' plain versions, which
is how the tests hold the port against the reference.

With a mesh (`Decoder(mesh=)`), each bucket's route is chosen for the whole
bucket, as without one, and then its samples split into contiguous shards,
one per "dp" device: each shard of the idx or dri route is one K2 launch and
one pixel stage on its device, and the samples left to the host route split
the same way (the reference shards K2's lane axis instead; the idx route's
lanes are runs of one image's MCU rows, so both give the same
coefficients). A shard's work runs under `torch.cuda.device` of its device
and on that device's current stream.

Staging is pinned host memory from PyTorch's caching allocator, reused only
once the copies that read it have completed. Kernel and device errors raise; a corrupt stream or an index-scan
reject fails (or re-routes) just that sample.
"""
from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from ...core.interfaces import DecodeParams, DecodeResult
from ...core.trace import bind, charge, span
from ...core.types import ColorSpec, ProcessingStatus
from ...ops.entropy_kernels import decode_segments_into, huffman_tables
from ...parallel.mesh import shard_bounds
from .device_entropy import (
    decode_progressive_device,
    device_entropy_plan,
    frame_segments,
    index_scan_batch,
    indexed_words_needed_batch,
    pack_indexed_batch,
    split_staged,
    stage,
    staged_tables,
    upload,
    uploaded_tables,
)
from .headers import parse_jpeg_batch, parse_jpeg_structure
from .native import decode_coefficients_into
from .pixel import assemble_image_i32, finish_image, geometry_key, idct_planes

# a bucket smaller than this takes the host route (the reference's value,
# not yet re-measured on a GPU)
_MIN_BATCH = 16

# samples decoded per route since import (tests and the smoke run read it)
ROUTES = {"idx": 0, "dri": 0, "host": 0, "reissued": 0}
_ROUTES_LOCK = threading.Lock()

_FAIL_CORRUPT = ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED


def _count(route: str, n: int) -> None:
    with _ROUTES_LOCK:
        ROUTES[route] += n


_EXEC_LOCK = threading.Lock()
_EXECS: Dict[str, ThreadPoolExecutor] = {}


def _shared_pool(name: str, workers: int) -> ThreadPoolExecutor:
    """Persistent executor, created at first use."""
    with _EXEC_LOCK:
        p = _EXECS.get(name)
        if p is None:
            p = ThreadPoolExecutor(max_workers=workers,
                                   thread_name_prefix=f"tic-{name}")
            _EXECS[name] = p
        return p


def configure_host_pool(max_mb: int = None, per_key_cap: int = None,
                        alloc=None) -> None:
    """Does nothing: kept with the JAX package's signature so that its
    callers run unchanged, and checks its arguments. The JAX package keeps
    a pool of host staging buffers for its uint8 wire; here PyTorch's
    caching host allocator stages the uploads (pinned memory, reused once
    the copies that read it have completed), and there is no pool to
    configure.

    max_mb and per_key_cap: a non-negative int or None; alloc: a callable
    (shape, dtype) -> array, or None. Anything else raises TypeError or
    ValueError."""
    for name, value in (("max_mb", max_mb), ("per_key_cap", per_key_cap)):
        if value is None:
            continue
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise TypeError(f"configure_host_pool: {name} must be an int or "
                            f"None, not {type(value).__name__}")
        if value < 0:
            raise ValueError(f"configure_host_pool: {name} must be >= 0, "
                             f"not {value}")
    if alloc is not None and not callable(alloc):
        raise TypeError("configure_host_pool: alloc must be callable or None")


def _fetch(t: torch.Tensor, device):
    """Start a device-to-host copy of a small tensor. Returns (host tensor,
    event to wait on before reading it; None on the CPU)."""
    if device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event


def on_device(device: torch.device):
    """`torch.cuda.device(device)` for a CUDA device: the kernels launch on
    the CUDA runtime's current device. Nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _pixel_stage(frame, coefs, zigzag, fancy, to_rgb, to_u8, bitexact):
    with span("imgcodec.jpeg.pixel_stage"):
        with span("imgcodec.jpeg.idct"):
            planes = idct_planes(frame, coefs, zigzag=zigzag,
                                 bitexact=bitexact)
        with span("imgcodec.jpeg.upsample_color"):
            img = assemble_image_i32(frame, planes, fancy)
            return finish_image(frame, img, to_rgb, to_u8)


def scan_indexed(good, frames, raws, R, nsegs):
    """The host index scan of one bucket. Returns (ok, bad_scan, scan): the
    samples of `good` it took and those it rejected, and what
    `pack_indexed` packs their words from."""
    nthreads = min(32, os.cpu_count() or 2)
    f0 = frames[good[0]]
    mx = -(-f0.width // (8 * f0.hmax))
    scans, arrays = index_scan_batch(frames, raws, good, R // mx, nsegs,
                                     nthreads)
    ok = [i for i in good if scans[i] is not None]
    bad_scan = [i for i in good if scans[i] is None]
    return ok, bad_scan, ({i: k for k, i in enumerate(good)}, arrays)


def pack_indexed(scan, ok, frames, R, nsegs, device):
    """Word packing of `ok` (samples the scan took, all of them or a shard)
    for one K2 launch: S = ceil(B * nsegs / 128) * 128. Returns
    (bad, words, side) with bad the positions in `ok` whose words did not
    pack, words [W, S] and side [6, S] int32 staging tensors."""
    pos_of, (arena, offs, dlens, bits, preds, _n) = scan
    nthreads = min(32, os.cpu_count() or 2)
    f0 = frames[ok[0]]
    mx = -(-f0.width // (8 * f0.hmax))
    my = -(-f0.height // (8 * f0.vmax))
    ks = np.asarray([pos_of[i] for i in ok])
    W = indexed_words_needed_batch(dlens[ks], bits[ks], nsegs)
    B = len(ok)
    S = -(-B * nsegs // 128) * 128
    words = stage((W, S), torch.int32, device)
    side = stage((6, S), torch.int32, device)
    words_np = words.numpy().view(np.uint32)
    side_np = side.numpy()
    words_np[:, B * nsegs:] = 0
    side_np[:] = 0
    start_bits = np.zeros(S, np.int32)
    bad = pack_indexed_batch(arena, offs, dlens, bits, ks, nsegs, words_np,
                             W, start_bits, nthreads)
    seg_mcus = np.zeros(S, np.int32)
    seg_mcus[:B * nsegs] = R
    seg_mcus[nsegs - 1:B * nsegs:nsegs] = mx * my - (nsegs - 1) * R
    for j in bad:
        seg_mcus[j * nsegs:(j + 1) * nsegs] = 0
    side_np[0] = seg_mcus
    side_np[1] = start_bits
    # [B, nsegs, 4] predictor seeds → side rows 2..5
    side_np[2:6, :B * nsegs] = (preds[ks, :nsegs * 4].reshape(B, nsegs, 4)
                                .transpose(2, 0, 1).reshape(4, B * nsegs))
    return set(bad), words, side


def split_indexed(good, frames, raws, R, nsegs, device):
    """Host index scan + word packing of one bucket for one K2 launch.
    Returns (ok, bad, bad_scan, words, side) as `scan_indexed` and
    `pack_indexed` give them, or None when the scan takes no sample."""
    ok, bad_scan, scan = scan_indexed(good, frames, raws, R, nsegs)
    if not ok:
        return None
    bad, words, side = pack_indexed(scan, ok, frames, R, nsegs, device)
    return ok, bad, bad_scan, words, side


def split_dri(good, frames, raws, nsegs, device):
    """Restart-marker split for one bucket: byte-aligned segments, zero DC
    seeds. Returns (bad, words, side) with bad the positions in `good`
    whose scan did not split into nsegs segments, words [W, S] and side
    [6, S] int32 staging tensors; or None when the words would exceed
    `device_entropy.MAX_WORD_BYTES`. One K2 launch covers the bucket:
    S = ceil(B * nsegs / 128) * 128."""
    f0 = frames[good[0]]
    S = -(-len(good) * nsegs // 128) * 128
    datas = [raws[i][frames[i].scans[0].data_start:frames[i].scans[0].data_end]
             for i in good]
    split = split_staged(datas, nsegs, f0.restart_interval,
                         frame_segments(f0)[1], S, device)
    if split is None:
        return None
    words, side, counts = split
    return [k for k, n in enumerate(counts) if n != nsegs], words, side


def route_plan(frame):
    """The reference's device-entropy route plan, for Huffman-coded
    sequential streams only; None sends the stream to the host route."""
    if frame.marker not in (0xC0, 0xC1):
        return None
    try:
        return device_entropy_plan(frame)
    except (ValueError, KeyError):  # tables the kernel cannot take
        return None


def _shards(samples, devices):
    """`samples` in contiguous shards, one per device: [(shard, device)],
    empty shards left out."""
    return [(samples[lo:hi], dev) for (lo, hi), dev in
            zip(shard_bounds(len(samples), len(devices)), devices) if lo < hi]


def _try_device_entropy(idxs, frames, raws, results, fancy, to_rgb, to_u8,
                        bitexact, devices, checks):
    """The idx or dri route for one geometry bucket, its samples split into
    contiguous shards over `devices` (one device without a mesh), one K2
    launch a shard. The route is chosen for the whole bucket, as for an
    unsharded decode, and every shard is split on the host before the
    first launch. Returns the sample indices it leaves to the host route, or
    None to decline the whole bucket. Appends (ok, bad, nsegs, err, event)
    to `checks` for the caller's flag check, one entry a shard."""
    f0 = frames[idxs[0]]
    plan = route_plan(f0)
    if plan is None:
        return None
    good = [i for i in idxs if i == idxs[0] or route_plan(frames[i]) == plan]
    if len(good) < _MIN_BATCH or len(good) * 2 < len(idxs):
        return None
    good_set = set(good)
    leftover = [i for i in idxs if i not in good_set]
    kind, _key, R, nsegs = plan

    splits = []  # (ok, bad, words, side, device) a shard
    if kind == "dri":
        with span("imgcodec.jpeg.dri_split"):
            for sub, dev in _shards(good, devices):
                with on_device(dev):
                    split = split_dri(sub, frames, raws, nsegs, dev)
                if split is None:
                    return None
                bad_pos, words, side = split
                # bad: malformed restart structure
                splits.append((sub, set(bad_pos), words, side, dev))
    else:
        with span("imgcodec.jpeg.index_scan"):
            ok, bad_scan, scan = scan_indexed(good, frames, raws, R, nsegs)
            if len(ok) < max(2, _MIN_BATCH // 2):
                return None
            leftover.extend(bad_scan)
            for sub, dev in _shards(ok, devices):
                with on_device(dev):
                    splits.append((sub,) + pack_indexed(
                        scan, sub, frames, R, nsegs, dev) + (dev,))
    R, _comp_map, tables = huffman_tables(f0, R)
    mcus_x = -(-f0.width // (8 * f0.hmax))
    mcus_y = -(-f0.height // (8 * f0.vmax))
    for ok, bad, words, side, dev in splits:
        with on_device(dev):
            words_d, side_d, tabs_d = upload(
                [words, side, staged_tables(tables, dev)], dev)
            tables_d, look_d = uploaded_tables(tabs_d, tables)
            with span("imgcodec.jpeg.device_entropy"):
                # K2 stores the stacks as K1 takes them: zigzag blocks
                coefs, err = decode_segments_into(
                    words_d, side_d, tables_d, look_d, R,
                    [(c.h, c.v) for c in f0.components], mcus_x, mcus_y,
                    len(ok), nsegs)
                # the flags come back while the pixel stage runs
                checks.append((ok, bad, nsegs) + _fetch(err, dev))
            imgs = _pixel_stage(f0, coefs, True, fancy, to_rgb, to_u8,
                                bitexact)
        for j, i in enumerate(ok):
            if j in bad:
                leftover.append(i)
            else:
                results[i] = DecodeResult(ProcessingStatus.SUCCESS, imgs[j])
        _count(kind, len(ok) - len(bad))
    return leftover


def _host_route(idxs, frames, raws, results, fancy, to_rgb, to_u8, bitexact,
                device, pool):
    """Native entropy decode into staging, upload, pixel stage."""
    frame0 = frames[idxs[0]]
    _, _, dims = frame0.mcu_geometry()
    b = len(idxs)
    with span("imgcodec.jpeg.staging"):
        bufs = [stage((b, bh, bw, 64), torch.int16, device)
                for (bw, bh) in dims]
        views = [s.numpy() for s in bufs]

    def fill(j):
        """Decode sample j into its slot; the error text if it is corrupt."""
        i = idxs[j]
        with charge("imgcodec.jpeg.host_entropy"):
            try:
                decode_coefficients_into(frames[i], raws[i],
                                         [v[j] for v in views])
            except ValueError as e:
                return str(e)
            return None

    with span("imgcodec.jpeg.host_entropy"):
        if pool is not None and b > 1:
            errors = list(pool.map(bind(fill), range(b)))
        else:
            errors = [fill(j) for j in range(b)]
    failed = {j for j, e in enumerate(errors) if e is not None}
    for j in failed:
        results[idxs[j]] = DecodeResult(_FAIL_CORRUPT, error=errors[j])
        for v in views:  # a half-written slot must not reach the pixels
            v[j] = 0
    coefs = upload(bufs, device)
    imgs = _pixel_stage(frame0, coefs, False, fancy, to_rgb, to_u8, bitexact)
    for j, i in enumerate(idxs):
        if j not in failed:
            results[i] = DecodeResult(ProcessingStatus.SUCCESS, imgs[j])
    _count("host", b - len(failed))


def decode_batch_cuda(data_batch, params: DecodeParams, device="cuda",
                      fancy: bool = True, bitexact: bool = False,
                      device_entropy: bool = True,
                      mesh=None) -> List[DecodeResult]:
    """Decode a list of JPEG streams on `device`, or with a mesh over its
    "dp" devices (each image on the device of its shard). device_entropy=
    False keeps every bucket on the host route (how flagged samples are
    re-issued)."""
    device = torch.device(device)
    shard_devices = (mesh.axis_devices("dp") if mesh is not None
                     else [device])
    n = len(data_batch)
    results: List[DecodeResult] = [None] * n  # type: ignore[list-item]
    nthreads = min(32, os.cpu_count() or 2)
    pool = _shared_pool("entropy", nthreads) if n > 1 else None

    with span("imgcodec.jpeg.parse"):
        parsed = parse_jpeg_batch(data_batch)
    frames, raws = {}, {}
    groups: Dict[tuple, list] = {}
    for i, (frame, err) in enumerate(parsed):
        if err is not None:  # a malformed stream fails alone
            results[i] = DecodeResult(_FAIL_CORRUPT, error=err)
            continue
        frames[i] = frame
        raws[i] = bytes(data_batch[i])
        groups.setdefault(geometry_key(frame), []).append(i)

    cs = params.color_spec
    to_rgb = not (cs is not None and int(cs) == int(ColorSpec.UNCHANGED))
    to_u8 = not params.allow_any_depth
    checks = []
    for group in groups.values():
        left = None
        if device_entropy:
            left = _try_device_entropy(group, frames, raws, results, fancy,
                                       to_rgb, to_u8, bitexact,
                                       shard_devices, checks)
        for idxs, dev in _shards(group if left is None else left,
                                 shard_devices):
            with on_device(dev):
                _host_route(idxs, frames, raws, results, fancy, to_rgb,
                            to_u8, bitexact, dev, pool)

    # K2's per-lane flags. On the idx route the index scan already walked
    # every symbol, so a flag means the kernel and the scan disagree; on the
    # dri route nothing else checked the symbols, so a flag is a corrupt
    # segment. Either way the sample is decoded again on the host route and
    # counted as re-issued.
    flagged = []
    for ok, bad, nsegs, err, event in checks:
        if event is not None:
            event.synchronize()  # waits for K2, not for the pixel stages
        err_np = err.numpy()
        for j, i in enumerate(ok):
            if j not in bad and err_np[j * nsegs:(j + 1) * nsegs].any():
                flagged.append(i)
    if flagged:
        redo = decode_batch_cuda([data_batch[i] for i in flagged], params,
                                 device, fancy, bitexact,
                                 device_entropy=False, mesh=mesh)
        for i, r in zip(flagged, redo):
            results[i] = r
        _count("reissued", len(flagged))
    return results


def decode_progressive(data, device="cuda", fancy: bool = True,
                       bitexact: bool = False) -> torch.Tensor:
    """Decode one Huffman-coded progressive JPEG with restart markers in
    every scan: K3 scan by scan (`decode_progressive_device`), then the
    pixel stage (K1, upsample, colour) with a batch axis of 1. Returns the
    image [H, W(, C)] on `device` (uint8; CMYK becomes RGB). Raises
    ValueError for a stream outside the route's scope or a corrupt one."""
    device = torch.device(device)
    raw = bytes(data)
    frame = parse_jpeg_structure(raw)
    with span("imgcodec.jpeg.prog_entropy"):
        planes = decode_progressive_device(frame, raw, device)
    img = _pixel_stage(frame, [p[None] for p in planes], True, fancy, True,
                       True, bitexact)
    return img[0]
