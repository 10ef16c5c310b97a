"""Batched JPEG encode: a bucketed pixel stage on the device, Huffman on the
host.

The port of nvimagecodec_tpu/codecs/jpeg/batch_encode.py (`encode_batch_tpu`),
the counterpart of the modelled library's nvjpeg encoder
(extensions/nvjpeg/cuda_encoder.cpp:284-436), which runs colour conversion,
downsampling, fDCT and quantisation on the GPU and assembles the Huffman
bitstream on the host:

- samples sharing (shape, dtype) stack into one [B, H, W(, C)] tensor on the
  device and run ONE `encode_pixels` call: RGB→YCbCr, chroma downsample,
  fDCT+quant as a [N,64]x[64,64] float32 product. Images that already live
  on the device are stacked there; host images go up through one pinned
  buffer and one asynchronous copy;
- coefficients return as int16 (half the bytes of the int32 the quantiser
  produces; the values fit), one asynchronous copy per component into pinned
  memory and one event;
- the host stage (optimized-Huffman symbol counting, table build, entropy
  encode, container write) fans per sample over a thread pool; the native
  C++ entropy encoder releases the GIL.

`device_stage=False` keeps the whole encode on the host instead, per sample
over the pool: the fused native encoder where it covers the sample, else
the native pixel stage, else `encode_jpeg`. Progressive encodes take the
per-sample host path too (the multi-scan scheduler is host code).

With a mesh (`GenericEncoder(mesh=)`), every bucket splits into contiguous
shards of its samples, one per "dp" device: each shard is stacked and runs
`encode_pixels` on its device, and every shard's coefficients come back to
the host before the Huffman stage. The card's fDCT+quant product sums in a
fixed order (ops/kernels.fdct_quant_blocks), so the bytes equal the
unsharded encode's.

An error of the device stage raises out of `encode_batch_cuda`; a sample of
an unsupported shape or dtype, or one whose host stage fails, fails alone.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.interfaces import EncodeParams, EncodeResult, JpegEncodeParams
from ...core.trace import add_count, bind, charge, span
from ...core.types import ProcessingStatus
from ...parallel.mesh import shard_bounds
from .batch import _shared_pool, on_device
from .encode import (
    HuffTable,
    STD_AC_CHROMA,
    STD_AC_LUMA,
    STD_DC_CHROMA,
    STD_DC_LUMA,
    _entropy_encode,
    _resolve_css,
    build_encode_frame,
    count_symbols,
    encode_jpeg,
    encode_pixels,
    gen_optimal_table,
    jpeg_header_bytes,
)

# samples encoded per route since import (tests and the smoke run read it)
ROUTES = {"device": 0, "host": 0, "progressive": 0}
_ROUTES_LOCK = threading.Lock()

# what the native encoder stages raise for a sample they do not cover, or
# where the native library cannot be built or loaded
_NATIVE_DECLINED = (ValueError, OSError, RuntimeError)


def _count(route: str, n: int) -> None:
    with _ROUTES_LOCK:
        ROUTES[route] += n


def shape_dtype(img):
    """(shape, numpy dtype name) of an image given as a tensor or as
    anything numpy reads, without moving a device tensor to the host."""
    if isinstance(img, torch.Tensor):
        return tuple(img.shape), str(img.dtype).replace("torch.", "")
    a = np.asarray(img)
    return a.shape, str(a.dtype)


def _lives_on(img, device: torch.device) -> bool:
    """Whether `img` is a tensor of `device`'s type: on the device itself,
    or on another CUDA device, whence it is copied without the host."""
    return isinstance(img, torch.Tensor) and img.device.type == device.type


def host_array(img) -> np.ndarray:
    """The image as a numpy array; a device tensor is copied to the host."""
    if isinstance(img, torch.Tensor):
        return img.cpu().numpy()
    return np.asarray(img)


def _standard_tables(frame):
    std = lambda t: HuffTable(list(t[0][1:]), list(t[1]))  # noqa: E731
    dc_tables = {0: std(STD_DC_LUMA)}
    ac_tables = {0: std(STD_AC_LUMA)}
    if len(frame.components) > 1:
        dc_tables[1] = std(STD_DC_CHROMA)
        ac_tables[1] = std(STD_AC_CHROMA)
    return dc_tables, ac_tables


def bucket_frame(shape, params: EncodeParams, precision: int):
    """The frame of a [H, W(, 3)] bucket, table classes assigned (0 luma,
    1 chroma)."""
    nchan = 1 if len(shape) == 2 else shape[-1]
    frame = build_encode_frame(shape[0], shape[1], nchan, params.quality,
                               _resolve_css(params, nchan), precision)
    for ci, c in enumerate(frame.components):
        c.dc_tbl = c.ac_tbl = 0 if ci == 0 else 1
    return frame


def _standard_tail(frame):
    """What the samples of a bucket encoded with the standard tables share:
    (DC tables, AC tables, the bytes before the scan, the native scan
    encoder's arguments or None without the native library). Built once a
    bucket: per sample it would be Python under the GIL, which the pool's
    threads cannot overlap."""
    dc_tables, ac_tables = _standard_tables(frame)
    try:
        from .native_encode import scan_setup

        setup = scan_setup(frame, dc_tables, ac_tables)
    except _NATIVE_DECLINED:
        setup = None
    return (dc_tables, ac_tables,
            jpeg_header_bytes(frame, dc_tables, ac_tables), setup)


def _finish_one(frame, coefs: List[np.ndarray], jp: JpegEncodeParams,
                tail=None) -> bytes:
    """Host stage for one sample: Huffman tables + entropy + container.
    `tail` may carry the bucket's `_standard_tail(frame)`."""
    if jp.optimized_huffman:
        try:
            from .native_encode import count_symbols_native

            dc_counts, ac_counts = count_symbols_native(frame, coefs)
        except _NATIVE_DECLINED:
            dc_counts, ac_counts = count_symbols(frame, coefs)
        dc_tables = {i: gen_optimal_table(f) for i, f in dc_counts.items()}
        ac_tables = {i: gen_optimal_table(f) for i, f in ac_counts.items()}
        header = jpeg_header_bytes(frame, dc_tables, ac_tables)
        setup = None
    else:
        dc_tables, ac_tables, header, setup = tail or _standard_tail(frame)
    entropy = _entropy_encode(frame, coefs, dc_tables, ac_tables, setup=setup)
    return header + entropy + b"\xff\xd9"


def _results(futs) -> List[EncodeResult]:
    out = []
    for f in futs:
        try:
            out.append(EncodeResult(ProcessingStatus.SUCCESS, f.result()))
        except Exception as e:  # one sample's failure stays its own
            out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
    return out


def _encode_on_host(image_batch, params: EncodeParams, jp) -> List[EncodeResult]:
    """The host route: the full pipeline (colour + downsample + fDCT/quant +
    Huffman) per sample over the pool, in native C++ with the GIL released
    where the native stages cover the sample."""
    setup_cache: Dict[tuple, tuple] = {}

    def one(img):
        a = host_array(img)
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        if a.dtype == np.uint8 and not jp.optimized_huffman:
            # fused single native call (colour→downsample→fDCT→Huffman in
            # one MCU-row-resident pass) + cached header prefix
            try:
                from .native_encode import encode_scan_fused, fused_setup

                cached = setup_cache.get(a.shape)
                if cached is None:
                    frame = bucket_frame(a.shape, params, 8)
                    dc_t, ac_t = _standard_tables(frame)
                    cached = (frame, jpeg_header_bytes(frame, dc_t, ac_t),
                              fused_setup(frame, dc_t, ac_t))
                    setup_cache[a.shape] = cached
                frame, header, setup = cached
                scan = encode_scan_fused(a, frame, None, None, setup=setup)
                return header + scan + b"\xff\xd9"
            except _NATIVE_DECLINED:
                pass
        try:
            from .native_encode import encode_pixels_native

            frame = bucket_frame(a.shape, params, 8)
            return _finish_one(frame, encode_pixels_native(a, frame), jp)
        except _NATIVE_DECLINED:
            return encode_jpeg(a, params)  # array-path fallback

    pool = _shared_pool("encode", min(16, os.cpu_count() or 2))
    out = _results([pool.submit(one, img) for img in image_batch])
    _count("host", sum(bool(r.status & ProcessingStatus.SUCCESS)
                       for r in out))
    return out


def _stack_bucket(images, shape, dt: str, device, pool) -> torch.Tensor:
    """One [B, H, W(, C)] tensor on `device` from same-shape images given in
    the order: tensors that live on `device` first, the rest after. The first
    are stacked where they are; the rest are gathered (over `pool`: numpy
    copies release the GIL) in one staging buffer, pinned for a CUDA device,
    and go up in one asynchronous copy."""
    bits = torch.int16 if dt == "uint16" else torch.uint8  # stackable dtype
    there = [im for im in images if _lives_on(im, device)]
    rest = images[len(there):]
    parts = []
    if there:
        parts.append(torch.stack([
            t.reshape(shape).view(bits).to(device, non_blocking=True)
            for t in there]))
    if rest:
        stage = torch.empty((len(rest),) + tuple(shape), dtype=bits,
                            pin_memory=device.type == "cuda")
        stage_np = stage.numpy().view(dt)

        def gather(j):
            with charge("imgcodec.jpeg.encode_stack"):
                stage_np[j] = host_array(rest[j]).reshape(shape)

        list(pool.map(bind(gather), range(len(rest))))
        parts.append(stage.to(device, non_blocking=True))
    x = parts[0] if len(parts) == 1 else torch.cat(parts)
    return x.view(torch.uint16) if dt == "uint16" else x


def _start_fetch(coefs, device):
    """Start the copy of per-component int16 coefficients to the host: one
    asynchronous copy each into pinned memory and one event (None on the
    CPU). Returns (host tensors, event)."""
    if device.type != "cuda":
        return coefs, None
    hosts = []
    for c in coefs:
        h = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
        h.copy_(c, non_blocking=True)
        hosts.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    add_count("imgcodec.jpeg.d2h_bytes", sum(h.nbytes for h in hosts))
    return hosts, event


def _fetch_coefficients(coefs, device) -> List[np.ndarray]:
    """Per-component int16 coefficients on the host (`_start_fetch`, then
    the wait)."""
    hosts, event = _start_fetch(coefs, device)
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in hosts]


def encode_batch_cuda(image_batch, params: Optional[EncodeParams] = None,
                      device="cuda", device_stage: bool = True,
                      mesh=None) -> List[EncodeResult]:
    """Encode images (tensors on any device, or numpy arrays; [H, W],
    [H, W, 1] or [H, W, 3]; uint8, or uint16 holding 12-bit samples) to
    baseline JPEG streams, the pixel stage on `device`, or with a mesh on
    its "dp" devices, a contiguous shard of every bucket each.

    device_stage=False runs the whole encode on the host instead."""
    params = params or EncodeParams()
    jp = params.jpeg or JpegEncodeParams()
    device = torch.device(device)
    n = len(image_batch)

    if jp.progressive:
        # progressive needs the multi-scan host scheduler — per-sample path
        out = []
        for img in image_batch:
            try:
                out.append(EncodeResult(ProcessingStatus.SUCCESS,
                                        encode_jpeg(host_array(img), params)))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        _count("progressive", n)
        return out
    if not device_stage:
        return _encode_on_host(image_batch, params, jp)

    # 1) bucket by geometry (dims, channels, dtype → same frame)
    results: List[EncodeResult] = [None] * n  # type: ignore[list-item]
    groups: Dict[tuple, list] = {}
    for i, img in enumerate(image_batch):
        shape, dt = shape_dtype(img)
        if len(shape) == 3 and shape[-1] == 1:
            shape = shape[:2]
        if len(shape) not in (2, 3) or (len(shape) == 3 and shape[-1] != 3):
            results[i] = EncodeResult(
                ProcessingStatus.FAIL,
                error=f"unsupported image shape {shape}")
        elif dt not in ("uint8", "uint16"):
            results[i] = EncodeResult(ProcessingStatus.FAIL,
                                      error=f"unsupported dtype {dt}")
        else:
            groups.setdefault((shape, dt), []).append(i)

    pool = _shared_pool("encode", min(16, os.cpu_count() or 2))
    shard_devices = (mesh.axis_devices("dp") if mesh is not None
                     else [device])
    for (shape, dt), group in groups.items():
        frame = bucket_frame(shape, params, 12 if dt == "uint16" else 8)
        # per sample: (index, its shard's host coefficients, row in them)
        samples = []
        with span("imgcodec.jpeg.encode_device_stage"):
            fetches = []
            for (lo, hi), dev in zip(shard_bounds(len(group),
                                                  len(shard_devices)),
                                     shard_devices):
                if lo == hi:
                    continue
                # images already on the device first (see _stack_bucket)
                idxs = sorted(group[lo:hi],
                              key=lambda i: not _lives_on(image_batch[i],
                                                          dev))
                with on_device(dev):
                    with span("imgcodec.jpeg.encode_stack"):
                        x = _stack_bucket([image_batch[i] for i in idxs],
                                          shape, dt, dev, pool)
                    with span("imgcodec.jpeg.encode_pixels"):
                        coefs = [c.to(torch.int16)
                                 for c in encode_pixels(x, frame, dev)]
                        fetches.append((idxs, _start_fetch(coefs, dev)))
            with span("imgcodec.jpeg.encode_d2h_wait"):
                for idxs, (hosts, event) in fetches:
                    if event is not None:
                        event.synchronize()
                    coefs_host = [h.numpy() for h in hosts]
                    samples.extend((i, coefs_host, j)
                                   for j, i in enumerate(idxs))

        with span("imgcodec.jpeg.encode_host_entropy"):
            tail = None if jp.optimized_huffman else _standard_tail(frame)

            def one(coefs_host, j):
                with charge("imgcodec.jpeg.encode_host_entropy"):
                    return _finish_one(frame, [c[j] for c in coefs_host], jp,
                                       tail)

            task = bind(one)
            done = _results([pool.submit(task, c, j)
                             for _i, c, j in samples])
        for (i, _c, _j), r in zip(samples, done):
            results[i] = r
        _count("device", sum(bool(r.status & ProcessingStatus.SUCCESS)
                             for r in done))
    return results
