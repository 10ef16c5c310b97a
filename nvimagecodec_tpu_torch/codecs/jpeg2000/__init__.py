"""JPEG2000 codec backends of the port.

The port of nvimagecodec_tpu/codecs/jpeg2000/__init__.py (the modelled
library's nvjpeg2k extension: extensions/nvjpeg2k/, decoder with per-tile
parallel decode, cuda_decoder.cpp:601-640; encoder with reversible /
irreversible, code-block and progression options, cuda_encoder.cpp:272-474).
The split: host Tier-2 and EBCOT / HT Tier-1 (native C++, thread pool), then
IDWT + inverse MCT + level shift as torch ops on the decoder's device, or on
the host. The encoder is host code.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ...core.interfaces import (
    DecodeResult,
    DecoderPlugin,
    EncodeResult,
    EncoderPlugin,
    Jpeg2kEncodeParams,
)
from ...core.options import get_bool, get_int
from ...core.trace import bind
from ...core.types import BackendKind, Priority, ProcessingStatus
from ...ops.color import rgb_to_ycbcr_i32, ycbcr_to_rgb_i32
from ...ops.convert import widen_uint16
from ...ops.resample import downsample_h2v1, downsample_h2v2
from .codestream import jp2_colorspace
from .core import (
    J2kDeviceStageError,
    decode_j2k,
    device_route_auto,
    encode_j2k,
)

_J2K_MAGIC = b"\xff\x4f\xff\x51"
_JP2_MAGIC = b"\x00\x00\x00\x0cjP  "


def _is_j2k(data) -> bool:
    head = bytes(data[:12])
    return head[:4] == _J2K_MAGIC or head[:8] == _JP2_MAGIC[:8]


def _from_i32(v: torch.Tensor, like: torch.dtype) -> torch.Tensor:
    """int32 samples back to uint8, or to uint16 through the int16 view."""
    if like == torch.uint16:
        return v.to(torch.int16).view(torch.uint16)
    return v.to(like)


def _finish_tensor(t: torch.Tensor, sycc: bool, narrow: bool) -> torch.Tensor:
    if sycc and t.dim() == 3 and t.shape[2] == 3:
        maxv = 65535 if t.dtype == torch.uint16 else 255
        w = widen_uint16(t)
        r, g, b = ycbcr_to_rgb_i32(w[:, :, 0], w[:, :, 1], w[:, :, 2],
                                   maxval=maxv)
        t = _from_i32(torch.stack([r, g, b], dim=-1), t.dtype)
    if narrow and t.dtype == torch.uint16:
        t = (widen_uint16(t) >> 8).to(torch.uint8)
    return t


def _finish(img, sycc: bool, narrow: bool):
    """sYCC → RGB and the `>> 8` narrowing, on the tensor where it lives; a
    numpy image of the host path comes back as numpy. A tensor is the device
    stage's output, so a failure on it is a J2kDeviceStageError like any
    other of that stage."""
    if isinstance(img, np.ndarray):
        return _finish_tensor(torch.from_numpy(img), sycc, narrow).numpy()
    try:
        return _finish_tensor(img, sycc, narrow)
    except Exception as e:
        raise J2kDeviceStageError(
            f"J2K device pixel stage failed on {img.device}: "
            f"{type(e).__name__}: {e}") from e


class Jpeg2kHybridCudaDecoder(DecoderPlugin):
    """Host Tier-2 / Tier-1, pixel stage on `device`. Options: device,
    num_parallel_tiles (0: the thread pool's default), discard_levels
    (reduced-resolution decode), device_pixel_stage. Unset, the rule is
    `core.device_route_auto`: the stage for a CUDA device and an image of
    core.DEVICE_STAGE_MIN_PIXELS or more. device_pixel_stage is a switch for
    the tests and the smoke run (true forces the torch stage on `device`,
    false keeps the IDWT on the host), not a tuning knob.

    `mesh` is set by the scheduler for `Decoder(mesh=...)`: an image the
    rule above sends to the device stage then runs over the mesh (tiles or
    rows over "sp", `core.decode_j2k`); one it keeps on the host stays
    there, so the size floor holds with a mesh too. Never for an ROI
    request, as in the reference (codecs/jpeg2000/__init__.py:88-91).

    A stream the host stage rejects fails alone and goes on to the next
    decoder; a failure of the device stage is raised out of `decode_batch`
    once every sample's worker has ended."""

    codec = "jpeg2k"
    plugin_id = "cuda_jpeg2k_hybrid_decoder"
    backend_kind = BackendKind.HYBRID_CPU_GPU
    priority = Priority.HIGH
    device = torch.device("cuda")
    num_parallel_tiles = 0
    discard_levels = 0
    device_pixel_stage: Optional[bool] = None
    mesh = None

    def set_options(self, opts) -> None:
        self.device = torch.device(opts.get("device", "cuda"))
        self.num_parallel_tiles = get_int(opts, "num_parallel_tiles", 0)
        self.discard_levels = get_int(opts, "discard_levels", 0)
        self.device_pixel_stage = (
            get_bool(opts, "device_pixel_stage", True)
            if "device_pixel_stage" in opts else None)

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        return [
            ProcessingStatus.SUCCESS
            if _is_j2k(d)
            else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            for d in data_batch
        ]

    def _stage_device(self, info):
        if self.device_pixel_stage is None:
            on = device_route_auto(info.width * info.height, self.device)
        else:
            on = self.device_pixel_stage
        return self.device if on else None

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        # True ROI: only covering tiles / code-blocks are entropy-decoded.
        # ROI regions are small and per-sample: they take the host stage.
        roi = (params.region
               if params.enable_roi and params.region is not None
               and self.discard_levels == 0 else None)

        def one(data, info):
            raw = bytes(data)
            device = None if roi is not None else self._stage_device(info)
            # the mesh only for an image the device stage takes
            img = decode_j2k(
                raw, num_threads=self.num_parallel_tiles, device=device,
                discard_levels=self.discard_levels, region=roi,
                mesh=self.mesh if device is not None else None)
            # sYCC-tagged JP2 (the subsampled encodes): the upsampled YCbCr
            # goes back to RGB; 16-bit narrows unless any depth is allowed
            return _finish(img, jp2_colorspace(raw) == 18,
                           not params.allow_any_depth)

        # samples fan over the outer pool: each sample's T1 already fans
        # over code-blocks, so all cores stay busy across sample boundaries;
        # a sample's spans are children of the caller's (bind)
        jobs = list(zip(data_batch, info_batch))
        if len(jobs) > 1:
            task = bind(one)
            futs = [_sample_pool().submit(task, d, i) for d, i in jobs]
            outcomes = [_outcome(f.result) for f in futs]
        else:
            outcomes = [_outcome(one, d, i) for d, i in jobs]
        # every worker has ended: now a device failure may be raised
        for o in outcomes:
            if isinstance(o, J2kDeviceStageError):
                raise o
        return outcomes


_SAMPLE_POOL = [None]
_SAMPLE_POOL_LOCK = threading.Lock()


def _sample_pool() -> ThreadPoolExecutor:
    """The samples' pool: a thread a core, one for the process. Batches in
    flight at once (decode_batches' depth) share it, so they decode as many
    samples at once as there are cores, not that many each, and no batch
    starts threads of its own."""
    with _SAMPLE_POOL_LOCK:
        if _SAMPLE_POOL[0] is None:
            _SAMPLE_POOL[0] = ThreadPoolExecutor(
                max_workers=os.cpu_count() or 2,
                thread_name_prefix="j2k-sample")
        return _SAMPLE_POOL[0]


def _outcome(fn, *args):
    """fn's image as a DecodeResult; a host-stage error as a failed one; a
    device-stage error as the exception itself, for the caller to raise."""
    try:
        return DecodeResult(ProcessingStatus.SUCCESS, fn(*args))
    except J2kDeviceStageError as e:
        return e
    except Exception as e:  # the host stage: this sample fails alone
        return DecodeResult(
            ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
            error=str(e))


_SUBSAMPLING = {"CSS_420": (2, 2), "CSS_422": (2, 1),
                "420": (2, 2), "422": (2, 1)}


class Jpeg2kEncoder(EncoderPlugin):
    """Host encoder over `encode_j2k` (native 5/3 analysis and Tier-1; no
    device stage, as in the reference). Takes numpy arrays."""

    codec = "jpeg2k"
    plugin_id = "jpeg2k_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.HIGH

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for img in image_batch:
            a = np.asarray(img)
            ok = a.dtype in (np.uint8, np.uint16) and (
                a.ndim == 2 or a.shape[-1] in (1, 3)
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    @staticmethod
    def _psnr_to_quality(target_psnr: float) -> float:
        """Map a PSNR target to the quality knob using the measured ladder
        (q40≈36 dB … q95≈57 dB, ~0.38 dB per quality step) — the role of
        target_psnr in the modelled library's nvjpeg2k encoder
        (extensions/nvjpeg2k/cuda_encoder.cpp:272-474)."""
        return float(min(100.0, max(1.0, 40.0 + (target_psnr - 36.0) / 0.38)))

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        jp = params.jpeg2k or Jpeg2kEncodeParams()
        quality = params.quality
        # explicit non-default target_psnr takes precedence (reference
        # semantics: psnr-driven rate control)
        psnr_target = (
            params.target_psnr
            if params.target_psnr and params.target_psnr != 50.0
            else None
        )
        if psnr_target:
            quality = self._psnr_to_quality(psnr_target)
        out = []
        for img in image_batch:
            try:
                out.append(EncodeResult(
                    ProcessingStatus.SUCCESS,
                    self._encode_one(np.asarray(img), jp, quality,
                                     psnr_target, params)))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out

    @staticmethod
    def _encode_one(a: np.ndarray, jp, q, psnr_target, params) -> bytes:
        kw = dict(
            reversible=jp.reversible or q >= 100,
            levels=jp.num_resolutions - 1,
            quality=q,
            cblk=(jp.code_block_w, jp.code_block_h),
            stream_type=jp.stream_type,
            num_layers=getattr(jp, "num_layers", 1),
            prog_order=getattr(jp, "prog_order", "LRCP"),
            precincts=getattr(jp, "precincts", None),
            ht=getattr(jp, "ht", False),
            mode_switches=getattr(jp, "mode_switches", 0),
            # single-pass rate control: target_psnr drives the DWT-domain
            # rate allocator inside encode_j2k (ONE T1 encode)
            target_psnr=(psnr_target
                         if not jp.reversible and psnr_target
                         and q < 100 else None),
        )
        # chroma_subsampling: RGB → BT.601 YCbCr planes, box-filter chroma,
        # encode subsampled planar components with MCT off (the modelled
        # nvjpeg2k encoder accepts 444/422/420 image-info subsampling,
        # cuda_encoder.cpp:100-104)
        css = params.chroma_subsampling
        sub = None
        if css is not None and a.ndim == 3 and a.shape[2] == 3:
            name = getattr(css, "name", str(css))
            sub = _SUBSAMPLING.get(name.replace("ChromaSubsampling.", ""))
        if sub is None:
            return encode_j2k(a, **kw)
        if a.dtype == np.uint16:
            # 16-bit products of the fixed-point matrix leave int32 (the
            # reference's conversion raises on them too)
            raise ValueError("J2K: chroma subsampling of 16-bit images is "
                             "not supported")
        t = widen_uint16(torch.from_numpy(np.ascontiguousarray(a)))
        maxv = 65535 if a.dtype == np.uint16 else 255
        y, cb, cr = rgb_to_ycbcr_i32(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                     maxval=maxv)
        ds = downsample_h2v2 if sub == (2, 2) else downsample_h2v1
        planes = [p.numpy().astype(a.dtype) for p in (y, ds(cb), ds(cr))]
        kw.pop("target_psnr", None)  # planar path: quality knob
        return encode_j2k(planes, sub=[(1, 1), sub, sub], size=a.shape[:2],
                          colorspace="sycc", **kw)


def register(registry) -> None:
    codec = registry.codec("jpeg2k")
    codec.register_decoder(Jpeg2kHybridCudaDecoder())
    codec.register_encoder(Jpeg2kEncoder())
