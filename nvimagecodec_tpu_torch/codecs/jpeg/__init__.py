"""JPEG codec backends of the CUDA port.

The port of nvimagecodec_tpu/codecs/jpeg/__init__.py (the modelled library's
nvjpeg extension: extensions/nvjpeg/ — HW/CUDA/lossless decoders + CUDA
encoder, priority ladder at nvjpeg_ext.cpp:42-47). The ladder:

- `cuda_jpeg_hybrid_decoder` (HYBRID_CPU_GPU, HIGH): host parse, index scan
  and entropy decode where needed, GPU kernels for Huffman decode and the
  pixel stage (codecs/jpeg/batch.py);
- `cpu_jpeg_decoder` (CPU_ONLY, NORMAL): native host entropy decode (Python
  fallback) + the port's pixel stage on CPU tensors, where K1 takes its plain
  version; true ROI decode. Within 1 of the JAX package's numpy decoder,
  exact with `bitexact`;
- the lossless decoder (codecs/jpeg/lossless.py);
- `cuda_jpeg_hybrid_encoder` (HYBRID_CPU_GPU, HIGH): the bucketed pixel
  stage on the device, Huffman on the host (codecs/jpeg/batch_encode.py);
- `cpu_jpeg_encoder` (CPU_ONLY, NORMAL): per-sample pixel stage + native
  Huffman (codecs/jpeg/encode.py).
"""
from __future__ import annotations

from typing import List

import torch

from ...core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeResult,
    EncoderPlugin,
)
from ...core.options import get_bool, get_int
from ...core.types import BackendKind, ColorSpec, Priority, ProcessingStatus
from .headers import JpegFrame, parse_jpeg_structure
from .pixel import assemble_image_i32, cmyk_to_rgb_i32, idct_planes


def _entropy_decode(frame: JpegFrame, data: bytes):
    """Native C++ entropy decoder when available, Python reference otherwise."""
    try:
        from .native import decode_coefficients_native

        return decode_coefficients_native(frame, data)
    except Exception:
        from .entropy_py import decode_coefficients

        return decode_coefficients(frame, data)


def _supported(frame: JpegFrame) -> ProcessingStatus:
    if frame.is_lossless:
        return ProcessingStatus.FAIL | ProcessingStatus.ENCODING_UNSUPPORTED
    if frame.marker in (0xCB, 0xCD, 0xCE, 0xCF, 0xC5, 0xC6, 0xC7):
        # differential / lossless-arithmetic stay unsupported; sequential
        # and progressive arithmetic (0xC9/0xCA) decode natively
        return ProcessingStatus.FAIL | ProcessingStatus.ENCODING_UNSUPPORTED
    if frame.precision not in (8, 12):
        return ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
    if len(frame.components) not in (1, 3, 4):
        return ProcessingStatus.FAIL | ProcessingStatus.NUM_CHANNELS_UNSUPPORTED
    return ProcessingStatus.SUCCESS


_SUPPORTED_ENCODINGS = {0xC0, 0xC1, 0xC2, 0xC9, 0xCA}  # Huffman + arithmetic (T.81 Annex K)


def _roi_ok(info, params) -> bool:
    """Codec-level ROI is only sound when the region coordinates are in
    stream space — an EXIF-rotated image whose orientation will be applied
    afterwards must decode fully and crop at the API layer."""
    if not (params.enable_roi and params.region is not None):
        return False
    if not params.apply_exif_orientation:
        return True
    o = getattr(info, "orientation", None)
    return o is None or int(o) == 1  # Orientation.NORMAL


class _JpegDecoderBase(DecoderPlugin):
    codec = "jpeg"
    bitexact = False  # integer islow IDCT: byte-exact vs libjpeg-turbo

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        # Judge from the already-parsed ImageInfo (cached by CodeStream) —
        # re-parsing the full structure here doubled the host cost of the
        # hot path (reference likewise reuses parsed stream info in
        # canDecode, extensions/nvjpeg/cuda_decoder.cpp:124-174).
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                if info is None or info.codec != "jpeg":
                    frame = parse_jpeg_structure(bytes(data))
                    out.append(_supported(frame))
                    continue
                enc = int(info.jpeg_encoding)
                if enc not in _SUPPORTED_ENCODINGS:
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.ENCODING_UNSUPPORTED
                    )
                elif info.planes and info.planes[0].precision not in (0, 8, 12):
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
                    )
                elif info.num_planes not in (1, 3, 4):
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.NUM_CHANNELS_UNSUPPORTED
                    )
                else:
                    out.append(ProcessingStatus.SUCCESS)
            except Exception:
                out.append(ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED)
        return out

    def _decode_one(self, data: bytes, params: DecodeParams,
                    roi_ok: bool = True) -> torch.Tensor:
        """One stream → image [H, W(, C)] on the CPU, through the port's
        pixel stage."""
        frame = parse_jpeg_structure(data)
        img = None
        if roi_ok and params.enable_roi and params.region is not None:
            # True ROI: entropy-skip + windowed pixel stage (reference: nvjpeg
            # ROI, extensions/nvjpeg/cuda_decoder.cpp:460-520). Falls back to
            # full decode (API-level crop) on unsupported streams.
            try:
                from .roi import decode_pixels_roi

                img = decode_pixels_roi(
                    frame, data, params.region,
                    fancy=getattr(self, "fancy_upsampling", True),
                    bitexact=self.bitexact,
                )
            except Exception:
                img = None
        if img is None:
            coefs = [torch.from_numpy(c) for c in _entropy_decode(frame, data)]
            planes = idct_planes(frame, coefs, bitexact=self.bitexact)
            img = assemble_image_i32(frame, planes)
        narrow = frame.precision <= 8
        if not narrow and not params.allow_any_depth:
            # default u8 output (reference python default,
            # python/decoder.cpp:156-225; allow_any_depth keeps u16)
            img = img >> (frame.precision - 8)
            narrow = True
        if img.dim() == 3 and img.shape[-1] == 4:
            # CMYK/YCCK → RGB by default; UNCHANGED keeps native channels
            # (reference: color_spec routing, python/decoder.cpp:156-225)
            cs = getattr(params, "color_spec", None)
            if not (cs is not None and int(cs) == int(ColorSpec.UNCHANGED)):
                img = cmyk_to_rgb_i32(img) & 0xFF
                narrow = True
        return img.to(torch.uint8 if narrow else torch.uint16)

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS,
                        self._decode_one(bytes(data), params,
                                         roi_ok=_roi_ok(info, params)),
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class JpegHybridCudaDecoder(_JpegDecoderBase):
    """Batched decode on `device` (a CUDA device, or the CPU with the
    kernels' plain versions). Options: device, fancy_upsampling, bitexact,
    device_entropy (false keeps every bucket on the host entropy route, the
    JAX package's TIC_NO_DEVICE_ENTROPY), and host_pool_mb /
    host_pool_per_key_cap, accepted for the JAX package's sake and handed
    to `batch.configure_host_pool`, which does nothing. `mesh` is set by the
    scheduler for `Decoder(mesh=...)`: buckets shard over its "dp"
    devices."""

    plugin_id = "cuda_jpeg_hybrid_decoder"
    backend_kind = BackendKind.HYBRID_CPU_GPU
    priority = Priority.HIGH
    fancy_upsampling = True
    device = torch.device("cuda")
    device_entropy = True
    mesh = None

    def set_options(self, opts) -> None:
        from .batch import configure_host_pool

        self.device = torch.device(opts.get("device", "cuda"))
        self.fancy_upsampling = get_bool(opts, "fancy_upsampling", True)
        self.bitexact = get_bool(opts, "bitexact", False)
        self.device_entropy = get_bool(opts, "device_entropy", True)
        pool_mb = get_int(opts, "host_pool_mb", 0)
        pool_cap = get_int(opts, "host_pool_per_key_cap", 0)
        if pool_mb or pool_cap:
            configure_host_pool(max_mb=pool_mb or None,
                                per_key_cap=pool_cap or None)

    def decode_batch(self, data_batch, info_batch,
                     params) -> List[DecodeResult]:
        # an ROI request decodes the whole image; the API layer crops
        from .batch import decode_batch_cuda

        return decode_batch_cuda(data_batch, params, self.device,
                                 fancy=self.fancy_upsampling,
                                 bitexact=self.bitexact,
                                 device_entropy=self.device_entropy,
                                 mesh=self.mesh)


class JpegCpuDecoder(_JpegDecoderBase):
    plugin_id = "cpu_jpeg_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def set_options(self, opts) -> None:
        # bitexact=true: integer islow IDCT — decodes match libjpeg-turbo
        # byte-exactly
        self.bitexact = get_bool(opts, "bitexact", False)


def _can_encode(image_batch) -> List[ProcessingStatus]:
    """uint8/uint16 images of 1 or 3 channels, judged from shape and dtype
    alone (a device tensor stays where it is)."""
    from .batch_encode import shape_dtype

    out = []
    for img in image_batch:
        shape, dt = shape_dtype(img)
        ok = dt in ("uint8", "uint16") and (
            len(shape) == 2 or shape[-1] in (1, 3))
        out.append(
            ProcessingStatus.SUCCESS
            if ok
            else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
        )
    return out


class JpegHybridCudaEncoder(EncoderPlugin):
    """Batched encoder: bucketed fDCT/quant on `device` (a CUDA device, or
    the CPU) + native host Huffman (the modelled library's HYBRID_CPU_GPU
    nvjpeg encoder slot, extensions/nvjpeg/cuda_encoder.cpp:284-436). First
    in the chain. Only a sample it rejects in `can_encode` goes on to
    cpu_jpeg_encoder: one whose host stage fails after that fails alone,
    and an error of its device stage raises. Options: device, device_stage
    (false keeps the whole encode on the host). `mesh` is set by the
    scheduler for `GenericEncoder(mesh=...)`: buckets shard over its "dp"
    devices."""

    codec = "jpeg"
    plugin_id = "cuda_jpeg_hybrid_encoder"
    backend_kind = BackendKind.HYBRID_CPU_GPU
    priority = Priority.HIGH
    device = torch.device("cuda")
    device_stage = True
    mesh = None

    def set_options(self, opts) -> None:
        self.device = torch.device(opts.get("device", "cuda"))
        self.device_stage = get_bool(opts, "device_stage", True)

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        return _can_encode(image_batch)

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        from .batch_encode import encode_batch_cuda

        return encode_batch_cuda(image_batch, params, self.device,
                                 device_stage=self.device_stage,
                                 mesh=self.mesh)


class JpegCpuEncoder(EncoderPlugin):
    """Per-sample encoder. Options: device_pixel_stage (true runs
    `encode_pixels` on `device` instead of on the CPU), device."""

    codec = "jpeg"
    plugin_id = "cpu_jpeg_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL
    device_pixel_stage = False
    device = None  # the pixel stage's device, once device_pixel_stage is set

    def set_options(self, opts) -> None:
        self.device_pixel_stage = get_bool(opts, "device_pixel_stage", False)
        self.device = (torch.device(opts.get("device", "cuda"))
                       if self.device_pixel_stage else None)

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        return _can_encode(image_batch)

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        # fan samples over a thread pool (torch pixel stage + GIL-releasing
        # native entropy encode — the executor fan-out analog,
        # extensions/nvjpeg/cuda_encoder.cpp per-sample tasks)
        import os
        from concurrent.futures import ThreadPoolExecutor

        from .batch_encode import host_array
        from .encode import encode_jpeg

        def one(img):
            return encode_jpeg(host_array(img), params, device=self.device)

        if len(image_batch) > 1:
            with ThreadPoolExecutor(
                max_workers=min(len(image_batch), os.cpu_count() or 2)
            ) as pool:
                futs = [pool.submit(one, img) for img in image_batch]
                out = []
                for f in futs:
                    try:
                        out.append(EncodeResult(ProcessingStatus.SUCCESS, f.result()))
                    except Exception as e:
                        out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
                return out
        out = []
        for img in image_batch:
            try:
                out.append(EncodeResult(ProcessingStatus.SUCCESS, one(img)))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


def register(registry) -> None:
    from .lossless import JpegLosslessDecoder

    codec = registry.codec("jpeg")
    codec.register_decoder(JpegHybridCudaDecoder())
    codec.register_decoder(JpegCpuDecoder())
    codec.register_decoder(JpegLosslessDecoder())
    codec.register_encoder(JpegHybridCudaEncoder())
    codec.register_encoder(JpegCpuEncoder())
