"""Public Decoder/Encoder API of the CUDA port.

The port of nvimagecodec_tpu/api.py. `Decoder(device=...)` runs the pixel
stage of JPEG and of JPEG2000 on that device ("cuda" unless told otherwise;
the CPU only when asked for, never by detection) and returns those images
there. Other formats, and the J2K streams that keep their pixel stage on the
host (ROI, a partial tile grid, discard_levels, small images), decode on the
host and come back as CPU tensors, so a mixed batch may lie on two devices:
`decode(..., to_device=True)` puts every returned image on the decoder's
device (the counterpart of the reference's `to_tpu`). `Decoder(mesh=...)`
shards the device stages over a `parallel.mesh.Mesh`: JPEG buckets over
"dp", J2K tiles or rows over "sp"; each image comes back on the device that
decoded it. Failed samples come back as None. EXIF orientation, ROI crop, GRAY and sample-format/type
conversion follow the reference (api.py:97-151). `Encoder(device=...)`
encodes JPEG with the pixel stage on that device and takes images that live
there as they are; other formats, JPEG2000 among them, encode on the host.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .codecs import port_registry
from .codecs.jpeg import (
    JpegCpuEncoder,
    JpegHybridCudaDecoder,
    JpegHybridCudaEncoder,
)
from .codecs.jpeg2000 import Jpeg2kHybridCudaDecoder
from .core.code_stream import CodeStream
from .core.interfaces import DecodeParams, EncodeParams
from .core.registry import CodecRegistry
from .core.scheduler import GenericDecoder, GenericEncoder
from .core.types import Backend, ColorSpec, ProcessingStatus
from .image import Image, apply_exif_orientation, as_image, as_tensor
from .ops.convert import convert, luma_bt601

_EXT_TO_CODEC = {
    ".bmp": "bmp",
    ".ppm": "pnm",
    ".pgm": "pnm",
    ".pbm": "pnm",
    ".pnm": "pnm",
    ".jpg": "jpeg",
    ".jpeg": "jpeg",
    ".jp2": "jpeg2k",
    ".j2k": "jpeg2k",
    "jp2": "jpeg2k",
    "j2k": "jpeg2k",
    "jpeg2000": "jpeg2k",
    "jpg": "jpeg",
    "png": "png",
    ".png": "png",
    ".tif": "tiff",
    "tif": "tiff",
    ".tiff": "tiff",
    ".webp": "webp",
    "webp": "webp",
}

Source = Union[bytes, bytearray, memoryview, str, os.PathLike, CodeStream]


class Decoder:
    """Batched image decoder (reference: python/decoder.cpp)."""

    def __init__(self, device="cuda",
                 backends: Optional[Sequence[Backend]] = None,
                 options: str = "", max_num_cpu_threads: int = 0,
                 registry: Optional[CodecRegistry] = None, executor=None,
                 mesh=None):
        """`mesh`: optional parallel.mesh.Mesh. The JPEG and J2K device
        stages shard over it, and the mesh's first device replaces `device`
        (the device of `to_device=True`)."""
        self.device = (mesh.first_device if mesh is not None
                       else torch.device(device))
        # the device reaches the JPEG and J2K plugins as their option; it
        # wins over a device named in `options`
        options = (f"{options} {JpegHybridCudaDecoder.plugin_id}:"
                   f"device={self.device} {Jpeg2kHybridCudaDecoder.plugin_id}:"
                   f"device={self.device}")
        self._generic = GenericDecoder(
            registry=registry or port_registry(), backends=backends,
            options=options, max_num_cpu_threads=max_num_cpu_threads,
            executor=executor, mesh=mesh)

    def decode(self, src, params: Optional[DecodeParams] = None,
               to_device: bool = False):
        """Decode one source or a list. to_device=True places every
        returned image on the decoder's device: host-decoded formats are
        uploaded, device-decoded ones stay where they are."""
        if isinstance(src, (list, tuple)):
            return self._decode_batch(list(src), params, to_device)
        return self._decode_batch([src], params, to_device)[0]

    def read(self, path, params: Optional[DecodeParams] = None,
             to_device: bool = False):
        """Decode from file path(s)."""
        return self.decode(path, params, to_device)

    def decode_async(self, sources, params: Optional[DecodeParams] = None):
        """Submit a batch; returns a ProcessingResultsFuture of raw
        DecodeResults (`wait_all()`, `wait_new()`)."""
        srcs = sources if isinstance(sources, (list, tuple)) else [sources]
        return self._generic.decode_batch_async(self._streams(srcs),
                                                params or DecodeParams())

    def _streams(self, sources) -> List[CodeStream]:
        return [s if isinstance(s, CodeStream)
                else CodeStream(s, self._generic.registry) for s in sources]

    def _decode_batch(self, sources: List[Source], params,
                      to_device: bool = False):
        params = params or DecodeParams()
        streams = self._streams(sources)
        results = self._generic.decode_batch(streams, params)
        out: List[Optional[Image]] = []
        for cs, r in zip(streams, results):
            if not (r.status & ProcessingStatus.SUCCESS) or r.array is None:
                out.append(None)
                continue
            t = as_tensor(r.array)
            info = cs.get_image_info()
            if params.apply_exif_orientation:
                t = apply_exif_orientation(t, info.orientation)
            if params.enable_roi and params.region is not None:
                rg = params.region
                if not (t.shape[0] == rg.height and t.shape[1] == rg.width):
                    t = t[rg.start_y:rg.end_y, rg.start_x:rg.end_x]
            if (params.color_spec is not None
                    and int(params.color_spec) == int(ColorSpec.GRAY)
                    and t.dim() == 3 and t.shape[-1] >= 3):
                t = luma_bt601(t)
            if (params.sample_format is not None
                    or params.sample_type is not None):
                t = convert(t, params.sample_format, params.sample_type)
            if to_device:
                t = t.to(self.device, non_blocking=True)
            out.append(Image(t.contiguous(), info))
        return out


class Encoder:
    """Batched image encoder (reference: python/encoder.cpp). JPEG goes
    through the CUDA encoder on `device`: an image that lives there is
    handed over as a tensor and never copied to the host whole; only its
    quantised coefficients are. Other codecs get numpy arrays."""

    def __init__(self, device="cuda",
                 backends: Optional[Sequence[Backend]] = None,
                 options: str = "", max_num_cpu_threads: int = 0,
                 registry: Optional[CodecRegistry] = None, executor=None):
        self.device = torch.device(device)
        # as for the Decoder: the device wins over one named in `options`
        options = (f"{options} {JpegHybridCudaEncoder.plugin_id}:"
                   f"device={self.device} {JpegCpuEncoder.plugin_id}:"
                   f"device={self.device}")
        self._generic = GenericEncoder(
            registry=registry or port_registry(), backends=backends,
            options=options, max_num_cpu_threads=max_num_cpu_threads,
            executor=executor)

    def encode(self, images, codec: str,
               params: Optional[EncodeParams] = None):
        """Encode image(s) to bytes; None where a sample failed."""
        single = not isinstance(images, (list, tuple))
        imgs = [images] if single else list(images)
        codec = _EXT_TO_CODEC.get(codec.lower(), codec.lower())
        arrays, infos = [], []
        for im in imgs:
            im = as_image(im)
            # the JPEG plugins take tensors wherever they live; the host
            # codecs need numpy
            arrays.append(im.array if codec == "jpeg"
                          else np.asarray(im.cpu()))
            infos.append(im.info)
        results = self._generic.encode_batch(arrays, infos, codec, params)
        data = [r.data if (r.status & ProcessingStatus.SUCCESS) else None
                for r in results]
        return data[0] if single else data

    def write(self, path, image, codec: str = "",
              params: Optional[EncodeParams] = None):
        """Encode to a file; the codec comes from the extension unless
        given."""
        if not codec:
            ext = os.path.splitext(os.fspath(path))[1].lower()
            codec = _EXT_TO_CODEC.get(ext, "")
            if not codec:
                raise ValueError(f"cannot infer codec from path {path!r}")
        data = self.encode(image, codec, params)
        if data is None:
            raise RuntimeError(f"encoding to {codec} failed")
        with open(path, "wb") as f:
            f.write(data)
        return path
