"""Lossless JPEG (SOF3) decode plugin.

Counterpart of the reference's nvjpeg lossless decoder
(extensions/nvjpeg/lossless_decoder.cpp:82-87,255-257 — a separate plugin
that only accepts SOF3 streams). Prediction is sample-serial host work
(native/jpeg_lossless.cpp); a test-side reference encoder exercises all
seven predictors and point transforms."""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from ...core.interfaces import DecodeParams, DecodeResult, DecoderPlugin
from ...core.types import BackendKind, JpegEncoding, Priority, ProcessingStatus


def decode_lossless(data: bytes, width: int, height: int, ncomp: int) -> np.ndarray:
    from ...native import lib

    L = lib()
    out = np.zeros(height * width * ncomp, np.uint16)
    ow = ctypes.c_int32()
    oh = ctypes.c_int32()
    onc = ctypes.c_int32()
    oprec = ctypes.c_int32()
    rc = L.tic_jpeg_lossless_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size, ctypes.byref(ow), ctypes.byref(oh), ctypes.byref(onc),
        ctypes.byref(oprec),
    )
    if rc != 0:
        raise ValueError(f"lossless JPEG decode failed rc={rc}")
    img = out.reshape(oh.value, ow.value, onc.value)
    if oprec.value <= 8:
        img = img.astype(np.uint8)
    return img[:, :, 0] if onc.value == 1 else img


class JpegLosslessDecoder(DecoderPlugin):
    codec = "jpeg"
    plugin_id = "cpu_jpeg_lossless_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.HIGH

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data, info in zip(data_batch, info_batch):
            ok = (
                info is not None
                and info.codec == "jpeg"
                and info.jpeg_encoding == JpegEncoding.LOSSLESS_HUFFMAN
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.ENCODING_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                img = decode_lossless(
                    bytes(data), info.width, info.height, info.num_planes
                )
                if not params.allow_any_depth and img.dtype == np.uint16:
                    img = (img >> 8).astype(np.uint8)
                out.append(DecodeResult(ProcessingStatus.SUCCESS, img))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out
