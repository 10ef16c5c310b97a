"""Output sample-format / dtype conversions on tensors.

The port of nvimagecodec_tpu/ops/convert.py, with the same semantics
(reference analog: src/imgproc/convert.h ConvertSatNorm and the layout arms
of convert_kernel_gpu.cu): integer↔integer rescaled by the ratio of full
scales, integer↔float normalised to [0, 1] / [-1, 1], with saturation;
interleaved = HWC, planar = CHW.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import SampleDataType, SampleFormat
from .color import rgb_to_ycbcr_i32

_UNSIGNED = {
    SampleDataType.UINT8: 255.0,
    SampleDataType.UINT16: 65535.0,
    SampleDataType.UINT32: 4294967295.0,
}
_SIGNED = {
    SampleDataType.INT8: 127.0,
    SampleDataType.INT16: 32767.0,
    SampleDataType.INT32: 2147483647.0,
}
_FLOAT = (SampleDataType.FLOAT16, SampleDataType.FLOAT32, SampleDataType.FLOAT64)


def _max_of(t: SampleDataType) -> float:
    if t in _UNSIGNED:
        return _UNSIGNED[t]
    if t in _SIGNED:
        return _SIGNED[t]
    return 1.0  # floats are normalized

_TORCH = {
    SampleDataType.UINT8: torch.uint8,
    SampleDataType.INT8: torch.int8,
    SampleDataType.UINT16: torch.uint16,
    SampleDataType.INT16: torch.int16,
    SampleDataType.UINT32: torch.uint32,
    SampleDataType.INT32: torch.int32,
    SampleDataType.FLOAT16: torch.float16,
    SampleDataType.FLOAT32: torch.float32,
    SampleDataType.FLOAT64: torch.float64,
}


def _sample_type(t: torch.Tensor) -> SampleDataType:
    for k, v in _TORCH.items():
        if v == t.dtype:
            return k
    raise ValueError(f"unsupported sample type {t.dtype}")


def widen_uint16(t: torch.Tensor) -> torch.Tensor:
    """uint16 as int32 (few torch ops take uint16); anything else as it
    is."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t


def convert_dtype(t: torch.Tensor, dst: SampleDataType) -> torch.Tensor:
    """Saturating-normalised dtype conversion (ConvertSatNorm)."""
    src = _sample_type(t)
    if src == dst:
        return t
    dst_t = _TORCH[dst]
    src_max, dst_max = _max_of(src), _max_of(dst)
    if src in _FLOAT:
        if dst in _FLOAT:
            return t.to(dst_t)
        lo = -1.0 if dst in _SIGNED else 0.0
        v = t.to(torch.float32).clamp(lo, 1.0) * dst_max
        return v.round().to(dst_t)
    if dst in _FLOAT:
        return (t.to(torch.float32) / np.float32(src_max)).to(dst_t)
    if src == SampleDataType.UINT8 and dst == SampleDataType.UINT16:
        return (t.to(torch.int32) * 257).to(torch.uint16)  # exact
    v = (t.to(torch.float32) * np.float32(dst_max / src_max)).round()
    v = v.clamp(-dst_max - 1 if dst in _SIGNED else 0, dst_max)
    return v.to(dst_t)


def luma_bt601(t: torch.Tensor) -> torch.Tensor:
    """[..., >=3] RGB → [...] BT.601 luma, fixed point, in t's dtype."""
    r, g, b = (t[..., i].to(torch.int32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).to(t.dtype)


def _ensure_3ch(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 2:
        return torch.stack([t] * 3, dim=-1)
    if t.shape[-1] == 1:
        return torch.cat([t] * 3, dim=-1)
    return t[..., :3] if t.shape[-1] > 3 else t


def convert_format(t: torch.Tensor, fmt: SampleFormat) -> torch.Tensor:
    """Layout / channel-order conversion of an HWC (or HW) image."""
    if fmt in (SampleFormat.UNKNOWN, SampleFormat.I_UNCHANGED):
        return t
    if fmt == SampleFormat.P_UNCHANGED:
        return t.permute(2, 0, 1) if t.dim() == 3 else t
    if fmt == SampleFormat.P_Y:
        if t.dim() == 2:
            return t
        return t[..., 0] if t.shape[-1] == 1 else luma_bt601(t)
    if fmt == SampleFormat.P_YUV:
        a3 = _ensure_3ch(t)
        maxval = 65535 if a3.dtype == torch.uint16 else 255
        y, cb, cr = rgb_to_ycbcr_i32(a3[..., 0], a3[..., 1], a3[..., 2],
                                     maxval=maxval)
        return torch.stack([y, cb, cr], dim=0).to(t.dtype)
    a3 = _ensure_3ch(t)
    if fmt in (SampleFormat.I_BGR, SampleFormat.P_BGR):
        a3 = a3.flip(-1)
    if fmt in (SampleFormat.P_RGB, SampleFormat.P_BGR):
        return a3.permute(2, 0, 1)
    return a3


def convert(t: torch.Tensor, fmt=None, dtype=None) -> torch.Tensor:
    """Apply the (format, dtype) pair the decode params requested; the
    result is contiguous so exports stay zero-copy."""
    if fmt is not None:
        t = convert_format(t, SampleFormat(fmt))
    if dtype is not None:
        t = convert_dtype(t, SampleDataType(dtype))
    return t.contiguous()
