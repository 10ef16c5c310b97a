"""Image: decoded pixels in a torch tensor, on the host or a CUDA device.

The port of nvimagecodec_tpu/image.py (reference analog: python/image.cpp
:433-480). Host plugins' numpy results are wrapped with `torch.from_numpy`,
without a copy. `.cpu()`/`.cuda()` migrate; `__array__`,
`__array_interface__`, `__cuda_array_interface__` and `__dlpack__` export.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.image_info import ImageInfo
from .core.types import Orientation


def as_tensor(a) -> torch.Tensor:
    """A torch tensor for a decoder result: tensors pass through, numpy
    arrays are wrapped without a copy where their strides allow it."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        a = np.array(a)
    return torch.from_numpy(a)


def apply_exif_orientation(t: torch.Tensor, orientation) -> torch.Tensor:
    """Undo EXIF orientation so the pixels are upright ([H, W(, C)])."""
    o = Orientation(orientation)
    if o == Orientation.MIRROR_HORIZONTAL:
        return t.flip(1)
    if o == Orientation.ROTATE_180:
        return t.flip(0).flip(1)
    if o == Orientation.MIRROR_VERTICAL:
        return t.flip(0)
    if o == Orientation.MIRROR_HORIZONTAL_ROTATE_270_CW:
        return t.transpose(0, 1)
    if o == Orientation.ROTATE_90_CW:
        return t.transpose(0, 1).flip(1)
    if o == Orientation.MIRROR_HORIZONTAL_ROTATE_90_CW:
        return t.transpose(0, 1).flip(0).flip(1)
    if o == Orientation.ROTATE_270_CW:
        return t.transpose(0, 1).flip(0)
    return t


class Image:
    """Decoded image handle backed by a torch tensor."""

    def __init__(self, array, info: Optional[ImageInfo] = None):
        self._tensor = as_tensor(array)
        self.info = info

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self):
        return np.dtype(str(self._tensor.dtype).replace("torch.", ""))

    @property
    def ndim(self) -> int:
        return self._tensor.dim()

    @property
    def height(self) -> int:
        return self._tensor.shape[0]

    @property
    def width(self) -> int:
        return self._tensor.shape[1]

    @property
    def device(self) -> torch.device:
        return self._tensor.device

    @property
    def buffer_kind(self) -> str:
        """'strided_host' or 'strided_device' (reference:
        nvimgcodecImageBufferKind_t)."""
        return ("strided_host" if self._tensor.device.type == "cpu"
                else "strided_device")

    @property
    def array(self) -> torch.Tensor:
        return self._tensor

    def cpu(self) -> "Image":
        if self._tensor.device.type == "cpu":
            return self
        return Image(self._tensor.cpu(), self.info)

    def cuda(self, device=None) -> "Image":
        t = self._tensor.cuda(device)
        return self if t is self._tensor else Image(t, self.info)

    def __array__(self, dtype=None, copy=None):
        a = self._tensor.cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    @property
    def __array_interface__(self):
        if self._tensor.device.type != "cpu":
            raise AttributeError("device image: use .cpu() first")
        return self._tensor.numpy().__array_interface__

    @property
    def __cuda_array_interface__(self):
        return self._tensor.__cuda_array_interface__

    def __dlpack__(self, *args, **kwargs):
        return self._tensor.__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._tensor.__dlpack_device__()

    def __repr__(self):
        return f"Image({self.shape}, {self.dtype}, {self._tensor.device})"


def as_image(source, info: Optional[ImageInfo] = None) -> Image:
    """Zero-copy import from tensors, arrays and DLPack producers."""
    if isinstance(source, Image):
        return source
    if isinstance(source, (torch.Tensor, np.ndarray)):
        return Image(source, info)
    if hasattr(source, "__dlpack__"):
        return Image(torch.from_dlpack(source), info)
    if hasattr(source, "__array_interface__") or hasattr(source, "__array__"):
        return Image(np.asarray(source), info)
    raise TypeError(f"cannot import image from {type(source)!r}")


def as_images(sources) -> list:
    return [as_image(s) for s in sources]


def from_dlpack(source) -> Image:
    return as_image(source)
