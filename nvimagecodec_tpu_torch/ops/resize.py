"""Image resize ops for the processing pipeline (improc), on torch tensors.

The port of nvimagecodec_tpu/ops/resize.py (the CV-CUDA crop/resize stage of
the modelled library's nvimproc sample, example/nvimproc/main.cpp:150-331).
Every function is batch-agnostic over [..., H, W] or [..., H, W, C] (channel
last for 3-D and up) and runs on the tensor's own device. Tap indices and
weights are computed with numpy exactly as the reference computes them and
uploaded once per (size in, size out, filter, device); the samples are
gathered with `index_select` and combined in the reference's order of
operations, so on the CPU the results equal the reference's numpy path.

`torch.nn.functional.interpolate` is not used: its bicubic is the a = -0.75
kernel (here Catmull-Rom, a = -0.5, the OpenCV INTER_CUBIC kernel), it has
no Lanczos and it treats borders differently.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.trace import span
from .convert import widen_uint16


def _spatial_axes(img: torch.Tensor):
    """(axis of rows, axis of columns), both negative."""
    return (-3, -2) if img.dim() >= 3 else (-2, -1)


def _finish(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round half to even and clip for integer images; floats pass."""
    if dtype.is_floating_point:
        return out
    maxv = 65535 if dtype == torch.uint16 else 255
    out = out.round().clamp(0, maxv)
    if dtype == torch.uint16:
        # not every build converts to uint16 directly
        return out.to(torch.int32).to(torch.int16).view(torch.uint16)
    return out.to(dtype)


@functools.lru_cache(maxsize=256)
def _bilinear_taps(n_in: int, n_out: int, device: torch.device):
    """(index of the sample before, of the one after, weight of the one
    after) for each output position: half-pixel centres, edges clamped."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int32)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = np.clip(s - i0, 0.0, 1.0).astype(np.float32)
    return (torch.from_numpy(i0.astype(np.int64)).to(device),
            torch.from_numpy(i1.astype(np.int64)).to(device),
            torch.from_numpy(w).to(device))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int):
    """Half-pixel-centers bilinear resize (align_corners=False, the OpenCV /
    CV-CUDA convention). Channel dim (if any) must be last."""
    ay, ax = _spatial_axes(img)
    y0, y1, wy = _bilinear_taps(img.shape[ay], out_h, img.device)
    x0, x1, wx = _bilinear_taps(img.shape[ax], out_w, img.device)
    src = widen_uint16(img)
    r0 = src.index_select(ay, y0)
    r1 = src.index_select(ay, y1)
    p00 = r0.index_select(ax, x0).to(torch.float32)
    p01 = r0.index_select(ax, x1).to(torch.float32)
    p10 = r1.index_select(ax, x0).to(torch.float32)
    p11 = r1.index_select(ax, x1).to(torch.float32)
    if img.dim() >= 3:
        wy_b, wx_b = wy[:, None, None], wx[None, :, None]
    else:
        wy_b, wx_b = wy[:, None], wx[None, :]
    top = p00 + (p01 - p00) * wx_b
    bot = p10 + (p11 - p10) * wx_b
    return _finish(top + (bot - top) * wy_b, img.dtype)


def crop(img, x: int, y: int, w: int, h: int):
    """Spatial crop with channel-last convention."""
    if img.dim() >= 3:
        return img[..., y: y + h, x: x + w, :]
    return img[..., y: y + h, x: x + w]


# -- separable filtered resize (bicubic / Lanczos) --------------------------

def _cubic_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic (a = -0.5: Catmull-Rom, the OpenCV INTER_CUBIC kernel)."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    w = np.where(
        t <= 1, (a + 2) * t3 - (a + 3) * t2 + 1,
        np.where(t < 2, a * t3 - 5 * a * t2 + 8 * a * t - 4 * a, 0.0))
    return w.astype(np.float32)


def _lanczos_kernel(t: np.ndarray, a: int = 4) -> np.ndarray:
    """Lanczos windowed sinc (a = 4: the OpenCV INTER_LANCZOS4 kernel)."""
    t = np.abs(t)
    w = np.sinc(t) * np.sinc(t / a)
    return np.where(t < a, w, 0.0).astype(np.float32)


def _axis_weights(n_in: int, n_out: int, taps: int, kernel):
    """Half-pixel-centers tap indices [n_out, taps] + normalized weights."""
    centers = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(centers).astype(np.int64) - (taps // 2 - 1)
    offs = np.arange(taps)
    idx = base[:, None] + offs[None, :]
    w = kernel(idx - centers[:, None])
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
    return np.clip(idx, 0, n_in - 1).astype(np.int32), w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _axis_weights_on(n_in: int, n_out: int, taps: int, kernel,
                     device: torch.device):
    """`_axis_weights` as tensors on `device`, tap-major: ([taps, n_out]
    int64 indices, [taps, n_out] float32 weights)."""
    idx, wts = _axis_weights(n_in, n_out, taps, kernel)
    return (torch.from_numpy(np.ascontiguousarray(idx.T.astype(np.int64)))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(wts.T)).to(device))


def _resize_separable(img: torch.Tensor, out_h: int, out_w: int, taps: int,
                      kernel):
    ay, ax = _spatial_axes(img)
    out = widen_uint16(img).to(torch.float32)
    for axis, n_out in ((ay, out_h), (ax, out_w)):
        idx, wts = _axis_weights_on(out.shape[axis], n_out, taps, kernel,
                                    img.device)
        shape = [1] * out.dim()
        shape[axis] = n_out
        acc = None
        for t in range(taps):  # first tap to last, as the reference sums
            tap = out.index_select(axis, idx[t]) * wts[t].reshape(shape)
            acc = tap if acc is None else acc + tap
        out = acc
    return _finish(out, img.dtype)


def resize_bicubic(img, out_h: int, out_w: int):
    """Catmull-Rom bicubic resize (OpenCV INTER_CUBIC convention)."""
    return _resize_separable(img, out_h, out_w, 4, _cubic_kernel)


def resize_lanczos(img, out_h: int, out_w: int):
    """Lanczos-4 resize (OpenCV INTER_LANCZOS4 convention)."""
    return _resize_separable(img, out_h, out_w, 8, _lanczos_kernel)


def resize(img, out_h: int, out_w: int, interp: str = "bilinear"):
    """Dispatch by interpolation name: bilinear | bicubic | lanczos."""
    with span("imgcodec.resize"):
        if interp == "bilinear":
            return resize_bilinear(img, out_h, out_w)
        if interp == "bicubic":
            return resize_bicubic(img, out_h, out_w)
        if interp == "lanczos":
            return resize_lanczos(img, out_h, out_w)
        raise ValueError(f"unknown interpolation {interp!r}")


def _moved(fn, img: torch.Tensor) -> torch.Tensor:
    """fn(img) for a function that only moves samples; uint16 goes through
    its int16 view (torch flips no uint16)."""
    if img.dtype == torch.uint16:
        return fn(img.view(torch.int16)).view(torch.uint16)
    return fn(img)


def rotate90(img, k: int = 1):
    """Rotate by k*90 degrees counter-clockwise (channel-last)."""
    return _moved(lambda t: torch.rot90(t, k % 4, dims=_spatial_axes(t)),
                  img)


def flip(img, horizontal: bool = False, vertical: bool = False):
    """Mirror along the spatial axes (channel-last)."""
    ay, ax = _spatial_axes(img)
    dims = [ay] * vertical + [ax] * horizontal
    return _moved(lambda t: t.flip(dims), img) if dims else img
