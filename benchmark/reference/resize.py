"""Plain bilinear resize in NumPy: half-pixel centres (align_corners
false, the OpenCV INTER_LINEAR convention), source indices clamped at the
edges, no antialiasing, float64, rounded half to even and clipped to
uint8. `bilinear_bounds` gives every image a float32 evaluation may give."""
from __future__ import annotations

import numpy as np

# a float32 evaluation of the weighted sums (weights rounded to float32,
# about ten operations on values below 256) lies within this of the exact
# value
RESIZE_SLACK = 32 * 2.0 ** -24 * 256


def _taps(n_in: int, n_out: int):
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = np.clip(s - i0, 0.0, 1.0)
    return i0, i1, w


def _interp(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The exact weighted sums, float64 [out_h, out_w, C]."""
    y0, y1, wy = _taps(img.shape[0], out_h)
    x0, x1, wx = _taps(img.shape[1], out_w)
    src = img.astype(np.float64)
    wx = wx[None, :, None]
    top = src[y0][:, x0] * (1 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1 - wx) + src[y1][:, x1] * wx
    return top * (1 - wy[:, None, None]) + bot * wy[:, None, None]


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [out_h, out_w, C]."""
    return _u8(_interp(img, out_h, out_w))


def bilinear_bounds(lo: np.ndarray, hi: np.ndarray, out_h: int, out_w: int):
    """(lo, hi) uint8: every resize of any image between lo and hi that a
    float32 evaluation may give (the weights are not negative, so the sums
    rise with every sample)."""
    return (_u8(_interp(lo, out_h, out_w) - RESIZE_SLACK),
            _u8(_interp(hi, out_h, out_w) + RESIZE_SLACK))
