"""Colour conversions on int32 tensors, integer-exact to libjpeg.

The torch counterpart of nvimagecodec_tpu/ops/color.py (:36-120): the same
fixed-point constants (round(x * 65536) of the T.871 matrix) and the same
arithmetic shifts, so the port matches the reference sample for sample.
"""
from __future__ import annotations

import torch

# round(coef * 2^16)
_FIX_1_40200 = 91881
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802
_FIX_1_77200 = 116130

_FIX_0_29900 = 19595
_FIX_0_58700 = 38470
_FIX_0_11400 = 7471
_FIX_0_16874 = 11059
_FIX_0_33126 = 21709
_FIX_0_50000 = 32768
_FIX_0_41869 = 27439
_FIX_0_08131 = 5329

_ONE_HALF = 1 << 15


def ycbcr_to_rgb_i32(y, cb, cr, maxval: int = 255):
    """Full-range (JFIF) YCbCr → RGB, libjpeg jdcolor.c fixed-point exact;
    int32 in [0, maxval] → (r, g, b) int32 clipped to [0, maxval]."""
    center = (maxval + 1) >> 1
    y = y.to(torch.int32)
    cbc = cb.to(torch.int32) - center
    crc = cr.to(torch.int32) - center
    r = y + ((_FIX_1_40200 * crc + _ONE_HALF) >> 16)
    g = y + ((-_FIX_0_34414 * cbc - _FIX_0_71414 * crc + _ONE_HALF) >> 16)
    b = y + ((_FIX_1_77200 * cbc + _ONE_HALF) >> 16)
    return tuple(v.clamp(0, maxval) for v in (r, g, b))


def rgb_to_ycbcr_i32(r, g, b, maxval: int = 255):
    """Full-range RGB → YCbCr, libjpeg jccolor.c fixed-point exact."""
    offset = ((maxval + 1) >> 1) << 16
    r, g, b = (v.to(torch.int32) for v in (r, g, b))
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b
         + _ONE_HALF) >> 16
    cb = (-_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
          + offset + _ONE_HALF - 1) >> 16
    cr = (_FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
          + offset + _ONE_HALF - 1) >> 16
    return y, cb, cr


def ycck_to_cmyk_i32(y, cb, cr, k):
    """YCCK → CMYK (libjpeg ycck_cmyk_convert): C/M/Y are 255 - RGB'."""
    r, g, b = ycbcr_to_rgb_i32(y, cb, cr)
    return 255 - r, 255 - g, 255 - b, k.to(torch.int32)


def cmyk_to_rgb_i32(c, m, y, k):
    """Adobe-inverted CMYK → RGB: R = C*K/255 rounded (the reference's
    convention)."""
    c, m, y, k = (v.to(torch.int32) for v in (c, m, y, k))
    return ((c * k + 127) // 255, (m * k + 127) // 255, (y * k + 127) // 255)
