"""Chroma upsampling on int32 tensors, integer-exact to libjpeg.

The torch counterpart of nvimagecodec_tpu/ops/resample.py (:18-101): fancy
(triangular) h2v1, h2v2 and h1v2 upsampling with replicated edges, and
nearest-neighbour replication for every other factor. Planes are
[..., H, W] with any leading dims. The libjpeg-biased downsampling
(:104-137) is here too; the host JPEG encoder runs it on CPU tensors.
"""
from __future__ import annotations

import torch


def _interleave(a, b, dim: int):
    """a0, b0, a1, b1, ... along `dim` (negative)."""
    stacked = torch.stack([a, b], dim=dim)  # new axis right after `dim`
    shape = list(a.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)


def _shift_prev(s, dim: int):
    """Neighbour before each sample along dim, edge replicated."""
    first = s.narrow(dim, 0, 1)
    return torch.cat([first, s.narrow(dim, 0, s.shape[dim] - 1)], dim=dim)


def _shift_next(s, dim: int):
    """Neighbour after each sample along dim, edge replicated."""
    n = s.shape[dim]
    return torch.cat([s.narrow(dim, 1, n - 1), s.narrow(dim, n - 1, 1)],
                     dim=dim)


def upsample_h2_fancy(s):
    """[..., W] → [..., 2W] (libjpeg h2v1_fancy_upsample)."""
    s = s.to(torch.int32)
    even = (3 * s + _shift_prev(s, -1) + 1) >> 2
    odd = (3 * s + _shift_next(s, -1) + 2) >> 2
    return _interleave(even, odd, -1)


def upsample_h2v2_fancy(s):
    """[..., H, W] → [..., 2H, 2W] (libjpeg h2v2_fancy_upsample, 9/3/3/1)."""
    s = s.to(torch.int32)
    cs = _interleave(3 * s + _shift_prev(s, -2), 3 * s + _shift_next(s, -2),
                     -2)
    even = (3 * cs + _shift_prev(cs, -1) + 8) >> 4
    odd = (3 * cs + _shift_next(cs, -1) + 7) >> 4
    return _interleave(even, odd, -1)


def upsample_v2_fancy(s):
    """[..., H, W] → [..., 2H, W] (libjpeg-turbo h1v2_fancy_upsample)."""
    s = s.to(torch.int32)
    even = (3 * s + _shift_prev(s, -2) + 1) >> 2
    odd = (3 * s + _shift_next(s, -2) + 2) >> 2
    return _interleave(even, odd, -2)


def upsample_replicate(s, vfactor: int, hfactor: int):
    """Nearest-neighbour expansion (libjpeg int_upsample)."""
    if hfactor > 1:
        s = s.repeat_interleave(hfactor, dim=-1)
    if vfactor > 1:
        s = s.repeat_interleave(vfactor, dim=-2)
    return s


def upsample_to(s, vfactor: int, hfactor: int, fancy: bool = True):
    """Dispatch by libjpeg jdsample.c's selection rules."""
    if vfactor == 1 and hfactor == 1:
        return s
    # libjpeg-turbo replicates when the downsampled width is <= 2
    narrow = s.shape[-1] <= 2
    if fancy and vfactor == 1 and hfactor == 2 and not narrow:
        return upsample_h2_fancy(s)
    if fancy and vfactor == 2 and hfactor == 2 and not narrow:
        return upsample_h2v2_fancy(s)
    if fancy and vfactor == 2 and hfactor == 1:
        return upsample_v2_fancy(s)
    return upsample_replicate(s, vfactor, hfactor)


def _alternating(n: int, device) -> torch.Tensor:
    """0, 1, 0, 1, ... of length n, int32."""
    return torch.arange(n, dtype=torch.int32, device=device) % 2


def downsample_h2v1(s):
    """[..., H, 2W] → [..., H, W] pair average with alternating bias 0,1
    (libjpeg h2v1_downsample)."""
    s = s.to(torch.int32)
    a = s[..., 0::2]
    b = s[..., 1::2]
    return (a + b + _alternating(a.shape[-1], s.device)) >> 1


def downsample_h2v2(s):
    """[..., 2H, 2W] → [..., H, W] 2x2 average with alternating bias 1,2
    (libjpeg h2v2_downsample)."""
    s = s.to(torch.int32)
    q = (s[..., 0::2, 0::2] + s[..., 0::2, 1::2]
         + s[..., 1::2, 0::2] + s[..., 1::2, 1::2])
    return (q + 1 + _alternating(q.shape[-1], s.device)) >> 2


def downsample_v2(s):
    """[..., 2H, W] → [..., H, W] vertical pair average (libjpeg h1v2)."""
    s = s.to(torch.int32)
    a = s[..., 0::2, :]
    b = s[..., 1::2, :]
    return (a + b + _alternating(a.shape[-1], s.device)) >> 1
