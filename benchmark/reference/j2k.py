"""A plain JPEG 2000 pixel stage in PyTorch on the CPU: the reversible 5/3
wavelet (ITU-T T.800 Annex F), the reversible colour transform (Annex G.2)
and the DC level shift (G.1), each forward and inverse.

It has no Tier-1 or Tier-2. For a lossless configuration the source pixels
are the exact answer of every correct decoder, so the benchmark judges the
decoded images against the pixels themselves; this module is what the
tests hold the program's pixel stage and its Tier-1 against (the subbands
of `analyse_image` are what a lossless codestream carries), and
`synthesise_image` computed in bfloat16 is the control of the cell's
`correct`. It imports nothing of the program.

Written from the standard's formulas: every 1-D transform keeps its
samples at their absolute coordinates [i0, i1), so the parity of the
tile-component origin at each level (T.800 B.5: ceil(origin / 2^s)) says
which samples are low-pass (even) and which high-pass (odd), and it reads
the samples outside [i0, i1) through whole-sample symmetric extension
(F.3.7, PSE). An integer dtype is exact; a float dtype computes the same
formulas with that dtype's rounding.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Bands = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _pse(i: int, i0: int, i1: int) -> int:
    """The index of [i0, i1) that index i reads under whole-sample
    symmetric extension (T.800 F-4)."""
    period = 2 * (i1 - i0 - 1)
    m = (i - i0) % period
    return i0 + min(m, period - m)


def _take(x: torch.Tensor, axis: int, idx: Sequence[int]) -> torch.Tensor:
    return x.index_select(axis % x.dim(),
                          torch.tensor(list(idx), dtype=torch.long))


def _floor_div(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="floor")


def _empty(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.narrow(axis, 0, 0)


def analyse_1d(x: torch.Tensor, axis: int, i0: int):
    """1D_SD with the 5/3 filter (F.4.8.2) along `axis` of samples at
    absolute positions [i0, i0 + n): (low, high), the samples of the even
    and of the odd positions."""
    n = x.shape[axis]
    i1 = i0 + n
    if n == 0:
        return x, x
    if n == 1:  # F.4.8.1: one sample is low at an even position
        return (x, _empty(x, axis)) if i0 % 2 == 0 else (_empty(x, axis),
                                                         2 * x)

    def at(positions):
        return _take(x, axis, [_pse(p, i0, i1) - i0 for p in positions])

    # Y(2n+1) = X(2n+1) - floor((X(2n) + X(2n+2)) / 2), for every odd
    # position an even position of [i0, i1) reads (F-9)
    odd = [p for p in range(i0 - 1, i1 + 1) if p % 2]
    y_odd = at(odd) - _floor_div(at([p - 1 for p in odd])
                                 + at([p + 1 for p in odd]), 2)
    where = {p: k for k, p in enumerate(odd)}
    # Y(2n) = X(2n) + floor((Y(2n-1) + Y(2n+1) + 2) / 4) (F-10)
    even = [p for p in range(i0, i1) if p % 2 == 0]
    low = at(even) + _floor_div(
        _take(y_odd, axis, [where[p - 1] for p in even])
        + _take(y_odd, axis, [where[p + 1] for p in even]) + 2, 4)
    high = _take(y_odd, axis, [where[p] for p in range(i0, i1) if p % 2])
    return low, high


def synthesise_1d(low: torch.Tensor, high: torch.Tensor, axis: int,
                  i0: int) -> torch.Tensor:
    """1D_SR with the 5/3 filter (F.3.8.2): the samples at absolute
    positions [i0, i0 + n) from the low (even) and high (odd) ones."""
    n = low.shape[axis] + high.shape[axis]
    i1 = i0 + n
    if n == 0:
        return low
    if n == 1:  # F.3.8.1
        return low if i0 % 2 == 0 else _floor_div(high, 2)
    # the interleaved signal Y at [i0, i1) (F.3.3, 1D_INTERLEAVE)
    order = [None] * n
    lo = hi = 0
    for p in range(i0, i1):
        if p % 2 == 0:
            order[p - i0], lo = ("L", lo), lo + 1
        else:
            order[p - i0], hi = ("H", hi), hi + 1
    both = torch.cat([low, high], dim=axis)
    nl = low.shape[axis]
    y = _take(both, axis, [k if s == "L" else nl + k for s, k in order])

    def at(positions):
        return _take(y, axis, [_pse(p, i0, i1) - i0 for p in positions])

    # X(2n) = Y(2n) - floor((Y(2n-1) + Y(2n+1) + 2) / 4), for every even
    # position an odd position of [i0, i1) reads (F-5)
    even = [p for p in range(i0 - 1, i1 + 1) if p % 2 == 0]
    x_even = at(even) - _floor_div(at([p - 1 for p in even])
                                   + at([p + 1 for p in even]) + 2, 4)
    where = {p: k for k, p in enumerate(even)}
    # X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2) (F-6)
    odd = [p for p in range(i0, i1) if p % 2]
    x_odd = at(odd) + _floor_div(
        _take(x_even, axis, [where[p - 1] for p in odd])
        + _take(x_even, axis, [where[p + 1] for p in odd]), 2)
    # back in order of position
    both = torch.cat([x_even, x_odd], dim=axis)
    at_odd = {p: len(even) + k for k, p in enumerate(odd)}
    return _take(both, axis, [where[p] if p % 2 == 0 else at_odd[p]
                              for p in range(i0, i1)])


def _level_origin(origin: Tuple[int, int], s: int) -> Tuple[int, int]:
    """(y0, x0) of the level-s signal: ceil(origin / 2^s) (T.800 B-15)."""
    d = 1 << s
    return -(-origin[0] // d), -(-origin[1] // d)


def analyse(x: torch.Tensor, levels: int, origin=(0, 0)):
    """The multi-level 2D_SD (F.4.2) of [..., H, W] samples whose first one
    sits at `origin` (y0, x0) of the tile-component: columns first, then
    rows. Returns (LL, [(HL, LH, HH)] finest first)."""
    bands: Bands = []
    for s in range(levels):
        y0, x0 = _level_origin(origin, s)
        low_y, high_y = analyse_1d(x, -2, y0)
        LL, HL = analyse_1d(low_y, -1, x0)
        LH, HH = analyse_1d(high_y, -1, x0)
        bands.append((HL, LH, HH))
        x = LL
    return x, bands


def synthesise(LL: torch.Tensor, bands: Bands, origin=(0, 0)):
    """The multi-level 2D_SR (F.3.2): rows first, then columns, coarsest
    level first. The inverse of `analyse`."""
    x = LL
    for s in range(len(bands) - 1, -1, -1):
        y0, x0 = _level_origin(origin, s)
        HL, LH, HH = bands[s]
        low_y = synthesise_1d(x, HL, -1, x0)
        high_y = synthesise_1d(LH, HH, -1, x0)
        x = synthesise_1d(low_y, high_y, -2, y0)
    return x


def rct(x: torch.Tensor) -> torch.Tensor:
    """Forward RCT (G-1) on [..., 3, H, W] R, G, B: Y, Cb (U), Cr (V)."""
    r, g, b = x.unbind(-3)
    return torch.stack([_floor_div(r + 2 * g + b, 4), b - g, r - g], dim=-3)


def inverse_rct(x: torch.Tensor) -> torch.Tensor:
    """Inverse RCT (G-2) on [..., 3, H, W] Y, Cb, Cr: R, G, B."""
    y, cb, cr = x.unbind(-3)
    g = y - _floor_div(cb + cr, 4)
    return torch.stack([cr + g, g, cb + g], dim=-3)


def analyse_image(pixels: np.ndarray, levels: int, depth: int = 8,
                  origin=(0, 0)):
    """What a lossless codestream of `pixels` ([H, W] or [H, W, C],
    unsigned) carries after Tier-1: the DC level shift (G.1), the RCT for
    three components, the 5/3 analysis. Returns (LL, [(HL, LH, HH)]
    finest first), int32 [C, h, w] each."""
    a = np.asarray(pixels)
    a = a[..., None] if a.ndim == 2 else a
    x = torch.from_numpy(a.astype(np.int32)).permute(2, 0, 1)
    x = x - (1 << (depth - 1))
    if x.shape[0] == 3:
        x = rct(x)
    return analyse(x, levels, origin)


def synthesise_image(LL: torch.Tensor, bands: Bands, depth: int = 8,
                     origin=(0, 0), dtype=torch.int32) -> np.ndarray:
    """The samples of `analyse_image`'s subbands, computed in `dtype`:
    the 5/3 synthesis, the inverse RCT for three components, the level
    shift back and the clamp to [0, 2^depth). Returns [H, W, C] uint8 (or
    uint16 above 8 bits)."""
    x = synthesise(LL.to(dtype), [tuple(b.to(dtype) for b in t)
                                  for t in bands], origin)
    if x.shape[0] == 3:
        x = inverse_rct(x)
    x = (x + (1 << (depth - 1))).clamp(0, (1 << depth) - 1)
    x = torch.round(x.double()).to(torch.int64).permute(1, 2, 0).numpy()
    return x.astype(np.uint8 if depth <= 8 else np.uint16)
