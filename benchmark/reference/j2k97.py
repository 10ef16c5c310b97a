"""A plain irreversible JPEG 2000 pixel stage in PyTorch on the CPU: the
dequantisation of ITU-T T.800 E.1.1.2 with r = 1/2, the 9/7 wavelet
(Annex F, F.3.8.2 and F.4.8.2 lifting), the irreversible colour transform
(Annex G.3) and the DC level shift (G.1), each forward and inverse.

It has no Tier-1 or Tier-2. The digital-cinema cell judges the program
against OpenJPEG's own decode of each codestream; this module is what the
tests hold the program's 9/7 stage and its dequantisation against, and
`synthesise_image` computed in bfloat16 on `analyse_image` of OpenJPEG's
pixels is the control of the cell's `correct`. It imports nothing of the
program, and TF32 is off.

Written from the standard's formulas, as reference/j2k.py's 5/3: every
1-D transform keeps its samples at their absolute coordinates [i0, i1),
so the parity of the tile-component origin at each level (T.800 B.5)
says which samples are low-pass (even) and which high-pass (odd); the
signal is extended once by whole-sample symmetric extension (F.3.7) four
samples each side, and the six lifting steps run over the extended
positions each step needs. Computed in float64 unless a dtype is given.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .j2k import _level_origin, _pse

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# T.800 Table F.4: the lifting parameters and the scaling factor
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001
# T.800 G-5 and G-6: the forward ICT (Y, Cb, Cr from R, G, B) and the
# inverse the standard gives (OpenJPEG's too)
ICT = ((0.299, 0.587, 0.114),
       (-0.16875, -0.33126, 0.5),
       (0.5, -0.41869, -0.08131))
ICT_INVERSE = ((1.0, 0.0, 1.402),
               (1.0, -0.34413, -0.71414),
               (1.0, 1.772, 0.0))
MARGIN = 4  # samples of symmetric extension each side

Bands = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def dequantize(q: torch.Tensor, planes_left: torch.Tensor,
               step: float, dtype=torch.float64) -> torch.Tensor:
    """T.800 E-6 with r = 1/2: each coefficient whose decoded bits give the
    signed integer q (its magnitude's bits below the decoded planes zero)
    and of which `planes_left` (Mb - N(u, v)) bit-planes were not decoded,
    at the middle of the interval they leave: sign(q) (|q| + 2^planes_left
    / 2) step; 0 where q is 0."""
    q = q.to(torch.int64)
    half = torch.pow(2.0, planes_left.to(torch.float64)) / 2
    mag = (q.abs().to(torch.float64) + half) * step
    return torch.where(q == 0, torch.zeros_like(mag),
                       torch.sign(q).to(torch.float64) * mag).to(dtype)


def _extended(x: torch.Tensor, axis: int, i0: int) -> Tuple[torch.Tensor,
                                                             int]:
    """x at the absolute positions [i0 - MARGIN, i1 + MARGIN) by
    whole-sample symmetric extension, and the position of its first."""
    n = x.shape[axis]
    i1 = i0 + n
    idx = [_pse(p, i0, i1) - i0 for p in range(i0 - MARGIN, i1 + MARGIN)]
    return x.index_select(axis % x.dim(), torch.tensor(idx)), i0 - MARGIN


def _lift(y: torch.Tensor, axis: int, first: int, parity: int, lo: int,
          hi: int, coef: float) -> torch.Tensor:
    """One lifting step on the extended signal y (position `first` at
    index 0): y(p) += coef (y(p - 1) + y(p + 1)) at every position p of
    [lo, hi) with p % 2 == parity."""
    pos = [p for p in range(lo, hi) if p % 2 == parity]
    at = lambda ps: torch.tensor([p - first for p in ps])
    d = axis % y.dim()
    upd = (y.index_select(d, at(pos))
           + coef * (y.index_select(d, at([p - 1 for p in pos]))
                     + y.index_select(d, at([p + 1 for p in pos]))))
    return y.index_copy(d, at(pos), upd)


def _scale(y: torch.Tensor, axis: int, first: int, parity: int,
           f: float) -> torch.Tensor:
    pos = [first + j for j in range(y.shape[axis])
           if (first + j) % 2 == parity]
    d = axis % y.dim()
    at = torch.tensor([p - first for p in pos])
    return y.index_copy(d, at, y.index_select(d, at) * f)


def _take(y: torch.Tensor, axis: int, first: int,
          positions: Sequence[int]) -> torch.Tensor:
    return y.index_select(axis % y.dim(),
                          torch.tensor([p - first for p in positions],
                                       dtype=torch.long))


def analyse_1d(x: torch.Tensor, axis: int, i0: int):
    """1D_SD with the 9/7 filter (F.4.8.2) along `axis` of the samples at
    absolute positions [i0, i0 + n): (low, high), the samples of the even
    and of the odd positions."""
    n = x.shape[axis]
    i1 = i0 + n
    if n == 0:
        return x, x
    if n == 1:  # F.4.8.1
        empty = x.narrow(axis, 0, 0)
        return (x, empty) if i0 % 2 == 0 else (empty, 2 * x)
    y, first = _extended(x, axis, i0)
    y = _lift(y, axis, first, 1, i0 - 3, i1 + 3, ALPHA)  # F-11 step 1
    y = _lift(y, axis, first, 0, i0 - 2, i1 + 2, BETA)   # step 2
    y = _lift(y, axis, first, 1, i0 - 1, i1 + 1, GAMMA)  # step 3
    y = _lift(y, axis, first, 0, i0, i1, DELTA)          # step 4
    y = _scale(y, axis, first, 1, K)                     # step 5
    y = _scale(y, axis, first, 0, 1.0 / K)               # step 6
    return (_take(y, axis, first, [p for p in range(i0, i1) if p % 2 == 0]),
            _take(y, axis, first, [p for p in range(i0, i1) if p % 2]))


def synthesise_1d(low: torch.Tensor, high: torch.Tensor, axis: int,
                  i0: int) -> torch.Tensor:
    """1D_SR with the 9/7 filter (F.3.8.2): the samples at absolute
    positions [i0, i0 + n) from the low (even) and high (odd) ones."""
    n = low.shape[axis] + high.shape[axis]
    i1 = i0 + n
    if n == 0:
        return low
    if n == 1:  # F.3.8.1
        return low if i0 % 2 == 0 else high / 2
    # the interleaved signal Y at [i0, i1) (1D_INTERLEAVE)
    nl = low.shape[axis]
    order, lo, hi = [], 0, 0
    for p in range(i0, i1):
        if p % 2 == 0:
            order.append(lo)
            lo += 1
        else:
            order.append(nl + hi)
            hi += 1
    y = torch.cat([low, high], dim=axis).index_select(
        axis % low.dim(), torch.tensor(order))
    y, first = _extended(y, axis, i0)
    y = _scale(y, axis, first, 0, K)                     # F-7 step 1
    y = _scale(y, axis, first, 1, 1.0 / K)               # step 2
    y = _lift(y, axis, first, 0, i0 - 3, i1 + 3, -DELTA)  # step 3
    y = _lift(y, axis, first, 1, i0 - 2, i1 + 2, -GAMMA)  # step 4
    y = _lift(y, axis, first, 0, i0 - 1, i1 + 1, -BETA)   # step 5
    y = _lift(y, axis, first, 1, i0, i1, -ALPHA)          # step 6
    return _take(y, axis, first, range(i0, i1))


def analyse(x: torch.Tensor, levels: int, origin=(0, 0)):
    """The multi-level 2D_SD (F.4.2) of [..., H, W] samples whose first one
    sits at `origin` (y0, x0): columns first, then rows. Returns (LL,
    [(HL, LH, HH)] finest first)."""
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


def ict(x: torch.Tensor) -> torch.Tensor:
    """Forward ICT (G-5) on [..., 3, H, W] R, G, B: Y, Cb, Cr."""
    m = torch.tensor(ICT, dtype=x.dtype)
    return torch.einsum("ij,...jhw->...ihw", m, x)


def inverse_ict(x: torch.Tensor) -> torch.Tensor:
    """Inverse ICT (G-6) on [..., 3, H, W] Y, Cb, Cr: R, G, B."""
    m = torch.tensor(ICT_INVERSE, dtype=x.dtype)
    return torch.einsum("ij,...jhw->...ihw", m, x)


def analyse_image(pixels: np.ndarray, levels: int, depth: int,
                  origin=(0, 0)):
    """What an irreversible codestream of `pixels` ([H, W, 3] unsigned)
    carries before quantisation: the DC level shift (G.1), the ICT, the
    9/7 analysis, in float64. Returns (LL, [(HL, LH, HH)] finest first),
    [3, h, w] each."""
    x = torch.from_numpy(np.asarray(pixels).astype(np.float64)).permute(
        2, 0, 1)
    return analyse(ict(x - (1 << (depth - 1))), levels, origin)


def synthesise_image(LL: torch.Tensor, bands: Bands, depth: int,
                     origin=(0, 0), dtype=torch.float64) -> np.ndarray:
    """The samples of 9/7 subbands computed in `dtype`: the synthesis, the
    inverse ICT, the level shift back, rounding and the clamp to
    [0, 2^depth). Returns [H, W, 3] uint8 (or uint16 above 8 bits)."""
    x = synthesise(LL.to(dtype), [tuple(b.to(dtype) for b in t)
                                  for t in bands], origin)
    x = inverse_ict(x) + (1 << (depth - 1))
    x = torch.round(x.double()).clamp(0, (1 << depth) - 1)
    x = x.to(torch.int64).permute(1, 2, 0).numpy()
    return x.astype(np.uint8 if depth <= 8 else np.uint16)
