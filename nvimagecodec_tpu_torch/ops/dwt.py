"""Discrete wavelet transforms for JPEG2000 (ITU-T T.800 Annex F) in torch.

The torch counterpart of nvimagecodec_tpu/ops/dwt.py (:44-312). Lifting is
strided adds over [..., H, W] tensors of any device, any leading axes: the
device pixel stage of the J2K decoder runs it on the card, the host path
(9/7 synthesis, the irreversible encoder's analysis, the rate allocator's
gains) on CPU tensors made with `torch.from_numpy`.

- 5/3 reversible: int32 adds and arithmetic shifts, bit-exact invertible.
- 9/7 irreversible: float lifting with the standard α β γ δ K constants, in
  the dtype it is given (float32 on the device stage, float64 on the host).
  Every lift is a separate multiply and a separate add, in the reference's
  order, so float64 results equal the reference's numpy path bit for bit.

Boundary handling is whole-sample symmetric extension; odd lengths and
subband parity follow the spec's interleaved formulation. Low-pass samples
live at even ABSOLUTE reference-grid positions (T.800 F.3.4's 1D_SR on
[i0, i1)), so every lift takes a `parity` bit: the parity of the segment's
absolute start coordinate. parity=1 (odd XOsiz/YOsiz/XTOsiz/YTOsiz origins)
puts high-pass samples at local-even indices and mirrors the
boundary-extension clamps between the two lifting steps; the multi-level
transforms derive per-level parities from an `origin` in tile-component
coordinates.

`idwt2d_rows_sharded` (reference :315-490) runs one image's synthesis with
its rows split over the "sp" devices of a mesh; the vertical lifting steps
read one row across each shard boundary, which is copied from the
neighbouring shard's device (the halo).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.trace import add_count

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _ax_slice(x, axis: int, start, stop, step=None):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _split_low_high(x, axis: int, parity: int = 0):
    """Deinterleave into (low, high) views: low samples sit at local indices
    ≡ parity (mod 2), the absolute even positions of a segment whose start
    has that parity."""
    return (_ax_slice(x, axis, parity, None, 2),
            _ax_slice(x, axis, 1 - parity, None, 2))


def _interleave(low, high, axis: int, n: int, parity: int = 0):
    """Merge low/high samples back into a length-n axis (low at local
    indices ≡ parity)."""
    shape = list(low.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=low.dtype, device=low.device)
    _ax_slice(out, axis, parity, None, 2).copy_(low)
    _ax_slice(out, axis, 1 - parity, None, 2).copy_(high)
    return out


def _shift_left_clamp(x, axis: int, out_len: int):
    """y[k] = x[min(k + 1, n - 1)] for k in [0, out_len)."""
    n = x.shape[axis]
    if out_len + 1 <= n:
        return _ax_slice(x, axis, 1, out_len + 1)
    # out_len == n: shift with edge clamp
    return torch.cat(
        [_ax_slice(x, axis, 1, None), _ax_slice(x, axis, n - 1, None)],
        dim=axis)


def _shift_right_clamp(x, axis: int, out_len: int):
    """y[k] = x[max(k - 1, 0)] for k in [0, out_len); out_len <= n + 1."""
    return torch.cat(
        [_ax_slice(x, axis, 0, 1), _ax_slice(x, axis, 0, out_len - 1)],
        dim=axis)


def _clamp_len(x, axis: int, out_len: int):
    """y[k] = x[min(k, n - 1)] for k in [0, out_len); out_len <= n + 1."""
    n = x.shape[axis]
    if out_len <= n:
        return _ax_slice(x, axis, 0, out_len)
    return torch.cat([x, _ax_slice(x, axis, n - 1, None)], dim=axis)


def _nbrs(parity: int, axis: int, nl: int, nh: int):
    """(h_nbrs, l_nbrs): the sums of the two neighbours a lifting step
    reads, for high samples from the low comb and for low samples from the
    high comb, with the boundary clamps of this parity."""
    if parity == 0:
        def h_nbrs(lo):  # abs-odd positions: low[k], low[k+1]
            return _ax_slice(lo, axis, 0, nh) + _shift_left_clamp(lo, axis, nh)

        def l_nbrs(hi):  # abs-even positions: H[k-1], H[k]
            return _shift_right_clamp(hi, axis, nl) + _clamp_len(hi, axis, nl)
    else:
        def h_nbrs(lo):  # abs i0+2k: low[k-1], low[k]
            return _shift_right_clamp(lo, axis, nh) + _clamp_len(lo, axis, nh)

        def l_nbrs(hi):  # abs i0+2k+1: H[k], H[k+1]
            return _ax_slice(hi, axis, 0, nl) + _shift_left_clamp(hi, axis, nl)
    return h_nbrs, l_nbrs


# -- 1D lifting on the interleaved signal ----------------------------------

def _fwd_lift_53(x, axis: int, parity: int = 0):
    """Analysis on one axis: returns (L, H) along that axis (integer).

    parity = absolute parity of the segment start (T.800 F.3.4): high
    coefficients sit at odd absolute positions, so parity=1 swaps which
    local comb is high and mirrors the boundary clamps between steps."""
    if x.shape[axis] == 1:
        empty = _ax_slice(x, axis, 0, 0)
        if parity:
            return empty, x * 2  # single odd-positioned sample (F.3.7)
        return x, empty
    low, high = _split_low_high(x, axis, parity)
    h_nbrs, l_nbrs = _nbrs(parity, axis, low.shape[axis], high.shape[axis])
    H = high - (h_nbrs(low) >> 1)
    L = low + ((l_nbrs(H) + 2) >> 2)
    return L, H


def _inv_lift_53(L, H, axis: int, n: int, parity: int = 0):
    """Synthesis on one axis from subbands (integer, exact inverse)."""
    nl, nh = L.shape[axis], H.shape[axis]
    if nh == 0:
        return L
    if nl == 0:
        return H >> 1  # single odd-positioned sample (F.3.7 inverse)
    h_nbrs, l_nbrs = _nbrs(parity, axis, nl, nh)
    low = L - ((l_nbrs(H) + 2) >> 2)
    high = H + (h_nbrs(low) >> 1)
    return _interleave(low, high, axis, n, parity)


def _fwd_lift_97(x, axis: int, parity: int = 0):
    if x.shape[axis] == 1:
        empty = _ax_slice(x, axis, 0, 0)
        if parity:
            return empty, x * 2.0  # single odd-positioned sample (F.4.8)
        return x, empty
    low, high = _split_low_high(x, axis, parity)
    h_nbrs, l_nbrs = _nbrs(parity, axis, low.shape[axis], high.shape[axis])
    high = high + ALPHA * h_nbrs(low)
    low = low + BETA * l_nbrs(high)
    high = high + GAMMA * h_nbrs(low)
    low = low + DELTA * l_nbrs(high)
    return low * (1.0 / K), high * K


def _inv_lift_97(L, H, axis: int, n: int, parity: int = 0):
    nl, nh = L.shape[axis], H.shape[axis]
    if nh == 0:
        return L
    if nl == 0:
        return H * 0.5  # single odd-positioned sample (F.4.8 inverse)
    h_nbrs, l_nbrs = _nbrs(parity, axis, nl, nh)
    low = L * K
    high = H * (1.0 / K)
    low = low - DELTA * l_nbrs(high)
    high = high - GAMMA * h_nbrs(low)
    low = low - BETA * l_nbrs(high)
    high = high - ALPHA * h_nbrs(low)
    return _interleave(low, high, axis, n, parity)


# -- 2D separable, single level --------------------------------------------

def dwt2d_level(x, reversible: bool, parity: Tuple[int, int] = (0, 0)):
    """One analysis level on [..., H, W] → (LL, HL, LH, HH).

    T.800 order: COLUMNS are filtered first, then rows (integer lifting
    does not commute, so the order is normative). HL = horizontally-highpass
    (X high, Y low), LH = vertically-highpass, matching the spec's subband
    naming. parity = (y0 & 1, x0 & 1) of the segment's absolute start.
    """
    f = _fwd_lift_53 if reversible else _fwd_lift_97
    Ly, Hy = f(x, -2, parity[0])
    LL, HL = f(Ly, -1, parity[1])
    LH, HH = f(Hy, -1, parity[1])
    return LL, HL, LH, HH


def idwt2d_level(LL, HL, LH, HH, out_h: int, out_w: int, reversible: bool,
                 parity: Tuple[int, int] = (0, 0)):
    """Inverse of dwt2d_level for a [..., out_h, out_w] target."""
    g = _inv_lift_53 if reversible else _inv_lift_97
    Ly = g(LL, HL, -1, out_w, parity[1])
    Hy = g(LH, HH, -1, out_w, parity[1])
    return g(Ly, Hy, -2, out_h, parity[0])


def subband_dims(h: int, w: int, levels: int,
                 origin: Tuple[int, int] = (0, 0)) -> List[Tuple[int, int]]:
    """[(h, w)] of the LL at each level 0..levels (level 0 = original).

    origin = (y0, x0) of the segment in tile-component coordinates; the
    level-s signal occupies [ceil(c0/2^s), ceil(c1/2^s)) on each axis
    (T.800 B.5), which differs from plain halving when the origin is odd.
    """
    y0, x0 = origin
    y1, x1 = y0 + h, x0 + w
    dims = []
    for s in range(levels + 1):
        d = 1 << s
        dims.append((-(-y1 // d) - (-(-y0 // d)),
                     -(-x1 // d) - (-(-x0 // d))))
    return dims


def _level_parity(origin: Tuple[int, int], s: int) -> Tuple[int, int]:
    """Parity of the level-s signal's start coordinates."""
    y0, x0 = origin
    d = 1 << s
    return ((-(-y0 // d)) & 1, (-(-x0 // d)) & 1)


def dwt2d(x, levels: int, reversible: bool,
          origin: Tuple[int, int] = (0, 0)):
    """Multi-level analysis. Returns (LL, [(HL, LH, HH) per level,
    finest-first]). origin = (y0, x0) tile-component coordinates."""
    bands = []
    cur = x
    for s in range(levels):
        LL, HL, LH, HH = dwt2d_level(cur, reversible,
                                     _level_parity(origin, s))
        bands.append((HL, LH, HH))
        cur = LL
    return cur, bands


def idwt2d(LL, bands, out_shape: Tuple[int, int], reversible: bool,
           origin: Tuple[int, int] = (0, 0)):
    """Inverse of dwt2d. bands finest-first; out_shape = (H, W)."""
    levels = len(bands)
    dims = subband_dims(out_shape[0], out_shape[1], levels, origin)
    cur = LL
    for lev in range(levels - 1, -1, -1):
        HL, LH, HH = bands[lev]
        h, w = dims[lev]
        cur = idwt2d_level(cur, HL, LH, HH, h, w, reversible,
                           _level_parity(origin, lev))
    return cur


# -- row-sharded synthesis with halo exchange over the mesh -----------------
#
# The vertical lifting steps read one neighbour row across the row-shard
# boundary, so a row-sharded inverse DWT needs a real halo exchange: each
# shard gets its neighbour's boundary row, sliced on the neighbour's device
# and copied to its own. Row shards are lists of tensors, one per device, in
# row order.

def to_device(t: torch.Tensor, dev) -> torch.Tensor:
    """`t` on `dev`, copied without waiting; a copy from the host to a CUDA
    device adds its bytes to the imgcodec.jpeg2k.h2d_bytes counter."""
    if t.device.type == "cpu" and torch.device(dev).type == "cuda":
        add_count("imgcodec.jpeg2k.h2d_bytes", t.numel() * t.element_size())
    return t.to(dev, non_blocking=True)


def _shift_right_halo(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """y[k] = x[k-1] globally across the row shards `xs` (whole-sample
    symmetric at the global top edge: the first shard repeats its own first
    row); each shard pulls the previous shard's last row."""
    out = []
    for k, x in enumerate(xs):
        head = (xs[k - 1][..., -1:, :].to(x.device, non_blocking=True)
                if k > 0 else x[..., :1, :])
        out.append(torch.cat([head, x[..., :-1, :]], dim=-2))
    return out


def _shift_left_halo(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """y[k] = x[k+1] globally across the row shards (clamped at the global
    bottom edge); each shard pulls the next shard's first row."""
    out = []
    for k, x in enumerate(xs):
        tail = (xs[k + 1][..., :1, :].to(x.device, non_blocking=True)
                if k + 1 < len(xs) else x[..., -1:, :])
        out.append(torch.cat([x[..., 1:, :], tail], dim=-2))
    return out


def _inv_lift_53_rows_sharded(Ls, Hs):
    """Vertical 5/3 synthesis on row shards: Ls / Hs hold each device's
    even / odd rows (equal counts: the global row count is even and the
    subbands split evenly). Returns the interleaved rows of each shard."""
    H_l = _shift_right_halo(Hs)
    evens = [L - ((hl + H + 2) >> 2) for L, hl, H in zip(Ls, H_l, Hs)]
    even_r = _shift_left_halo(evens)
    odds = [H + ((e + er) >> 1) for H, e, er in zip(Hs, evens, even_r)]
    return [_interleave(e, o, -2, 2 * e.shape[-2])
            for e, o in zip(evens, odds)]


def _inv_lift_97_rows_sharded(Ls, Hs):
    """The 9/7 counterpart: each lift is the unsharded one's multiply and
    add, in its order."""
    evens = [L * K for L in Ls]
    odds = [H * (1.0 / K) for H in Hs]
    sr = _shift_right_halo(odds)
    evens = [e - DELTA * (s + o) for e, s, o in zip(evens, sr, odds)]
    sl = _shift_left_halo(evens)
    odds = [o - GAMMA * (e + s) for o, e, s in zip(odds, evens, sl)]
    sr = _shift_right_halo(odds)
    evens = [e - BETA * (s + o) for e, s, o in zip(evens, sr, odds)]
    sl = _shift_left_halo(evens)
    odds = [o - ALPHA * (e + s) for o, e, s in zip(odds, evens, sl)]
    return [_interleave(e, o, -2, 2 * e.shape[-2])
            for e, o in zip(evens, odds)]


def idwt2d_level_rows_sharded(LLs, HLs, LHs, HHs, reversible: bool):
    """One synthesis level on row shards (lists, one tensor per device, in
    row order): the horizontal pass stays on each device, the vertical pass
    exchanges halo rows. The global subband heights must be equal (even
    image height) and split evenly over the shards."""
    g = _inv_lift_53 if reversible else _inv_lift_97
    Lys, Hys = [], []
    for LL, HL, LH, HH in zip(LLs, HLs, LHs, HHs):
        out_w = LL.shape[-1] + HL.shape[-1]
        Lys.append(g(LL, HL, -1, out_w))
        Hys.append(g(LH, HH, -1, out_w))
    if reversible:
        return _inv_lift_53_rows_sharded(Lys, Hys)
    return _inv_lift_97_rows_sharded(Lys, Hys)


def idwt2d_rows_sharded(LL, bands, out_shape: Tuple[int, int],
                        reversible: bool, mesh,
                        axis_name: str = "sp") -> List[torch.Tensor]:
    """Multi-level synthesis (origin (0, 0)) with rows split over the
    `axis_name` devices of `mesh` at every level whose subbands split
    evenly: those levels form a fine-side suffix and stay in their shards
    from one level to the next, so no level is gathered or recomputed.
    Coarser levels run replicated, on every device from its own copy of
    their subbands, and hand off with a local row slice. Only halo rows
    cross devices. An image whose rows do not split (odd height, finest
    subbands not a multiple of the shard count, no levels) takes the
    reference's replicated fallback: the whole synthesis on the axis's
    first device.

    LL and bands (finest-first) may lie on any device, the host included:
    each device receives only the rows it needs (`to_device`, which counts
    the bytes each copy from the host moves). Returns the image's row
    blocks in order, one per device ([..., H/sp, W] each), or one block on
    the first device for the fallback. Bit-exact vs idwt2d for 5/3."""
    devs = mesh.axis_devices(axis_name)
    sp = len(devs)
    levels = len(bands)
    H, W = out_shape
    dims = subband_dims(H, W, levels)
    if levels == 0 or dims[1][0] % sp or H % 2 or dims[0][0] != 2 * dims[1][0]:
        dev = devs[0]
        return [idwt2d(to_device(LL, dev), [
            tuple(to_device(b, dev) for b in lvl) for lvl in bands],
            out_shape, reversible)]

    def shardable(lev: int) -> bool:
        # its (equal-height) input subbands split evenly, its output is even
        h_out, sub_h = dims[lev][0], dims[lev + 1][0]
        return h_out % 2 == 0 and 2 * sub_h == h_out and sub_h % sp == 0

    # levels 0..m-1 (finest first) run sharded, m..levels-1 replicated
    m = 0
    while m < levels and shardable(m):
        m += 1

    def rows(t: torch.Tensor, k: int, dev) -> torch.Tensor:
        per = t.shape[-2] // sp
        return to_device(t.narrow(-2, k * per, per), dev)

    curs = []
    for k, dev in enumerate(devs):
        if m == levels:
            curs.append(rows(LL, k, dev))
            continue
        cur = to_device(LL, dev)
        for lev in range(levels - 1, m - 1, -1):
            h, w = dims[lev]
            cur = idwt2d_level(cur, *(to_device(b, dev) for b in bands[lev]),
                               h, w, reversible)
        curs.append(rows(cur, k, dev))  # replicated -> sharded handoff
    for lev in range(m - 1, -1, -1):
        HL, LH, HH = bands[lev]
        curs = idwt2d_level_rows_sharded(
            curs, [rows(HL, k, d) for k, d in enumerate(devs)],
            [rows(LH, k, d) for k, d in enumerate(devs)],
            [rows(HH, k, d) for k, d in enumerate(devs)], reversible)
    return curs
