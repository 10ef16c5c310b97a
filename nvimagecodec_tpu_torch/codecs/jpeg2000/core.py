"""JPEG2000 encode/decode pipelines.

The port of nvimagecodec_tpu/codecs/jpeg2000/core.py. Hybrid split mirroring
the JPEG codec: Tier-2 runs on the host. The bit-serial EBCOT Tier-1 runs on
the host (native C++, fanned over a thread pool per codeblock — the analog
of the reference's per-tile resource pool, extensions/nvjpeg2k/
cuda_decoder.cpp:601-640), or, for the reversible part-1 tiles of the device
stage on a CUDA device (`tier1_on_device`), on the card: the host builds a
table of the code-blocks (ops/j2k_t1.py) that goes up with the codestream,
and a kernel decodes every block into the subbands there, as nvjpeg2k does
in the reference. The inverse DWT, inverse MCT and level shift run either on
the host (native 5/3 synthesis and epilogue, torch lifting on CPU tensors
for 9/7: `device=None`) or as torch ops on the caller's device
(`device=torch.device(...)`), where every subband of a tile, or of all tiles
of a uniform grid, is in one buffer: decoded on the card, or uploaded from
one pinned buffer in one copy. The encoder is host code throughout.

All part-1 code-block styles are handled natively (see native/j2k_t1.cpp).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core.trace import add_count, charge_ns, collecting, span
from ...ops import dwt as dwt_ops
from ...ops import j2k_t1
from ...parallel.tiles import idwt_tiles_sharded
from .codestream import (
    COD,
    EOC,
    QCD,
    SIZ,
    SOC,
    SOD,
    SOT,
    Band,
    CodingParams,
    Resolution,
    SizInfo,
    build_resolutions,
    cblk_grid,
    cblk_grid_precinct,
    ceil_div,
    iter_tile_parts,
    parse_main_header,
    parse_poc_body,
    precinct_count,
    precinct_rect,
    progression_iter,
    unwrap_jp2,
    wrap_jp2,
    write_coc,
    write_cod,
    write_qcc,
    write_qcd,
    write_siz,
)
from .codestream import write_cap
from .codestream import RGN
from .codestream import _seg as _marker_seg
from ...native import lib as _native_lib
from .t1_bridge import (EncodeBatch, decode_rows_into, fdwt53, ht_decode,
                        ht_encode, idwt53, t1_decode, t1_encode)
from .t2 import (PacketDecoder, PacketEncoder, TileLayout, plan_layers,
                 plan_layers_ht, plan_layers_seg, seg_pass_groups,
                 tile_layout)

_PROG_LRCP, _PROG_RLCP, _PROG_RPCL, _PROG_PCRL, _PROG_CPRL = range(5)
_PROG_NAMES = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _band_order(cp: CodingParams) -> List[Tuple[int, int]]:
    """QCD band order: LL, then (HL, LH, HH) per resolution 1..levels —
    (resolution, band_index_within_resolution)."""
    order = [(0, 0)]
    for r in range(1, cp.levels + 1):
        for bi in range(3):
            order.append((r, bi))
    return order


# ------------------------------------------- ops/dwt on host numpy arrays
def _as_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_dwt2d(x: np.ndarray, levels: int, reversible: bool, origin):
    """ops/dwt.dwt2d on a numpy array (dtype kept), numpy out."""
    LL, bands = dwt_ops.dwt2d(_as_tensor(x), levels, reversible, origin)
    return LL.numpy(), [tuple(b.numpy() for b in lvl) for lvl in bands]


def _host_idwt2d(LL: np.ndarray, bands, out_shape, reversible: bool,
                 origin=(0, 0)) -> np.ndarray:
    """ops/dwt.idwt2d on numpy arrays (dtype kept), numpy out."""
    return dwt_ops.idwt2d(
        _as_tensor(LL), [tuple(_as_tensor(b) for b in lvl) for lvl in bands],
        out_shape, reversible, origin).numpy()


# ------------------------------------------------------------- quantization
def _synth_gain(band: Band) -> float:
    """Approximate L2 synthesis gain of a 9/7 band (level & orientation)."""
    base = 2.0 ** (band.lev - 1)
    orient = {0: 2.0, 1: 1.0, 2: 1.0, 3: 0.5}[band.btype]
    return base * orient


_MSE_GAIN_CACHE: Dict[Tuple[int, int, int], float] = {}


def _band_mse_gain(levels: int, r: int, bi: int) -> float:
    """Squared L2 synthesis gain of one 9/7 coefficient of band (r, bi):
    pixel-domain energy of a unit coefficient impulse (numeric estimate,
    cached per levels config). Lets the rate allocator convert per-band
    quantization error into decoded-pixel MSE without re-encoding — the
    single-pass analog of nvjpeg2k's native rate allocator
    (reference: extensions/nvjpeg2k/cuda_encoder.cpp target_psnr)."""
    key = (levels, r, bi)
    g = _MSE_GAIN_CACHE.get(key)
    if g is not None:
        return g
    N = 1 << max(6, levels + 4)
    res = build_resolutions(0, 0, N, N, levels)
    LL = np.zeros((res[0].bands[0].h, res[0].bands[0].w))
    bands_f = []
    for lev in range(1, levels + 1):
        rr = levels - lev + 1
        bs = res[rr].bands
        bands_f.append(tuple(np.zeros((b.h, b.w)) for b in bs))
    if r == 0:
        LL[LL.shape[0] // 2, LL.shape[1] // 2] = 1.0
    else:
        tgt = bands_f[levels - r][bi]
        tgt[tgt.shape[0] // 2, tgt.shape[1] // 2] = 1.0
    px = _host_idwt2d(LL, bands_f, (N, N), False)
    g = float(np.sum(px * px))
    _MSE_GAIN_CACHE[key] = g
    return g


def _rate_control_base_delta(coeffs, border, resolutions0, levels: int,
                             depth: int, mct: bool, C: int,
                             target_psnr: float, npix: int) -> float:
    """Choose the base quantizer step so the ESTIMATED decoded PSNR hits
    target_psnr — one DWT-domain bisection instead of decode-measure-
    re-encode loops. coeffs: [(c, (r, bi), float array)] over all tiles.
    The estimate models the decoder's midpoint reconstruction
    ((q + 0.5)Δ) per nonzero coefficient and propagates band error to
    pixel MSE via the numeric synthesis gains (independent-error model;
    inverse-ICT row norms weight the channels)."""
    peak = float((1 << depth) - 1)
    target_mse = peak * peak / (10.0 ** (target_psnr / 10.0))
    if mct and C == 3:
        # inverse-ICT row norms: one unit of Y error reaches all three RGB
        # channels (3x), Cb reaches G+B, Cr reaches R+G; MSE is then taken
        # over all H*W*C output samples
        wc = (3.0,
              0.344136 ** 2 + 1.772 ** 2,
              1.402 ** 2 + 0.714136 ** 2)
    else:
        wc = (1.0,) * C
    gains = {(r, bi): _band_mse_gain(levels, r, bi) for (r, bi) in border}
    sg = {(r, bi): _synth_gain(resolutions0[r].bands[bi])
          for (r, bi) in border}

    def est_mse(s: float) -> float:
        tot = 0.0
        for c, (r, bi), arr in coeffs:
            d = max(1e-9, s / sg[(r, bi)])
            a = np.abs(arr).ravel()
            q = np.floor(a / d)
            err = np.where(q > 0.0, a - (q + 0.5) * d, a)
            tot += float(np.dot(err, err)) * gains[(r, bi)] * wc[c]
        return tot / max(1, npix)

    lo, hi = peak * 1e-5, peak * 4.0
    if est_mse(lo) >= target_mse:
        return lo
    if est_mse(hi) <= target_mse:
        return hi
    for _ in range(20):
        mid = math.sqrt(lo * hi)
        if est_mse(mid) > target_mse:
            hi = mid
        else:
            lo = mid
    return math.sqrt(lo * hi)


def _delta_to_eps_mu(delta: float, rb: int) -> Tuple[int, int]:
    """Δ = 2^(rb - eps) * (1 + mu / 2^11)  →  (eps, mu)."""
    e = math.floor(math.log2(delta))
    eps = rb - e
    mu = int(round((delta / (2.0 ** e) - 1.0) * 2048))
    if mu >= 2048:
        mu = 0
        eps -= 1
    eps = max(0, min(31, eps))
    return eps, max(0, min(2047, mu))


def _eps_mu_to_delta(eps: int, mu: int, rb: int) -> float:
    return (2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)


def quality_to_base_delta(quality: float, depth: int) -> float:
    """Map quality 1-100 to a base quantizer step (pixel-value units) for
    the finest bands; 95 ≈ half an 8-bit code value (near-lossless), and Δ
    roughly doubles every -10 quality. Scaled for higher bit depths."""
    quality = min(100.0, max(1.0, quality))
    return 0.5 * (2.0 ** ((95.0 - quality) / 10.0)) * (1 << (depth - 8))


def _ht_encode_or_skip(sub: np.ndarray, npasses: int = 1):
    """All-zero HT blocks stay not-included (like the EBCOT path) instead
    of paying a 3-byte cleanup segment."""
    if not sub.any():
        return (b"", b"", 1, 0)
    return ht_encode(sub, npasses)


# ------------------------------------------------------------------ encode
def encode_j2k(
    img: np.ndarray,
    reversible: bool = True,
    levels: int = 5,
    quality: float = 100.0,
    tile_size: Optional[int] = None,
    cblk: Tuple[int, int] = (64, 64),
    stream_type: str = "jp2",
    num_threads: int = 0,
    num_layers: int = 1,
    prog_order: str = "LRCP",
    precincts=None,
    ht: bool = False,
    per_comp=None,
    target_psnr: float = None,
    sub=None,
    size=None,
    colorspace: str = None,
    grid_offset: Tuple[int, int] = (0, 0),
    roi: Optional[Tuple[int, int, int, int]] = None,
    mode_switches: int = 0,
) -> bytes:
    """Encode [H, W] or [H, W, C] u8/u16 → JP2/J2K bytes.

    num_layers: quality layers — each code-block's coding passes split across
    layers with the codeword segment bytes divided at the matching points
    (reference: nvjpeg2k num_layers, extensions/nvjpeg2k/cuda_encoder.cpp:272-474).
    prog_order: any of LRCP/RLCP/RPCL/PCRL/CPRL (honest precinct-position
    iteration per T.800 B.12, not a collapse).
    precincts: None, a single (PPx, PPy) exponent pair for all resolutions,
    or a per-resolution list (T.800 A-21; PPx/PPy >= 1 above resolution 0).
    ht: use the HT (T.814 / HTJ2K) block coder instead of EBCOT — the
    reference's "High Throughput JPEG2000" (README.md:38, decoded by
    nvjpeg2k in extensions/nvjpeg2k/cuda_decoder.cpp:178). Emits the CAP
    marker (Pcap bit 15), Rsiz 0x4000, SPcod style 0x40; lossless for
    reversible (single cleanup pass carries all magnitude planes).
    ht=3 emits all three HT passes (cleanup at p=1 + SigProp + MagRef) —
    near-lossless (samples whose magnitude lies entirely below plane 1 and
    that SigProp cannot reach are dropped, an inherent T.814 property);
    used to exercise decoder conformance on refinement passes.
    per_comp: {comp: {"cblk": (w, h), "eps_shift": int}} — emit COC (code
    block size) / QCC (quant exponent shift, reversible only) markers for
    those components (T.800 A.6.2/A.6.5; the reference parses these in
    src/parsers/jpeg2k.cpp:280-356 and nvjpeg2k decodes them natively).
    target_psnr: single-pass rate control (irreversible only) — the base
    quantizer step is chosen by a DWT-domain distortion estimate so the
    decoded PSNR hits the target with ONE T1 encode, like nvjpeg2k's
    native rate allocator; overrides `quality`.

    Signed input (i8/i16) encodes with the SIZ sign bit and no DC level
    shift (T.800 G.1). Subsampled components (T.800 A.5.1, e.g. planar
    YUV 420): pass `img` as a LIST of per-component planes plus
    sub=[(dx, dy)] per component (plane c sized ceil(H/dy) x ceil(W/dx))
    and, when the full grid is not dx*plane dims (odd sizes), size=(H, W).
    MCT is disabled for planar input (the planes are already in their
    target colorspace)."""
    planes_in = None
    if isinstance(img, (list, tuple)):
        planes_in = [np.asarray(p) for p in img]
        C = len(planes_in)
        sub = [(int(dx), int(dy)) for dx, dy in
               (sub or [(1, 1)] * C)]
        if size is not None:
            H, W = int(size[0]), int(size[1])
        else:
            H = planes_in[0].shape[0] * sub[0][1]
            W = planes_in[0].shape[1] * sub[0][0]
        for c, p in enumerate(planes_in):
            need = (ceil_div(H, sub[c][1]), ceil_div(W, sub[c][0]))
            if p.shape != need:
                raise ValueError(f"J2K: plane {c} is {p.shape}, want {need}")
        dtype0 = planes_in[0].dtype
    else:
        if img.ndim == 2:
            img = img[:, :, None]
        H, W, C = img.shape
        sub = [(1, 1)] * C
        dtype0 = img.dtype
    signed = dtype0 in (np.int8, np.int16)
    depth = 16 if dtype0 in (np.uint16, np.int16) else 8
    min_dim = min(min(ceil_div(H, dy), ceil_div(W, dx)) for dx, dy in sub)
    levels = max(0, min(levels, max(1, int(math.log2(max(1, min_dim)))) - 1))
    subsampled = any(s != (1, 1) for s in sub)
    if subsampled and target_psnr is not None:
        raise ValueError("J2K: target_psnr with subsampling not supported")
    if isinstance(precincts, tuple):
        precincts = [precincts] * (levels + 1)
    if precincts is not None:
        precincts = list(precincts)
        if len(precincts) < levels + 1:
            precincts = precincts + [precincts[-1]] * (levels + 1 - len(precincts))
        for r, (px, py) in enumerate(precincts):
            if not (0 <= px <= 15 and 0 <= py <= 15):
                raise ValueError("precinct exponents must be in [0, 15]")
            if r > 0 and (px < 1 or py < 1):
                raise ValueError("PPx/PPy must be >= 1 above resolution 0")

    # grid_offset = (XOsiz, YOsiz): pixels live on reference-grid
    # [ox, ox+W) x [oy, oy+H); the tile grid stays anchored at (0, 0)
    # (T.800 B.3 requires XTOsiz <= XOsiz), so offset images naturally get
    # odd-origin interior tiles — the DWT takes per-level parity from the
    # absolute tile-component origins (ops/dwt.py).
    ox, oy = grid_offset
    if (ox < 0 or oy < 0) or (ox or oy) and subsampled:
        raise ValueError("grid_offset must be >= 0 and is unsupported with "
                         "subsampled components")
    siz = SizInfo(
        width=ox + W, height=oy + H, x0=ox, y0=oy,
        tile_w=tile_size or ox + W, tile_h=tile_size or oy + H,
        tx0=0, ty0=0, ncomp=C,
        depth=[depth] * C, signed=[signed] * C,
        sub_x=[s[0] for s in sub], sub_y=[s[1] for s in sub],
    )
    if tile_size and subsampled and any(
            tile_size % (2 * s) for s in siz.sub_x + siz.sub_y):
        raise ValueError("J2K: tile_size must be a multiple of 2*subsampling")

    cp = CodingParams(
        levels=levels,
        reversible=reversible,
        mct=(C == 3 and planes_in is None),
        cblk_w=cblk[0],
        cblk_h=cblk[1],
        prog_order=_PROG_NAMES.get(str(prog_order).upper(), 0)
        if isinstance(prog_order, str) else int(prog_order),
        num_layers=max(1, int(num_layers)),
        cblk_style=(0x40 if ht else (mode_switches & 0x2F)),
        precincts=precincts,
        qcd_style=0 if reversible else 2,
        guard_bits=2,
    )

    for c, spec in (per_comp or {}).items():
        o = dataclasses.replace(
            cp, precincts=list(precincts) if precincts else None, band_q=[],
            comp_overrides={})
        if "cblk" in spec:
            o.cblk_w, o.cblk_h = spec["cblk"]
        cp.comp_overrides[int(c)] = o

    border = _band_order(cp)
    base_delta = quality_to_base_delta(quality, depth)
    rate_ctl = target_psnr is not None and not reversible

    # ---- phase 1: DWT + quantize every tile, track per-band magnitude
    # maxima so Mb (eps + guard - 1) provably bounds every code-block's
    # bitplane count (a zero-bitplane clamp would corrupt the stream).
    # With target_psnr the quantization is deferred: the rate allocator
    # needs the unquantized coefficients of every tile first.
    deltas: Dict[Tuple[int, int], float] = {}
    eps_mu: Dict[Tuple[int, int], Tuple[int, int]] = {}
    ref_res = build_resolutions(0, 0, siz.tile_w, siz.tile_h, levels)

    def _set_deltas(bd: float) -> None:
        for (r, bi) in border:
            band = ref_res[r].bands[bi]
            rb = depth + band.gain
            delta = max(1e-9, bd / _synth_gain(band))
            eps, mu = _delta_to_eps_mu(delta, rb)
            eps_mu[(r, bi)] = (eps, mu)
            deltas[(r, bi)] = _eps_mu_to_delta(eps, mu, rb)

    if not reversible and not rate_ctl:
        _set_deltas(base_delta)

    ntiles = siz.tiles_x * siz.tiles_y
    tile_banddata = []  # per tile: ({c: [Resolution]}, {(c,r,bi): array})
    max_nbps: Dict[Tuple[int, int], int] = {k: 0 for k in border}
    shift0 = 0 if signed else 1 << (depth - 1)
    for t in range(ntiles):
        tx0, ty0, tx1, ty1 = siz.tile_rect(t)
        if planes_in is None:
            tile_img = img[ty0 - oy:ty1 - oy, tx0 - ox:tx1 - ox].astype(
                np.int32)
            planes = [tile_img[:, :, c] - shift0 for c in range(C)]
        else:
            planes = []
            for c in range(C):
                dx, dy = sub[c]
                planes.append(planes_in[c][
                    ceil_div(ty0, dy):ceil_div(ty1, dy),
                    ceil_div(tx0, dx):ceil_div(tx1, dx)].astype(np.int32)
                    - shift0)
        if cp.mct:
            r_, g_, b_ = planes
            if reversible:  # RCT (T.800 G.2)
                y = (r_ + 2 * g_ + b_) >> 2
                cb = b_ - g_
                cr = r_ - g_
                planes = [y, cb, cr]
            else:  # ICT
                rf, gf, bf = (p.astype(np.float64) for p in planes)
                y = 0.299 * rf + 0.587 * gf + 0.114 * bf
                cb = -0.168736 * rf - 0.331264 * gf + 0.5 * bf
                cr = 0.5 * rf - 0.418688 * gf - 0.081312 * bf
                planes = [y, cb, cr]
        if not reversible:
            planes = [p.astype(np.float64) for p in planes]

        res_by_c = {
            c: build_resolutions(ceil_div(tx0, sub[c][0]),
                                 ceil_div(ty0, sub[c][1]),
                                 ceil_div(tx1, sub[c][0]),
                                 ceil_div(ty1, sub[c][1]), levels)
            for c in range(C)
        }
        arrays: Dict[Tuple[int, int, int], np.ndarray] = {}
        for c in range(C):
            corigin = (ceil_div(ty0, sub[c][1]), ceil_div(tx0, sub[c][0]))
            if reversible:
                # native forward 5/3 (native/j2k_idwt.cpp tic_fdwt53),
                # bit-identical to dwt_ops.dwt2d
                LL, bands_f = fdwt53(
                    np.ascontiguousarray(planes[c], np.int32), levels,
                    corigin)
            else:
                LL, bands_f = _host_dwt2d(
                    planes[c], levels, reversible, corigin)
            band_arrays: Dict[Tuple[int, int], np.ndarray] = {(0, 0): LL}
            for r in range(1, levels + 1):
                lev = levels - r + 1
                HL, LH, HH = bands_f[lev - 1]
                band_arrays[(r, 0)] = HL
                band_arrays[(r, 1)] = LH
                band_arrays[(r, 2)] = HH
            for (r, bi) in border:
                band = res_by_c[c][r].bands[bi]
                arr = band_arrays[(r, bi)]
                assert arr.shape == (band.h, band.w), (
                    arr.shape, band.h, band.w, r, bi)
                if rate_ctl:
                    arrays[(c, r, bi)] = arr  # float; quantized below
                    continue
                if not reversible:
                    d = deltas[(r, bi)]
                    arr = (np.sign(arr) * np.floor(np.abs(arr) / d)).astype(
                        np.int32
                    )
                else:
                    # fdwt53 already yields int32 — avoid a full-band copy
                    arr = np.asarray(arr, np.int32)
                arrays[(c, r, bi)] = arr
                # max |v| without materializing a |band| temp
                m = (max(int(arr.max()), -int(arr.min()))
                     if arr.size else 0)
                max_nbps[(r, bi)] = max(max_nbps[(r, bi)], m.bit_length())
        tile_banddata.append((res_by_c, arrays))

    if rate_ctl:
        coeffs = [(c, (r, bi), arr)
                  for (_res, arrays) in tile_banddata
                  for (c, r, bi), arr in arrays.items()]
        base_delta = _rate_control_base_delta(
            coeffs, border, ref_res, levels, depth, cp.mct and C == 3, C,
            float(target_psnr), H * W * C)
        _set_deltas(base_delta)
        for _res, arrays in tile_banddata:
            for (c, r, bi), arr in list(arrays.items()):
                d = deltas[(r, bi)]
                q = (np.sign(arr) * np.floor(np.abs(arr) / d)).astype(np.int32)
                arrays[(c, r, bi)] = q
                m = int(np.abs(q).max()) if q.size else 0
                max_nbps[(r, bi)] = max(max_nbps[(r, bi)], m.bit_length())

    # ---- ROI maxshift (T.800 H.1): scale ROI coefficients up by SPrgn so
    # their bitplanes sit strictly above every background plane; eps stays
    # at the background dynamic range and decoders add SPrgn back
    if roi is not None:
        if ntiles != 1 or rate_ctl or per_comp:
            raise ValueError("roi: single-tile, non-rate-controlled only")
        # s must exceed every background bitplane by ONE: decoders detect
        # ROI indices at magnitude >= 2^(s-1) (openjpeg's threshold; any
        # background coefficient reaches at most 2^max_nbps - 1)
        s_roi = max(max_nbps.values()) + 1 + (1 if ht else 0)
        ry0, rx0, ry1, rx1 = roi
        margin = 3 if reversible else 5  # 5/3 vs 9/7 synthesis support
        res_by_c0, arrays0 = tile_banddata[0]
        for (c, r, bi), arr in arrays0.items():
            band = res_by_c0[c][r].bands[bi]
            scale = levels - r + 1 if r > 0 else levels
            by0 = max(0, (ry0 >> scale) - margin - band.y0)
            bx0 = max(0, (rx0 >> scale) - margin - band.x0)
            by1 = min(band.h,
                      -(-ry1 // (1 << scale)) + margin - band.y0)
            bx1 = min(band.w,
                      -(-rx1 // (1 << scale)) + margin - band.x0)
            if by0 >= by1 or bx0 >= bx1:
                continue
            if max_nbps[(r, bi)] + s_roi > 30:
                raise ValueError("roi: shifted bitplanes exceed int32")
            arr[by0:by1, bx0:bx1] = arr[by0:by1, bx0:bx1] << s_roi
        cp.rgn = {c: s_roi for c in range(C)}

    # ---- choose QCD so Mb >= nbps everywhere (HT: Mb >= Umax = nbps + 1,
    # the magnitude-exponent bound of the T.814 cleanup pass)
    band_q: List[Tuple[int, int]] = []
    for (r, bi) in border:
        band = ref_res[r].bands[bi]
        rb = depth + band.gain
        need = max_nbps[(r, bi)] + (1 if ht else 0)
        if reversible:
            eps = max(rb, need - cp.guard_bits + 1)
            band_q.append((min(31, eps), 0))
        else:
            eps, mu = eps_mu[(r, bi)]
            if eps + cp.guard_bits - 1 < need:
                cp.guard_bits = min(7, need - eps + 1)
            band_q.append((eps, mu))
    cp.band_q = band_q
    for c, o in cp.comp_overrides.items():
        shift = int((per_comp or {}).get(c, {}).get("eps_shift", 0))
        if shift and not reversible:
            raise ValueError("eps_shift only supported for reversible")
        o.band_q = [(min(31, e + max(0, shift)), m) for (e, m) in band_q]
        o.qcd_style = cp.qcd_style
        o.guard_bits = cp.guard_bits

    # ---- phase 2: T1 encode + packet assembly (precinct- and layer-aware)
    tiles = []
    for t in range(ntiles):
        res_by_c, arrays = tile_banddata[t]
        penc = PacketEncoder(cp, res_by_c, C)
        tx0, ty0, _tx1, _ty1 = siz.tile_rect(t)
        ebatch = EncodeBatch(bool(ht), 3 if ht == 3 else 1)
        for c in range(C):
            for res in res_by_c[c]:
                r = res.r
                ppx, ppy = cp.pp(r)
                npx, npy = precinct_count(res, ppx, ppy)
                for p in range(npx * npy):
                    prect, _ = precinct_rect(res, ppx, ppy, p)
                    for bi, band in enumerate(res.bands):
                        arr = arrays[(c, r, bi)]
                        ccp = cp.for_comp(c)
                        _, _, blocks = cblk_grid_precinct(
                            band, r, ppx, ppy, prect, ccp.cblk_w, ccp.cblk_h
                        )
                        # RGN: decoders that bound zbps by the nominal Mb
                        # (openjpeg) need background blocks coded with at
                        # least SPrgn+1 planes so zbps stays below Mb
                        mbp = ((cp.rgn.get(c, 0) + 1)
                               if (cp.rgn and not ht) else 0)
                        sty = 0 if ht else (ccp.cblk_style & 0x2F)
                        for k, (bx0, by0, bx1, by1) in enumerate(blocks):
                            blk = arr[by0 - band.y0 : by1 - band.y0,
                                      bx0 - band.x0 : bx1 - band.x0]
                            ebatch.add((c, r, p, bi, k), blk, band.btype,
                                       min_bps=mbp, style=sty)
        results: Dict[Tuple[int, int, int, int], List] = {}
        for (c, r, p, bi, k), rv in ebatch.run(num_threads):
            results.setdefault((c, r, p, bi), []).append((k, rv))

        for (c, r, p, bi), rows in results.items():
            ccp = cp.for_comp(c)
            eps = ccp.band_q[border.index((r, bi))][0]
            mb = (eps + ccp.guard_bits - 1
                  + (cp.rgn.get(c, 0) if cp.rgn else 0))
            plan = []
            if ht:
                for k, (cup, ref, B, umax) in sorted(rows):
                    assert umax + B - 1 <= mb, (umax, B, mb, r, bi)
                    npasses = 1 if not ref else 3
                    plan.append(plan_layers_ht(cup, ref, npasses,
                                               mb - B if cup else 0,
                                               cp.num_layers))
            elif ccp.cblk_style & 0x05:
                # TERMALL/BYPASS: one terminated codeword segment per
                # native seg_end; pass counts per segment follow the
                # termination rule (must match the T2 reader's grouping)
                for k, (seg, nbps, npasses, ends) in sorted(rows):
                    assert nbps <= mb, (nbps, mb, r, bi)
                    if npasses <= 0:
                        plan.append(plan_layers(b"", 0, mb - nbps,
                                                cp.num_layers))
                        continue
                    groups = seg_pass_groups(ccp.cblk_style & 0x05,
                                             npasses)
                    assert len(ends) == len(groups), (ends, groups)
                    prev = 0
                    segl = []
                    for e_, g_ in zip(ends, groups):
                        segl.append((seg[prev:e_], g_))
                        prev = e_
                    plan.append(plan_layers_seg(segl, mb - nbps,
                                                cp.num_layers))
            else:
                for k, (seg, nbps, npasses) in sorted(rows):
                    assert nbps <= mb, (nbps, mb, r, bi)
                    plan.append(plan_layers(seg, npasses, mb - nbps,
                                            cp.num_layers))
            penc.set_plan(c, r, p, bi, plan)

        packets = [
            penc.write_packet(c, r, p, l)
            for (l, r, c, p) in progression_iter(cp, res_by_c, C, tx0, ty0,
                                                 sub=sub)
        ]
        tiles.append(b"".join(packets))

    # assemble codestream
    out = bytearray(struct.pack(">H", SOC))
    out += write_siz(siz, rsiz=0x4000 if ht else 0)
    if ht:
        out += write_cap(max(e + cp.guard_bits - 1 for e, _m in cp.band_q))
    out += write_cod(cp)
    out += write_qcd(cp)
    if cp.rgn:
        for c_, s_ in sorted(cp.rgn.items()):
            out += _marker_seg(RGN, bytes([c_, 0, s_]))
    for c, spec in (per_comp or {}).items():
        o = cp.comp_overrides[int(c)]
        if "cblk" in spec:
            out += write_coc(int(c), o, C)
        if spec.get("eps_shift"):
            out += write_qcc(int(c), o, C)
    for t, tdata in enumerate(tiles):
        lsot = 10
        psot = 2 + lsot + 2 + len(tdata)
        out += struct.pack(">HHHIBB", SOT, lsot, t, psot, 0, 1)
        out += struct.pack(">H", SOD)
        out += tdata
    out += struct.pack(">H", EOC)
    cs = bytes(out)
    if stream_type == "jp2":
        return wrap_jp2(cs, siz, colorspace)
    if stream_type == "jph":  # HTJ2K container brand (ISO 15444-15)
        return wrap_jp2(cs, siz, colorspace, brand=b"jph ")
    return cs


# ------------------------------------------------------------------ decode
_PLANE_POOL = [None]
_PLANE_POOL_LOCK = threading.Lock()


def _plane_pool() -> ThreadPoolExecutor:
    """Persistent executor for per-component IDWT fan-out (daemon threads;
    lives for the process — the tile loop runs at image rate, so an executor
    made and joined per call is a fixed cost a tile)."""
    with _PLANE_POOL_LOCK:
        if _PLANE_POOL[0] is None:
            _PLANE_POOL[0] = ThreadPoolExecutor(
                max_workers=min(4, os.cpu_count() or 1),
                thread_name_prefix="j2k-plane")
        return _PLANE_POOL[0]


# ------------------------------------------------------ device pixel stage
class J2kDeviceStageError(RuntimeError):
    """The device pixel stage (upload, IDWT, MCT, level shift) failed. Kept
    apart from the host stage's ValueError: a stream the host stage rejects
    may go to another decoder, a device failure is raised to the caller."""


# pixels of the image below which the decoder plugin keeps the pixel stage
# on the host (launches and the transfer outweigh a small tile): on an H100
# the host route wins up to 256x256 and the two draw from 512x512 up
# (PERF.md section 6, the J2K crossover)
DEVICE_STAGE_MIN_PIXELS = 512 * 512

# one device stage launches at a time: threads that launch into a CUDA
# context at once spin in its driver (on an H100 with 8 host cores, 16
# threads took ~100 ms of CPU a stage, and one at a time ~4 ms), and a
# decoder with batches in flight runs a stage on every sample thread
_LAUNCH_LOCK = threading.Lock()

# streams per pixel stage: "device" one tile, "device_tiles" a uniform tile
# grid, "host" the native / host synthesis
ROUTES = {"device": 0, "device_tiles": 0, "host": 0}
_ROUTES_LOCK = threading.Lock()


def _count_route(route: str) -> None:
    with _ROUTES_LOCK:
        ROUTES[route] += 1


def device_route_auto(npixels: int, device) -> bool:
    """The plugin's route rule when the caller did not choose: the device
    stage for a CUDA device and an image of DEVICE_STAGE_MIN_PIXELS or
    more."""
    return (device is not None and torch.device(device).type == "cuda"
            and npixels >= DEVICE_STAGE_MIN_PIXELS)


def tier1_on_device(device, reversible: bool, ht: bool, rgn: bool,
                    mesh: bool, cblk_area: int) -> bool:
    """Whether a tile the device pixel stage takes also decodes its
    code-blocks on the card (ops/j2k_t1.py): on a CUDA device, with every
    component reversible (the int32 stage), no HT blocks, no ROI shift, no
    mesh, and code-blocks of at most j2k_t1.MAX_BLOCK_AREA coefficients (as
    T.800 bounds them). Any other tile keeps the host Tier-1."""
    return (device is not None and torch.device(device).type == "cuda"
            and reversible and not ht and not rgn and not mesh
            and cblk_area <= j2k_t1.MAX_BLOCK_AREA)


def _upload_buffer(n: int, dtype: torch.dtype, device,
                   zero: bool = True) -> torch.Tensor:
    """A host buffer of n elements, zeroed where `zero`, pinned for a CUDA
    device. Pinning goes through the CUDA runtime, so its failure is the
    device stage's."""
    make = torch.zeros if zero else torch.empty
    if device.type != "cuda":
        return make(n, dtype=dtype)
    try:
        return make(n, dtype=dtype, pin_memory=True)
    except Exception as e:
        raise J2kDeviceStageError(
            f"J2K device pixel stage failed on {device}: pinned upload "
            f"buffer: {type(e).__name__}: {e}") from e


class _SubbandStage:
    """All subbands of one tile, or of every tile of a uniform grid, in ONE
    flat buffer that the pixel stage reads.

    `lead` is (C,) or (T, C); leaf i is the [*lead, h, w] stack of one
    subband: LL first, then (HL, LH, HH) per level, finest first. The
    leaves are int32: a 5/3 stage's coefficients, or, with `steps` (a 9/7
    stage: each leaf's quantiser step over 2), each coefficient's
    mid-interval reconstruction with one fractional bit, which the stage
    multiplies by the step in float32 after the upload (`dequantized`).
    Without `t1`, the buffer is on the host (pinned for a CUDA device) and
    goes up in one copy: the host Tier-1 writes every block straight into
    the leaves' views, so the buffer is written once and never repacked.
    With `t1`, the code-block table (ops/j2k_t1.py) of the card's Tier-1,
    the table goes up with the codestream instead, and the buffer is made
    zeroed on the device and decoded into there."""

    def __init__(self, lead, band_dims, device,
                 t1: Optional[j2k_t1.BlockTable] = None,
                 steps: Optional[List[float]] = None):
        self.lead = tuple(lead)
        self.shapes = [self.lead + tuple(d) for d in band_dims]
        sizes = [math.prod(sh) for sh in self.shapes]
        self.offs = [0]
        for n in sizes:
            self.offs.append(self.offs[-1] + n)
        self.t1 = t1
        self.steps = steps
        self.flat = self.leaves = None
        if t1 is None:
            self.flat = _upload_buffer(self.offs[-1], torch.int32, device)
            flat_np = self.flat.numpy()
            self.leaves = [flat_np[self.offs[i]:self.offs[i + 1]].reshape(sh)
                           for i, sh in enumerate(self.shapes)]

    @staticmethod
    def leaf_index(levels: int, r: int, bi: int) -> int:
        return 0 if r == 0 else 1 + 3 * (levels - r) + bi

    def plane_offset(self, i: int, idx) -> int:
        """Element offset in the flat buffer of leaf i's plane at lead index
        `idx`."""
        h, w = self.shapes[i][-2:]
        flat = 0
        for k, n in zip(idx, self.lead):
            flat = flat * n + k
        return self.offs[i] + flat * h * w

    def dequantized(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat buffer of the stage's layout, where it lives: as it is
        for a 5/3 stage; for a 9/7 stage, float32, each leaf's int32
        half-steps times its step over 2 (one multiply a leaf)."""
        if self.steps is None:
            return flat
        with span("imgcodec.jpeg2k.dequantize"):
            out = torch.empty(flat.shape, dtype=torch.float32,
                              device=flat.device)
            for i, step in enumerate(self.steps):
                a, b = self.offs[i], self.offs[i + 1]
                torch.mul(flat[a:b], step, out=out[a:b])
        return out

    def _views(self, flat: torch.Tensor):
        lv = [flat[self.offs[i]:self.offs[i + 1]].view(sh)
              for i, sh in enumerate(self.shapes)]
        return lv[0], [tuple(lv[1 + 3 * k:4 + 3 * k])
                       for k in range((len(lv) - 1) // 3)]

    def host_tensors(self):
        """(LL, bands finest-first) as CPU tensors of the host buffer
        (views of it, pinned for a CUDA device, for a 5/3 stage): what a
        mesh's devices copy their shares from."""
        return self._views(self.dequantized(self.flat))

    def upload(self, device):
        """One copy; (LL, bands finest-first) as views of the device
        buffer. Where Tier-1 runs on the device, the copy is of the table
        and codestream, staged here in one pinned buffer (under the caller's
        launch lock: the pinned allocator calls into the driver), and the
        code-blocks are then decoded into a zeroed device buffer (one
        launch, not synchronised)."""
        with span("imgcodec.jpeg2k.upload"):
            if self.t1 is None:
                src = self.flat
            else:
                src, layout = self.t1.staged(lambda n: _upload_buffer(
                    n, torch.uint8, device, zero=False))
            dev = src.to(device, non_blocking=True)
            add_count("imgcodec.jpeg2k.h2d_bytes",
                      src.numel() * src.element_size()
                      if device.type == "cuda" else 0)
        if self.t1 is not None:
            with span("imgcodec.jpeg2k.t1_launch"):
                staged = dev
                dev = torch.zeros(self.offs[-1], dtype=torch.int32,
                                  device=device)
                j2k_t1.decode_codeblocks(staged, layout, dev)
        return self._views(self.dequantized(dev))


def device_pixels(LL, bands, out_shape, reversible: bool, mct: bool,
                  depth: int, origin=(0, 0)) -> torch.Tensor:
    """The device pixel stage on [..., C, h, w] subband stacks: inverse DWT
    batched over the leading axes, inverse RCT / ICT, rounding (irreversible
    only, half to even), level shift and clamp. Returns [..., C, H, W]
    int32 samples in [0, 2^depth)."""
    return pixel_epilogue(
        dwt_ops.idwt2d(LL, bands, out_shape, reversible, origin), reversible,
        mct, depth)


def pixel_epilogue(plane: torch.Tensor, reversible: bool, mct: bool,
                   depth: int) -> torch.Tensor:
    """The device pixel stage after the inverse DWT, on [..., C, h, w]
    planes (a whole image or a block of its rows)."""
    if mct:
        y, cb_, cr = plane.unbind(-3)
        if reversible:  # inverse RCT (T.800 G.2)
            g = y - ((cb_ + cr) >> 2)
            plane = torch.stack([cr + g, g, cb_ + g], dim=-3)
        else:  # inverse ICT
            plane = torch.stack(
                [y + 1.402 * cr,
                 y - 0.344136 * cb_ - 0.714136 * cr,
                 y + 1.772 * cb_], dim=-3)
    if not reversible:
        plane = torch.round(plane)
    plane = (plane + (1 << (depth - 1))).clamp(0, (1 << depth) - 1)
    return plane.to(torch.int32)


def _to_samples(img_i32: torch.Tensor, depth: int) -> torch.Tensor:
    """int32 in [0, 2^depth), in any (permuted) layout → contiguous uint8,
    or uint16 through the int16 view (few torch ops take uint16): one copy
    that casts and lays the samples out."""
    out = torch.empty(img_i32.shape, device=img_i32.device,
                      dtype=torch.int16 if depth > 8 else torch.uint8)
    out.copy_(img_i32)
    return out.view(torch.uint16) if depth > 8 else out


class _DeviceJob(NamedTuple):
    """What the host stages hand to the device stage: the filled upload
    buffer and the geometry of the tile, or of the uniform grid."""
    stage: _SubbandStage
    device: torch.device
    cp: CodingParams
    C: int
    depth: int
    tile_shape: Tuple[int, int]
    origin: Tuple[int, int]
    grid: Optional[Tuple[int, int]] = None  # (tiles_y, tiles_x)
    missing: Tuple[int, ...] = ()  # tiles of the grid without a tile-part


def _rows_sharded_samples(job: _DeviceJob, mesh) -> torch.Tensor:
    """One tile (origin (0, 0)) with its inverse DWT's rows split over the
    mesh's "sp" devices (`ops/dwt.idwt2d_rows_sharded`, halo rows copied
    between neighbours); MCT, shift and clamp on each shard; the [H, W, C]
    samples assembled on the job's device (the mesh's first)."""
    stage, device, cp, C, depth, tile_shape = job[:6]
    blocks = dwt_ops.idwt2d_rows_sharded(*stage.host_tensors(), tile_shape,
                                         cp.reversible, mesh)
    add_count("imgcodec.jpeg2k.row_shards", len(blocks))
    return torch.cat([
        _to_samples(pixel_epilogue(b, cp.reversible, cp.mct and C == 3,
                                   depth).permute(1, 2, 0), depth)
        .to(device, non_blocking=True) for b in blocks])


def _tiles_sharded_pixels(job: _DeviceJob, mesh) -> torch.Tensor:
    """A uniform grid's tile axis split into contiguous shards over the
    mesh's "sp" devices (`parallel/tiles.idwt_tiles_sharded`): each device
    copies its tiles' subbands from the host buffer and runs the pixel
    stage on them; the [T, C, th, tw] int32 samples gathered on the job's
    device."""
    stage, device, cp, C, depth, tile_shape = job[:6]
    parts = idwt_tiles_sharded(*stage.host_tensors(), tile_shape,
                               cp.reversible, mesh)
    add_count("imgcodec.jpeg2k.tile_shards", len(parts))
    return torch.cat([
        pixel_epilogue(p, cp.reversible, cp.mct and C == 3, depth)
        .to(device, non_blocking=True) for p in parts])


def _run_device_stage(job: _DeviceJob, mesh=None) -> torch.Tensor:
    """Upload the job's buffer and run the pixel stage: one tile → [H, W,
    C]; a uniform grid → the assembled [ty*th, tx*tw, C], zero where a tile
    is missing (as the host path leaves it). With a mesh, one tile at origin
    (0, 0) with levels splits its rows over "sp", and a grid whose tile
    count divides by sp splits its tiles; anything else runs on the job's
    device alone. Any failure is raised as J2kDeviceStageError."""
    stage, device, cp, C, depth, tile_shape, origin, grid, missing = job
    sp = mesh.shape["sp"] if mesh is not None else 0
    rows = sp and grid is None and cp.levels > 0 and origin == (0, 0)
    tiles = sp and grid is not None and (grid[0] * grid[1]) % sp == 0
    try:
        # one launcher at a time on a CUDA device (_LAUNCH_LOCK)
        with (_LAUNCH_LOCK if device.type == "cuda"
              else contextlib.nullcontext()):
            # with a mesh, each device copies its share of the host buffer
            if not (rows or tiles):
                LL, bands = stage.upload(device)
            with span("imgcodec.jpeg2k.device_stage"):
                if rows:
                    img = _rows_sharded_samples(job, mesh)
                else:
                    px = (_tiles_sharded_pixels(job, mesh) if tiles else
                          device_pixels(LL, bands, tile_shape, cp.reversible,
                                        cp.mct and C == 3, depth, origin))
                    if grid is None:
                        img = _to_samples(px.permute(1, 2, 0), depth)
                    else:
                        if missing:
                            px[list(missing)] = 0
                        th, tw = tile_shape
                        # [T, C, th, tw] → [ty, th, tx, tw, C] → [H, W, C]
                        img = _to_samples(
                            px.view(grid[0], grid[1], C, th, tw).permute(
                                0, 3, 1, 4, 2), depth
                        ).view(grid[0] * th, grid[1] * tw, C)
    except J2kDeviceStageError:
        raise
    except Exception as e:
        raise J2kDeviceStageError(
            f"J2K device pixel stage failed on {device}: "
            f"{type(e).__name__}: {e}") from e
    return img[:, :, 0] if C == 1 else img


def _roi_needed_rect(r: int, levels: int, ay0: int, ax0: int, ay1: int,
                     ax1: int) -> Tuple[int, int, int, int]:
    """Band-coordinate rectangle of coefficients that can influence the
    absolute pixel rect [ay0,ay1)×[ax0,ax1): the rect mapped to the band's
    scale plus a synthesis-filter margin (M=8 covers the accumulated 5/3 and
    9/7 support at the band's own scale). Code-blocks outside it are never
    entropy-decoded (reference analog: nvjpeg2k ROI decode via
    nvjpeg2kDecodeTile region params)."""
    s = (1 << levels) if r == 0 else (1 << (levels - r + 1))
    M = 8
    return (ay0 // s - M, ax0 // s - M, -(-ay1 // s) + M, -(-ax1 // s) + M)


def decode_j2k(
    data: bytes,
    num_threads: int = 0,
    *,
    device,
    discard_levels: int = 0,
    region=None,
    planar: bool = False,
    mesh=None,
):
    """Decode JP2/J2K bytes → [H, W] or [H, W, C] u8/u16 (i8/i16 when the
    SIZ declares signed components — no DC level shift, T.800 G.1).

    Subsampled components (XRsiz/YRsiz > 1, T.800 A.5.1) decode natively:
    each component's tile-grid, resolutions and progression anchors live in
    its own component coordinates (the reference parses these in
    src/parsers/jpeg2k.cpp:280-356 and nvjpeg2k decodes them natively).
    With planar=True the per-component planes are returned exactly as coded
    (a list of [h_c, w_c] arrays); the default interleaved output replicates
    subsampled components onto the full reference grid.

    discard_levels > 0 reconstructs at a reduced resolution (the classic
    JPEG2000 multi-resolution decode): the top `discard_levels` resolutions'
    code-blocks are never entropy-decoded and the inverse DWT stops early,
    so a d-level discard costs roughly 4^-d of the full-pixel work.

    region (core.types.Region, full-resolution output coordinates, only with
    discard_levels=0): true ROI decode — tiles that do not intersect the
    region are skipped without parsing a packet, and within covering tiles
    only code-blocks whose DWT support can reach the region are
    entropy-decoded. Returns exactly the region. Bit-identical to cropping a
    full decode.

    device (the caller always names it): None keeps the pixel stage on the
    host and returns numpy. A
    torch.device asks for the device pixel stage: a single-tile stream, or a
    uniform tile grid (no offsets, the image a whole number of tiles, tile
    sides multiples of 2^levels so every tile has the same subband
    geometry), without COC/QCC overrides, subsampling, signed samples,
    discard_levels or a region, comes back as a tensor on that device (5/3
    bit-exact with the host path, 9/7 in float32 within 1). Any other stream
    takes the host path and comes back as numpy. A grid with a tile missing
    decodes the tiles present and leaves the missing one at zero, as the
    host path does. A failure of the device stage raises
    J2kDeviceStageError; every error of the host stage is a ValueError (or
    what the parser raises).

    mesh (parallel.mesh.Mesh): the device stage runs over the mesh and the
    image comes back on its first device, which replaces `device`. A
    uniform grid splits its tiles over "sp" when their count divides by sp;
    one tile at origin (0, 0) with levels splits its inverse DWT's rows
    over "sp", with halo rows copied between neighbouring devices; any
    other device-stage stream runs on the first device alone."""
    if mesh is not None:
        device = mesh.first_device
    if device is not None:
        device = torch.device(device)
    with span("imgcodec.jpeg2k.host_stage"):
        res = _decode_host_stages(bytes(data), num_threads, device,
                                  discard_levels, region, planar,
                                  mesh=mesh)
    if isinstance(res, _DeviceJob):
        img = _run_device_stage(res, mesh)
        _count_route("device" if res.grid is None else "device_tiles")
        return img
    _count_route("host")
    return res




# ----------------------------------------------------- the plan of a stream
def _expand_derived(q: CodingParams) -> None:
    """Scalar derived quantisation (one QCD step): expanded to a step a
    band, eps decreasing with the level."""
    if q.qcd_style == 1 and len(q.band_q) == 1:
        eps0, mu0 = q.band_q[0]
        q.band_q = []
        for (r, bi) in _band_order(q):
            lev = q.levels if r == 0 else q.levels - r + 1
            q.band_q.append((eps0 - q.levels + lev, mu0))


class StreamPlan(NamedTuple):
    """What the main header decides for a whole stream (`plan_stream`);
    nothing after it asks these questions again."""
    pos: int  # the first tile-part
    siz: SizInfo
    cp: CodingParams
    ccs: List[CodingParams]  # a component's own (COC/QCC) parameters
    sub: List[Tuple[int, int]]  # (XRsiz, YRsiz) a component
    subsampled: bool
    signed: bool
    reversible: bool  # every component 5/3
    depth: int
    dtype: type  # of the samples out
    discard: int  # the finest resolutions not reconstructed
    out_shape: Tuple[int, int]  # (H, W) at the decoded resolution
    roi: Optional[Tuple[int, int, int, int]]  # (y0, x0, y1, x1), decoded alone
    post_crop: Optional[Tuple[int, int, int, int]]  # cut from a full decode
    device: Optional[torch.device]
    pixels: str  # "host", "device_tile" or "device_grid"
    tier1: str  # "card_table", "native_into" or "native_blocks"
    # the main header, which with a tile's index and POC fixes the tile's
    # Tier-2 layout (None with PPM: it holds every packet header)
    header: Optional[bytes]


def plan_stream(cs: bytes, device, discard_levels: int = 0, region=None,
                mesh=None) -> StreamPlan:
    """Reads the main header of the codestream `cs` and decides, once:

    - the pixel route: with `device` named, "device_tile" for one tile and
      "device_grid" for a uniform tile grid (no offsets, the image a whole
      number of tiles, tile sides multiples of 2^levels, so every tile has
      the same subband geometry), unless the stream has COC/QCC overrides,
      subsampling or signed samples, or the call a discard or a region;
      "host" otherwise;
    - the Tier-1 site: "card_table" where the device route takes the stream
      and `tier1_on_device` holds; else "native_into" (the native decoder
      writes into the subband planes) where every component is 5/3, and
      "native_blocks" (9/7 planes of mid-interval half-steps, dequantised
      on the host, or on the device by the stage) otherwise.

    Arbitrary (incl. odd) image and tile offsets and odd tile sizes are
    decoded: the DWT lifts take per-level parity from the absolute
    tile-component origin (ops/dwt.py; T.800 F.3.4's 1D_SR on [i0, i1))."""
    siz, cp, pos = parse_main_header(cs, 0)
    if len(set(siz.depth)) > 1 or len(set(siz.signed)) > 1:
        raise ValueError("J2K: mixed component depth/signedness not supported")
    _expand_derived(cp)
    for o in cp.comp_overrides.values():
        _expand_derived(o)
    C = siz.ncomp
    ccs = [cp.for_comp(c) for c in range(C)]
    uniform_cp = not cp.comp_overrides or all(
        (o.levels, o.reversible, o.cblk_w, o.cblk_h, o.cblk_style)
        == (cp.levels, cp.reversible, cp.cblk_w, cp.cblk_h, cp.cblk_style)
        for o in cp.comp_overrides.values())
    if discard_levels and not uniform_cp:
        raise ValueError(
            "J2K: discard_levels with per-component COC not supported")
    sub = list(zip(siz.sub_x, siz.sub_y))
    subsampled = any(s != (1, 1) for s in sub)
    signed = bool(siz.signed and siz.signed[0])
    depth = siz.depth[0]
    if signed:
        dtype = np.int16 if depth > 8 else np.int8
    else:
        dtype = np.uint16 if depth > 8 else np.uint8
    discard = max(0, min(discard_levels, cp.levels))
    d = 1 << discard
    out_shape = (ceil_div(siz.height, d) - ceil_div(siz.y0, d),
                 ceil_div(siz.width, d) - ceil_div(siz.x0, d))
    # ROI: absolute codestream coordinates of the requested region
    roi = post_crop = None
    if region is not None and discard == 0:
        ay0 = siz.y0 + int(region.start_y)
        ax0 = siz.x0 + int(region.start_x)
        ay1 = siz.y0 + int(region.end_y)
        ax1 = siz.x0 + int(region.end_x)
        if (siz.y0 <= ay0 < ay1 <= siz.height
                and siz.x0 <= ax0 < ax1 <= siz.width):
            if subsampled:
                # component grids disagree with the region's full-grid
                # coordinates: decode full, crop the interleaved output
                post_crop = (ay0 - siz.y0, ax0 - siz.x0,
                             ay1 - siz.y0, ax1 - siz.x0)
            else:
                roi = (ay0, ax0, ay1, ax1)
    pixels = "host"
    if (device is not None and not cp.comp_overrides and not subsampled
            and not signed and discard == 0 and roi is None):
        if siz.tiles_x * siz.tiles_y == 1:
            pixels = "device_tile"
        elif (siz.x0 == 0 and siz.y0 == 0 and siz.tx0 == 0 and siz.ty0 == 0
              and siz.width % siz.tile_w == 0
              and siz.height % siz.tile_h == 0
              and siz.tile_w % (1 << cp.levels) == 0
              and siz.tile_h % (1 << cp.levels) == 0):
            pixels = "device_grid"
    reversible = all(cc.reversible for cc in ccs)
    if pixels != "host" and tier1_on_device(
            device, reversible, any(cc.cblk_style & 0x40 for cc in ccs),
            any((cp.rgn or {}).values()), mesh is not None,
            cp.cblk_w * cp.cblk_h):
        tier1 = "card_table"
    else:
        tier1 = "native_into" if reversible else "native_blocks"
    return StreamPlan(pos, siz, cp, ccs, sub, subsampled, signed,
                      reversible, depth, dtype, discard, out_shape, roi,
                      post_crop, device, pixels, tier1,
                      cs[:pos] if cp.ppm is None else None)


class _Tile(NamedTuple):
    """One tile at the decoded resolution."""
    index: int
    cp: CodingParams  # its tile-part POC overrides the main header's
    rect: Tuple[int, int, int, int]  # (x0, y0, x1, y1), reference grid
    reduced: Tuple[int, int, int, int]  # the rect divided by 2^discard
    comp_rects: List[Tuple[int, int, int, int]]  # a component's (T.800 B.3)
    comp_dims: List[Tuple[int, int]]  # a component's (h, w), decoded
    resolutions: Dict[int, list]


def _tile(plan: StreamPlan, tidx: int, tpoc) -> Optional[_Tile]:
    """The tile's geometry; None where a region leaves it out (no work)."""
    # a tile-part POC overrides the main-header POC for this tile (T.800
    # A.6.6; openjpeg writes POC in the first tile-part)
    tcp = plan.cp if tpoc is None else dataclasses.replace(
        plan.cp, poc=parse_poc_body(tpoc, plan.siz.ncomp))
    tx0, ty0, tx1, ty1 = plan.siz.tile_rect(tidx)
    roi = plan.roi
    if roi is not None and (
        tx1 <= roi[1] or tx0 >= roi[3] or ty1 <= roi[0] or ty0 >= roi[2]
    ):
        return None
    d = 1 << plan.discard
    tcr = [(ceil_div(tx0, sx), ceil_div(ty0, sy), ceil_div(tx1, sx),
            ceil_div(ty1, sy)) for sx, sy in plan.sub]
    dims = [(ceil_div(y1, d) - ceil_div(y0, d),
             ceil_div(x1, d) - ceil_div(x0, d)) for x0, y0, x1, y1 in tcr]
    res = {c: build_resolutions(*tcr[c], cc.levels)
           for c, cc in enumerate(plan.ccs)}
    return _Tile(tidx, tcp, (tx0, ty0, tx1, ty1),
                 tuple(ceil_div(v, d) for v in (tx0, ty0, tx1, ty1)), tcr,
                 dims, res)


def _leaf(plan: StreamPlan, tile: _Tile, c: int, r: int, bi: int):
    """(leaf, lead index) of component c's subband (r, bi) of the tile in
    the stage's buffer."""
    return (_SubbandStage.leaf_index(plan.cp.levels, r, bi),
            (tile.index, c) if plan.pixels == "device_grid" else (c,))


def _subband_stage(plan: StreamPlan, tile: _Tile) -> _SubbandStage:
    """The device route's buffer, made at the first tile, whose geometry
    every tile of a uniform grid shares; with the card's Tier-1, its
    code-block table."""
    cp = plan.cp
    dims = [None] * (1 + 3 * cp.levels)
    for (r, bi) in _band_order(cp):
        band = tile.resolutions[0][r].bands[bi]
        dims[_SubbandStage.leaf_index(cp.levels, r, bi)] = (band.h, band.w)
    steps = None
    if not cp.reversible:  # the device route's components share cp's steps
        steps = [None] * len(dims)
        for (r, bi) in _band_order(cp):
            steps[_SubbandStage.leaf_index(cp.levels, r, bi)] = _step(
                plan, cp, tile.resolutions[0][r].bands[bi], r, bi) / 2
    siz = plan.siz
    lead = ((siz.tiles_x * siz.tiles_y, siz.ncomp)
            if plan.pixels == "device_grid" else (siz.ncomp,))
    return _SubbandStage(
        lead, dims, plan.device,
        j2k_t1.BlockTable() if plan.tier1 == "card_table" else None, steps)


def _step(plan: StreamPlan, cc: CodingParams, band: Band, r: int,
          bi: int) -> float:
    """The quantiser step of a 9/7 band (T.800 E-3)."""
    eps, mu = cc.band_q[_band_order(cc).index((r, bi))]
    return _eps_mu_to_delta(eps, mu, plan.depth + band.gain)


# -------------------------------------------------------- Tier-2 to Tier-1
# Tier-2 layouts (t2.TileLayout) of the tiles decoded lately, by (main
# header, tile index, tile-part POC): a store of images written alike
# decodes every one with the same layout
_LAYOUTS: Dict[tuple, TileLayout] = {}


def _tier2(plan: StreamPlan, tile: _Tile, tdata: bytes, ppt) -> PacketDecoder:
    """The tile's packet headers in progression order, from the tile data
    or, with PPT/PPM, from the packed headers: each code-block's passes and
    codeword segments."""
    key = (plan.header, tile.index,
           tuple(tile.cp.poc) if tile.cp.poc else None)
    layout = _LAYOUTS.get(key) if plan.header is not None else None
    if layout is None:
        layout = tile_layout(
            tile.cp, tile.resolutions,
            progression_iter(tile.cp, tile.resolutions, plan.siz.ncomp,
                             tile.rect[0], tile.rect[1], sub=plan.sub))
        if plan.header is not None:
            if len(_LAYOUTS) >= 64:
                _LAYOUTS.clear()
            _LAYOUTS[key] = layout
    pdec = PacketDecoder(layout)
    pdec.read_packets(tdata, ppt)
    return pdec


def _band_specs(plan: StreamPlan, tile: _Tile, pdec: PacketDecoder, sink):
    """Every band of the tile that Tier-1 decodes (QCD order a component,
    the finest `discard` resolutions left out), as `PacketDecoder.rows`
    takes it: its destination from the sink, its Mb, its code-block style
    and, with a region, the band's share of the region's DWT support."""
    rgn = plan.cp.rgn or {}
    specs = []
    for c, cc in enumerate(plan.ccs):
        for i, (r, bi) in enumerate(_band_order(cc)):
            if r > cc.levels - plan.discard:
                continue
            band = tile.resolutions[c][r].bands[bi]
            eps, _mu = cc.band_q[i]
            need = (_roi_needed_rect(r, plan.cp.levels, *plan.roi)
                    if plan.roi is not None else None)
            specs.append(pdec.band_spec(
                c, r, bi, band, sink.band(c, r, bi, band),
                eps + cc.guard_bits - 1 + rgn.get(c, 0),
                cc.cblk_style | (_MIDPOINT if _midpoint(plan, c) else 0),
                need))
    return specs


# the style bit of a 9/7 band's part-1 blocks (native/j2k_t1.cpp
# kMidpoint): each coefficient written as 2|q| + 2^L, twice the middle of
# the interval its decoded bit-planes leave (T.800 E.1.1.2, r = 1/2)
_MIDPOINT = 0x80


def _midpoint(plan: StreamPlan, c: int) -> bool:
    """Whether component c's part-1 blocks decode to mid-interval
    half-steps: its 9/7 components without an ROI shift (those, and HT
    blocks, decode to integers that `_NativeBlocks` makes half-steps)."""
    cc = plan.ccs[c]
    return not cc.reversible and not (plan.cp.rgn or {}).get(c, 0)


# ------------------------------------------------------------ Tier-1 sinks
# A sink takes one tile's code-blocks: `band(c, r, bi, band)` gives the
# band's destination, (element offset of its plane, row stride), `base` is
# where the tile's data starts in the data the rows count from, and
# `finish(rows, tdata)` decodes (or, on the card, checks and keeps) the
# tile's rows (`t2.TileRows`) and returns the blocks it took; the host
# sinks charge their native workers' CPU to span imgcodec.jpeg2k.t1_host.
# `planes[c][(r, bi)]` are the decoded planes the host pixel stage reads.
def _rgn_unshift(a: np.ndarray, s: int) -> np.ndarray:
    """Maxshift decode (T.800 H.2): coefficients whose magnitude reaches
    the shifted planes are ROI; scale them back down."""
    mag = np.abs(a)
    hi = mag >= (1 << s)
    return np.where(hi, np.sign(a) * (mag >> s), a)


class _CardTable:
    """Tier-1 on the card: the tile's rows and data into the stage's
    code-block table (checked: a row the native decoder refuses raises
    here), decoded after the upload into the stage's device buffer
    (_SubbandStage.upload)."""
    planes = None

    def __init__(self, plan, tile, stage, num_threads):
        self.plan, self.tile, self.stage = plan, tile, stage
        self.base = stage.t1.size

    def band(self, c, r, bi, band):
        """(element offset of the band's plane in the flat buffer, its row
        stride)."""
        return (self.stage.plane_offset(*_leaf(self.plan, self.tile, c, r,
                                               bi)), band.w)

    def finish(self, rows, tdata):
        return self.stage.t1.add_tile(rows.t1, (tdata, rows.side),
                                      rows.bad)


class _NativeInto:
    """The native decoder, one batch a tile, writing each block straight
    into its int32 subband plane (the stage's leaf where the device route
    takes the tile); RGN-shifted planes are scaled back after."""
    base = 0

    def __init__(self, plan, tile, stage, num_threads):
        self.plan, self.tile, self.stage = plan, tile, stage
        self.num_threads = num_threads
        self.planes = [{} for _ in plan.ccs]

    def _target(self, c, r, bi, band) -> np.ndarray:
        if self.stage is None:
            return np.zeros((band.h, band.w), np.int32)
        i, idx = _leaf(self.plan, self.tile, c, r, bi)
        return self.stage.leaves[i][idx]

    def band(self, c, r, bi, band):
        """(the band's int32 plane as an element offset of memory, its
        address over 4; its row stride); the plane is kept in `planes`,
        alive until the batch has run."""
        a = self._target(c, r, bi, band)
        assert (a.dtype == np.int32 and a.flags.c_contiguous
                and a.ctypes.data % 4 == 0)
        self.planes[c][(r, bi)] = a
        return a.ctypes.data // 4, a.shape[1]

    def finish(self, rows, tdata):
        with span("imgcodec.jpeg2k.t1_host"):
            cpu_ns = decode_rows_into(rows, tdata, self.num_threads)
            charge_ns("imgcodec.jpeg2k.t1_host", cpu_ns)
        rgn = self.plan.cp.rgn or {}
        for c, planes in enumerate(self.planes):
            if rgn.get(c, 0):
                for a in planes.values():
                    a[...] = _rgn_unshift(a, rgn[c])
        add_count("imgcodec.jpeg2k.coding_passes",
                  int(rows.t1[:, 6].sum()) + int(rows.ht[:, 4].sum()))
        return len(rows.t1) + len(rows.ht)


class _NativeBlocks(_NativeInto):
    """As _NativeInto, where a component may be 9/7: its part-1 blocks
    decode to mid-interval half-steps (`_MIDPOINT`), its HT or ROI-shifted
    blocks to integers q made 2|q| + 1 here (the middle of the finest bin,
    where the HT decoder has put a truncated block's value already). On
    the device route the planes are the stage's leaves, which the stage
    dequantises on the device; on the host every 9/7 plane is dequantised
    here into float64 (half-steps times the step over 2)."""

    def finish(self, rows, tdata):
        n = super().finish(rows, tdata)
        for c, planes in enumerate(self.planes):
            cc = self.plan.ccs[c]
            if cc.reversible:
                continue
            if not _midpoint(self.plan, c) or cc.cblk_style & 0x40:
                for a in planes.values():
                    a[...] = 2 * a + np.sign(a)
        if self.stage is not None:
            return n
        with span("imgcodec.jpeg2k.dequantize"):
            for c, planes in enumerate(self.planes):
                cc = self.plan.ccs[c]
                if cc.reversible:
                    continue
                for (r, bi), a in planes.items():
                    band = self.tile.resolutions[c][r].bands[bi]
                    planes[(r, bi)] = a * (
                        _step(self.plan, cc, band, r, bi) / 2)
        return n


_SINKS = {"card_table": _CardTable, "native_into": _NativeInto,
          "native_blocks": _NativeBlocks}


def _tier1(plan: StreamPlan, tile: _Tile, pdec: PacketDecoder, tdata: bytes,
           stage: Optional[_SubbandStage], num_threads: int):
    """Tier-1 of every code-block of the tile through the plan's sink: the
    rows of the tile's code-blocks, written in one native pass, and its
    counters; returns the sink's decoded planes (None on the card)."""
    sink = _SINKS[plan.tier1](plan, tile, stage, num_threads)
    rows = pdec.rows(_band_specs(plan, tile, pdec, sink), tdata, sink.base)
    n = sink.finish(rows, tdata)
    add_count("imgcodec.jpeg2k.codeblocks", n)
    add_count("imgcodec.jpeg2k.codeblocks_native_rows",
              len(rows.t1) + len(rows.ht))
    if collecting():
        # part-1 blocks whose passes end above plane 0: 3 Mb - 2 a block
        t1 = rows.t1
        add_count("imgcodec.jpeg2k.codeblocks_truncated", int(
            np.count_nonzero(t1[:, 6] < 3 * t1[:, 5] - 2)))
    if plan.tier1 == "card_table":
        add_count("imgcodec.jpeg2k.codeblocks_device", n)
    return sink.planes


# ------------------------------------------------------ host pixel stage
def _host_output(plan: StreamPlan):
    """The zero samples the host pixel stage writes into: a plane a
    component on its own grid where subsampled, else the image (or the
    region) [H, W, C]."""
    siz, C = plan.siz, plan.siz.ncomp
    if plan.subsampled:
        d = 1 << plan.discard
        return [np.zeros((ceil_div(siz.height, fy) - ceil_div(siz.y0, fy),
                          ceil_div(siz.width, fx) - ceil_div(siz.x0, fx)),
                         plan.dtype)
                for fx, fy in ((sx * d, sy * d) for sx, sy in plan.sub)]
    roi = plan.roi
    shape = (roi[2] - roi[0], roi[3] - roi[1]) if roi else plan.out_shape
    return np.zeros(shape + (C,), plan.dtype)


def _idwt_plane(plan: StreamPlan, tile: _Tile, planes, c: int) -> np.ndarray:
    """Component c's inverse DWT on the host: native multi-level 5/3
    synthesis (bit-identical), torch lifting for 9/7. With a discard the
    finest `discard` levels are dropped: lev runs over the coarsest."""
    cc, p = plan.ccs[c], planes[c]
    bands = [(p[(r, 0)], p[(r, 1)], p[(r, 2)])
             for r in (cc.levels - lev + 1
                       for lev in range(plan.discard + 1, cc.levels + 1))]
    d = 1 << plan.discard
    origin = (ceil_div(tile.comp_rects[c][1], d),
              ceil_div(tile.comp_rects[c][0], d))
    if cc.reversible:
        return idwt53(p[(0, 0)], bands, tile.comp_dims[c], origin)
    return _host_idwt2d(p[(0, 0)], bands, tile.comp_dims[c], False, origin)


def _host_pixels(plan: StreamPlan, tile: _Tile, planes, out,
                 num_threads: int) -> None:
    """The host pixel stage of one tile into `out`: the components' inverse
    DWTs, then the fused native epilogue where it applies, else numpy's."""
    idwt = functools.partial(_idwt_plane, plan, tile, planes)
    C = plan.siz.ncomp
    if plan.reversible and C > 1 and num_threads != 1:
        # the native IDWT releases the GIL: components in parallel on a
        # PERSISTENT pool (no thread start/join churn per tile)
        comps = list(_plane_pool().map(idwt, range(C)))
    else:
        comps = [idwt(c) for c in range(C)]
    if (plan.reversible and not plan.subsampled and not plan.signed
            and plan.depth == 8 and plan.roi is None):
        _native_epilogue(plan, tile, comps, out)
    else:
        _numpy_epilogue(plan, tile, comps, out)


def _native_epilogue(plan: StreamPlan, tile: _Tile, comps, out) -> None:
    """Inverse RCT (or none), level shift, clamp and interleave in one
    native sweep, for unsigned 8-bit 5/3 components on one grid."""
    L = _native_lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rx0, ry0, rx1, ry1 = tile.reduced
    th, tw = ry1 - ry0, rx1 - rx0
    d = 1 << plan.discard
    oy0 = ry0 - ceil_div(plan.siz.y0, d)
    ox0 = rx0 - ceil_div(plan.siz.x0, d)
    dst = out[oy0:oy0 + th, ox0:ox0 + tw]
    if len(comps) == 3 and plan.cp.mct:
        tile_u8 = np.empty((th, tw, 3), np.uint8)
        L.tic_j2k_rct_shift_u8(*(p.ctypes.data_as(i32p) for p in comps),
                               th * tw, tile_u8.ctypes.data_as(u8p))
        dst[...] = tile_u8
        return
    for c, p in enumerate(comps):
        tile_u8 = np.empty((th, tw), np.uint8)
        L.tic_j2k_shift_u8(p.ctypes.data_as(i32p), th * tw, 1,
                           tile_u8.ctypes.data_as(u8p))
        dst[:, :, c] = tile_u8


def _numpy_epilogue(plan: StreamPlan, tile: _Tile, comps, out) -> None:
    """Inverse MCT (equal component grids only), rounding of 9/7
    components, level shift (none for signed components, T.800 G.1) and
    clamp; then the tile's samples into `out`: a component's own plane
    where subsampled, the region's share with a region, else the tile's
    place in the image."""
    siz, sub, d = plan.siz, plan.sub, 1 << plan.discard
    if plan.cp.mct and siz.ncomp == 3 and sub[0] == sub[1] == sub[2]:
        y, cb_, cr = comps
        if plan.cp.reversible:  # inverse RCT
            g = y - ((cb_ + cr) >> 2)
            comps = [cr + g, g, cb_ + g]
        else:  # inverse ICT
            comps = [y + 1.402 * cr, y - 0.344136 * cb_ - 0.714136 * cr,
                     y + 1.772 * cb_]
    depth, signed = plan.depth, plan.signed
    shift = 0 if signed else 1 << (depth - 1)
    minv = -(1 << (depth - 1)) if signed else 0
    maxv = (1 << (depth - 1)) - 1 if signed else (1 << depth) - 1
    tx0, ty0, tx1, ty1 = tile.rect
    rx0, ry0, rx1, ry1 = tile.reduced
    roi = plan.roi
    for c, p in enumerate(comps):
        if not plan.ccs[c].reversible:
            p = np.round(p)
        p = np.clip(p + shift, minv, maxv).astype(plan.dtype)
        if plan.subsampled:
            fx, fy = sub[c][0] * d, sub[c][1] * d
            cy0 = ceil_div(ty0, fy) - ceil_div(siz.y0, fy)
            cx0 = ceil_div(tx0, fx) - ceil_div(siz.x0, fx)
            h, w = tile.comp_dims[c]
            out[c][cy0:cy0 + h, cx0:cx0 + w] = p
        elif roi is not None:
            iy0, ix0 = max(ty0, roi[0]), max(tx0, roi[1])
            iy1, ix1 = min(ty1, roi[2]), min(tx1, roi[3])
            out[iy0 - roi[0]:iy1 - roi[0], ix0 - roi[1]:ix1 - roi[1], c] = (
                p[iy0 - ty0:iy1 - ty0, ix0 - tx0:ix1 - tx0])
        else:
            oy0 = ry0 - ceil_div(siz.y0, d)
            ox0 = rx0 - ceil_div(siz.x0, d)
            out[oy0:oy0 + ry1 - ry0, ox0:ox0 + rx1 - rx0, c] = p


def _host_image(plan: StreamPlan, out, planar: bool):
    """The host route's result from `out`: the image ([H, W] for one
    component), or its component planes with `planar`. Subsampled planes
    are interleaved on the full reference grid by sample replication (a
    component sample at v covers grid columns [v*dx, (v+1)*dx)), then cut
    to the region."""
    C = plan.siz.ncomp
    if planar:
        return out if plan.subsampled else [out[:, :, c] for c in range(C)]
    if not plan.subsampled:
        return out[:, :, 0] if C == 1 else out
    siz, d = plan.siz, 1 << plan.discard
    out_h, out_w = plan.out_shape
    full = np.empty((out_h, out_w, C), plan.dtype)
    for c, (sx, sy) in enumerate(plan.sub):
        a = out[c]
        if (sx, sy) != (1, 1):
            a = np.repeat(np.repeat(a, sy, 0), sx, 1)
            # component origin ceil(y0/fy)*sy may start below the image
            # origin row ceil(y0/d): edge-pad the gap
            py = ceil_div(siz.y0, sy * d) * sy - ceil_div(siz.y0, d)
            px = ceil_div(siz.x0, sx * d) * sx - ceil_div(siz.x0, d)
            if py or px:
                a = np.pad(a, ((py, 0), (px, 0)), mode="edge")
            a = a[:out_h, :out_w]
            if a.shape != (out_h, out_w):
                a = np.pad(a, ((0, out_h - a.shape[0]),
                               (0, out_w - a.shape[1])), mode="edge")
        full[:, :, c] = a
    if plan.post_crop is not None:
        y0, x0, y1, x1 = plan.post_crop
        full = full[y0:y1, x0:x1]
    return full[:, :, 0] if C == 1 else full


# ---------------------------------------------------------- the host stages
def _decode_host_stages(data: bytes, num_threads: int, device,
                        discard_levels: int, region, planar: bool,
                        mesh=None):
    """Tier-2 and Tier-1 of every tile, then either the host pixel stage
    (the image as numpy) or, where the plan takes the device route, a
    _DeviceJob: the filled upload buffer, or, with the card's Tier-1, the
    staged code-block table."""
    cs = unwrap_jp2(bytes(data))
    add_count("imgcodec.jpeg2k.stream_bytes", len(cs))
    plan = plan_stream(cs, device, discard_levels, region, mesh)
    out = _host_output(plan) if plan.pixels == "host" else None
    stage = None
    seen = set()  # the grid's tiles with a tile-part
    for tidx, tdata, ppt, tpoc in iter_tile_parts(cs, plan.pos,
                                                  ppm=plan.cp.ppm):
        tile = _tile(plan, tidx, tpoc)
        if tile is None:
            continue  # the tile cannot touch the region: zero work
        with span("imgcodec.jpeg2k.t2"):
            pdec = _tier2(plan, tile, tdata, ppt)
        if stage is None and plan.pixels != "host":
            stage = _subband_stage(plan, tile)
        with span("imgcodec.jpeg2k.t1"):
            planes = _tier1(plan, tile, pdec, tdata, stage, num_threads)
        if plan.pixels == "host":
            _host_pixels(plan, tile, planes, out, num_threads)
        elif plan.pixels == "device_tile":
            # every component's subbands stacked, one upload, IDWT + MCT +
            # shift on the device; the image stays there
            tcx0, tcy0 = tile.comp_rects[0][:2]
            return _DeviceJob(stage, device, plan.cp, plan.siz.ncomp,
                              plan.depth, tile.comp_dims[0], (tcy0, tcx0))
        else:
            seen.add(tidx)
    siz = plan.siz
    if seen:
        # leading axis T*C through one IDWT; assembled on the device, a
        # missing tile's zero subbands replaced by zero samples there
        return _DeviceJob(stage, device, plan.cp, siz.ncomp, plan.depth,
                          (siz.tile_h, siz.tile_w), (0, 0),
                          (siz.tiles_y, siz.tiles_x),
                          tuple(sorted(set(range(siz.tiles_x * siz.tiles_y))
                                       - seen)))
    # (a stream without any of its tile-parts ends here like the host
    # path's: the zero image)
    return _host_image(plan, out if out is not None else _host_output(plan),
                       planar)
