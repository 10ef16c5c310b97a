"""JPEG encoder, host path: pixel stage + Huffman entropy stage.

Counterpart of the reference's nvjpeg CUDA encoder
(reference: extensions/nvjpeg/cuda_encoder.cpp:284-436 — quality 1-100,
chroma subsampling select, optimized-Huffman option; python defaults
quality=95 / 4:4:4 per python/encode_params.cpp:31,53-56).

Split mirrors the decoder's hybrid design: the pixel half (RGB→YCbCr,
chroma downsample, level shift, fDCT+quantize) is batched linear algebra —
the fDCT of every 8x8 block folds with quantization into one [64,64] matrix,
so a whole image is a single [N,64]x[64,64] matmul. The entropy half
(Huffman coding) is bit-serial host work: native C++ when built, Python
reference fallback.

The port of nvimagecodec_tpu/codecs/jpeg/encode.py. `encode_pixels` is the
one pixel stage of both encoders, in torch: the host encoder (`encode_jpeg`)
runs it on CPU tensors and gives the JAX package's host encoder's bytes, the
batched encoder (codecs/jpeg/batch_encode.py) runs it on a whole bucket on
the device. Colour conversion and downsampling are the port's integer-exact
ops; the fDCT+quant product is `ops.kernels.fdct_quant_blocks`: on the CPU
its plain version (`torch.matmul` in float32, as the JAX package computes it
outside any kernel), on a CUDA device the hand-written csrc/fdct.cu, whose
fixed summation order makes a block's coefficients independent of the batch.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.interfaces import EncodeParams, JpegEncodeParams
from ...core.types import ChromaSubsampling
from ...ops import color as color_ops
from ...ops import resample as resample_ops
from ...ops.convert import widen_uint16
from ...ops.dct import quant_dct_matrix
from ...ops.kernels import fdct_quant_blocks
from .headers import Component, HuffTable, JpegFrame
from .tables import (
    STD_AC_CHROMA,
    STD_AC_LUMA,
    STD_CHROMA_QUANT,
    STD_DC_CHROMA,
    STD_DC_LUMA,
    STD_LUMA_QUANT,
    ZIGZAG,
    quality_scaled_quant,
)

# chroma subsampling → (h, v) sampling factors of the luma component
_CSS_FACTORS = {
    ChromaSubsampling.CSS_444: (1, 1),
    ChromaSubsampling.CSS_422: (2, 1),
    ChromaSubsampling.CSS_420: (2, 2),
    ChromaSubsampling.CSS_440: (1, 2),
    ChromaSubsampling.CSS_411: (4, 1),
    ChromaSubsampling.CSS_410: (4, 2),
}

_CSS_NAMES = {
    "444": ChromaSubsampling.CSS_444,
    "422": ChromaSubsampling.CSS_422,
    "420": ChromaSubsampling.CSS_420,
    "440": ChromaSubsampling.CSS_440,
    "411": ChromaSubsampling.CSS_411,
    "410": ChromaSubsampling.CSS_410,
    "gray": ChromaSubsampling.GRAY,
}


def _resolve_css(params: EncodeParams, nchan: int) -> ChromaSubsampling:
    if nchan == 1:
        return ChromaSubsampling.GRAY
    css = params.chroma_subsampling
    if css is None:
        return ChromaSubsampling.CSS_444  # reference default
    if isinstance(css, str):
        return _CSS_NAMES[css.lower()]
    return ChromaSubsampling(css)


def build_encode_frame(
    height: int, width: int, nchan: int, quality: float,
    css: ChromaSubsampling, precision: int = 8,
) -> JpegFrame:
    """Frame description for a baseline/extended encode (SOF0/SOF1, JFIF
    component ids). precision 12 scales quant tables into 12-bit sample
    units (libjpeg convention)."""
    scale = 1 << (precision - 8)
    qy = quality_scaled_quant(STD_LUMA_QUANT, quality) * scale
    if nchan == 1 or css == ChromaSubsampling.GRAY:
        comps = [Component(1, 1, 1, 0)]
        quant = {0: qy}
    else:
        h, v = _CSS_FACTORS[css]
        comps = [
            Component(1, h, v, 0),
            Component(2, 1, 1, 1),
            Component(3, 1, 1, 1),
        ]
        quant = {0: qy, 1: quality_scaled_quant(STD_CHROMA_QUANT, quality) * scale}
    frame = JpegFrame(0xC0 if precision == 8 else 0xC1, precision,
                      height, width, comps)
    frame.quant = quant
    return frame


def _pad_to(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate pad [..., h, w] → [..., ph, pw] (libjpeg edge expand)."""
    h, w = plane.shape[-2], plane.shape[-1]
    if ph > h:
        pad = plane[..., -1:, :].repeat_interleave(ph - h, dim=-2)
        plane = torch.cat([plane, pad], dim=-2)
    if pw > w:
        pad = plane[..., -1:].repeat_interleave(pw - w, dim=-1)
        plane = torch.cat([plane, pad], dim=-1)
    return plane


@functools.lru_cache(maxsize=64)
def _quant_matrix(quant_bytes: bytes, device: torch.device) -> torch.Tensor:
    quant = np.frombuffer(quant_bytes, np.int32).reshape(64)
    return torch.from_numpy(quant_dct_matrix(quant)).to(device)


def quant_matrix(quant: np.ndarray, device) -> torch.Tensor:
    """`quant_dct_matrix(quant)` [64 coefficients, 64 pixels] float32 on
    `device`, kept per table and device as K1's matrix is; callers must not
    write to it."""
    q = np.ascontiguousarray(np.asarray(quant, np.int32).reshape(64))
    return _quant_matrix(q.tobytes(), torch.device(device))


def _samples_i32(img, device) -> torch.Tensor:
    """An image (numpy array or tensor, uint8 or uint16) as an int32 tensor
    on `device` (its own device when None)."""
    if isinstance(img, torch.Tensor):
        img = widen_uint16(img).to(torch.int32)
    else:
        img = torch.from_numpy(np.asarray(img).astype(np.int32))
    return img if device is None else img.to(device)


def encode_pixels(img, frame: JpegFrame, device=None) -> List[torch.Tensor]:
    """uint8/uint16 image [..., H, W] or [..., H, W, C] (numpy array or
    tensor) → per-component quantized coefficient blocks [..., bh, bw, 64]
    int32 (natural order), tensors on `device` (a tensor's own device, the
    CPU for an array, when None).

    Colour convert + downsample are elementwise/strided int ops, fDCT+quant
    is one [N,64]x[64,64] float32 product per component via quant_dct_matrix
    (ops/dct.py), quantised by rounding half away from zero
    (`fdct_quant_blocks`). On the CPU the coefficients equal the JAX
    package's numpy path; on a CUDA device they stay within 1 of it on fewer
    than 1% of entries, and a block's coefficients do not depend on the
    other blocks of the call.
    """
    hmax, vmax = frame.hmax, frame.vmax
    img = _samples_i32(img, device)

    # --- color convert ----------------------------------------------------
    maxval = (1 << frame.precision) - 1
    if len(frame.components) == 1:
        if img.dim() >= 3 and img.shape[-1] == 3:
            y, _, _ = color_ops.rgb_to_ycbcr_i32(
                img[..., 0], img[..., 1], img[..., 2], maxval=maxval
            )
            planes = [y]
        else:
            if img.dim() >= 3 and img.shape[-1] == 1:
                img = img[..., 0]
            planes = [img]
    else:
        y, cb, cr = color_ops.rgb_to_ycbcr_i32(
            img[..., 0], img[..., 1], img[..., 2], maxval=maxval
        )
        planes = [y, cb, cr]

    # --- downsample chroma (libjpeg-exact bias, ops/resample.py) ----------
    down = []
    for c, p in zip(frame.components, planes):
        hf, vf = hmax // c.h, vmax // c.v
        if hf == 2 and vf == 2:
            p = resample_ops.downsample_h2v2(_pad_to(p, -(-p.shape[-2] // 2) * 2,
                                                     -(-p.shape[-1] // 2) * 2))
        elif hf == 2 and vf == 1:
            p = resample_ops.downsample_h2v1(_pad_to(p, p.shape[-2],
                                                     -(-p.shape[-1] // 2) * 2))
        elif hf == 1 and vf == 2:
            p = resample_ops.downsample_v2(_pad_to(p, -(-p.shape[-2] // 2) * 2,
                                                   p.shape[-1]))
        elif hf == 1 and vf == 1:
            pass
        else:  # generic box average (4:1:1 etc.)
            ph = -(-p.shape[-2] // vf) * vf
            pw = -(-p.shape[-1] // hf) * hf
            p = _pad_to(p, ph, pw)
            lead = p.shape[:-2]
            p = p.reshape(*lead, ph // vf, vf, pw // hf, hf).sum((-3, -1))
            p = (p + (vf * hf) // 2) // (vf * hf)
        down.append(p)

    # --- pad to MCU-covering block grid, fDCT+quant -----------------------
    mcus_x, mcus_y, dims = frame.mcu_geometry()
    center = float(1 << (frame.precision - 1))
    out = []
    for c, p, (bw, bh) in zip(frame.components, down, dims):
        p = _pad_to(p, bh * 8, bw * 8).to(torch.float32) - center
        lead = p.shape[:-2]
        # [..., bh*8, bw*8] → [..., bh*bw, 64]
        x = p.reshape(*lead, bh, 8, bw, 8).transpose(-3, -2)
        x = x.reshape(*lead, bh * bw, 64)
        M = quant_matrix(frame.quant[c.tq], x.device)  # [64 coef, 64 pix]
        # rounded half away from zero (symmetric quantizer)
        q = fdct_quant_blocks(x.contiguous(), M)
        out.append(q.reshape(*lead, bh, bw, 64))
    return out


# --------------------------------------------------------------------------
# Huffman entropy stage (host)
# --------------------------------------------------------------------------

def derive_encode_table(tbl: HuffTable) -> Tuple[np.ndarray, np.ndarray]:
    """(code, size) per symbol value — T.81 C.2 canonical code assignment."""
    ehufco = np.zeros(256, np.uint32)
    ehufsi = np.zeros(256, np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(tbl.bits[length - 1]):
            ehufco[tbl.values[k]] = code
            ehufsi[tbl.values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return ehufco, ehufsi


class BitWriter:
    """MSB-first bit accumulator with 0xFF byte stuffing (T.81 B.1.1.5)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, size: int) -> None:
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.nbits += size
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)

    def flush(self) -> None:
        """Pad with 1-bits to a byte boundary (T.81 B.1.1.5; a padded 0xFF
        still gets byte-stuffed by put)."""
        while self.nbits % 8:
            self.put(1, 1)


def _csize(v: int) -> int:
    """Bit category of a coefficient value (T.81 F.1.2.1.1)."""
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def mcu_block_order(frame: JpegFrame) -> List[Tuple[int, int]]:
    """Interleaved scan order: [(comp_idx, block_flat_idx)] for one pass over
    all MCUs; block_flat_idx indexes [bh, bw] row-major per component."""
    mcus_x, mcus_y, dims = frame.mcu_geometry()
    order = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            for ci, c in enumerate(frame.components):
                bw = dims[ci][0]
                for v in range(c.v):
                    for h in range(c.h):
                        by = my * c.v + v
                        bx = mx * c.h + h
                        order.append((ci, by * bw + bx))
    return order


def entropy_encode_py(
    frame: JpegFrame,
    coefs: Sequence[np.ndarray],
    dc_tables: Dict[int, HuffTable],
    ac_tables: Dict[int, HuffTable],
    restart_interval: int = 0,
) -> bytes:
    """Baseline sequential interleaved scan (T.81 F.1.2). coefs[c]: [bh,bw,64]
    natural order."""
    ncomp = len(frame.components)
    zz = [np.ascontiguousarray(c.reshape(-1, 64)[:, ZIGZAG]) for c in coefs]
    enc_dc = {i: derive_encode_table(t) for i, t in dc_tables.items()}
    enc_ac = {i: derive_encode_table(t) for i, t in ac_tables.items()}

    w = BitWriter()
    pred = [0] * ncomp
    order = mcu_block_order(frame)
    mcus_total = len(order) // sum(c.h * c.v for c in frame.components)
    blocks_per_mcu = len(order) // mcus_total

    rst = 0
    for m in range(mcus_total):
        if restart_interval and m and m % restart_interval == 0:
            w.flush()
            w.out.append(0xFF)
            w.out.append(0xD0 + (rst & 7))
            rst += 1
            pred = [0] * ncomp
        for ci, bidx in order[m * blocks_per_mcu : (m + 1) * blocks_per_mcu]:
            comp = frame.components[ci]
            dco, dsi = enc_dc[comp.dc_tbl]
            aco, asi = enc_ac[comp.ac_tbl]
            block = zz[ci][bidx]
            # DC
            diff = int(block[0]) - pred[ci]
            pred[ci] = int(block[0])
            s = _csize(diff)
            w.put(int(dco[s]), int(dsi[s]))
            if s:
                w.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
            # AC
            run = 0
            for k in range(1, 64):
                v = int(block[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    w.put(int(aco[0xF0]), int(asi[0xF0]))  # ZRL
                    run -= 16
                s = _csize(v)
                sym = (run << 4) | s
                w.put(int(aco[sym]), int(asi[sym]))
                w.put(v if v >= 0 else v + (1 << s) - 1, s)
                run = 0
            if run:
                w.put(int(aco[0x00]), int(asi[0x00]))  # EOB
    w.flush()
    return bytes(w.out)


def count_symbols(frame: JpegFrame, coefs: Sequence[np.ndarray]):
    """Symbol frequencies for optimized-Huffman table generation. Returns
    ({class: dc_counts[256]}, {class: ac_counts[256]}) with class = table id
    (0 luma, 1 chroma)."""
    dc_counts: Dict[int, np.ndarray] = {}
    ac_counts: Dict[int, np.ndarray] = {}
    order = mcu_block_order(frame)
    zz = [np.ascontiguousarray(c.reshape(-1, 64)[:, ZIGZAG]) for c in coefs]
    pred = [0] * len(frame.components)
    for ci, bidx in order:
        comp = frame.components[ci]
        dcc = dc_counts.setdefault(comp.dc_tbl, np.zeros(256, np.int64))
        acc = ac_counts.setdefault(comp.ac_tbl, np.zeros(256, np.int64))
        block = zz[ci][bidx]
        diff = int(block[0]) - pred[ci]
        pred[ci] = int(block[0])
        dcc[_csize(diff)] += 1
        run = 0
        for k in range(1, 64):
            v = int(block[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                acc[0xF0] += 1
                run -= 16
            acc[(run << 4) | _csize(v)] += 1
            run = 0
        if run:
            acc[0x00] += 1
    return dc_counts, ac_counts


def gen_optimal_table(freq_in: np.ndarray) -> HuffTable:
    """Length-limited canonical Huffman table from symbol frequencies —
    T.81 Annex K.2 algorithm (the same one libjpeg jchuff.c uses): merge the
    two least-frequent symbols repeatedly tracking code sizes, then push
    sizes > 16 back up the tree."""
    freq = freq_in.astype(np.int64).copy()
    freq = np.append(freq, 1)  # reserved pseudo-symbol ensures no all-ones code
    codesize = np.zeros(257, np.int64)
    others = np.full(257, -1, np.int64)

    while True:
        nz = np.nonzero(freq)[0]
        if len(nz) <= 1:
            break
        # two least-frequent (ties: higher symbol value first, like libjpeg)
        c1 = nz[np.lexsort((-nz, freq[nz]))[0]]
        nz2 = nz[nz != c1]
        c2 = nz2[np.lexsort((-nz2, freq[nz2]))[0]]
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] != -1:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] != -1:
            c2 = others[c2]
            codesize[c2] += 1

    bits = np.zeros(33, np.int64)
    for s in codesize[codesize > 0]:
        bits[min(int(s), 32)] += 1
    # limit code lengths to 16 (K.2 Figure K.3)
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # remove the reserved symbol's code (largest code)
    for i in range(16, 0, -1):
        if bits[i] > 0:
            bits[i] -= 1
            break

    # symbols sorted by (codesize, value) — canonical order
    syms = [
        (int(codesize[v]), v) for v in range(256) if codesize[v] > 0
    ]
    syms.sort()
    return HuffTable(list(bits[1:17].astype(int)), [v for _, v in syms])


# --------------------------------------------------------------------------
# Header writer + top-level encode
# --------------------------------------------------------------------------

def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def write_jpeg(
    frame: JpegFrame,
    entropy: bytes,
    dc_tables: Dict[int, HuffTable],
    ac_tables: Dict[int, HuffTable],
    restart_interval: int = 0,
) -> bytes:
    return (jpeg_header_bytes(frame, dc_tables, ac_tables, restart_interval)
            + entropy + b"\xff\xd9")


def jpeg_header_bytes(
    frame: JpegFrame,
    dc_tables: Dict[int, HuffTable],
    ac_tables: Dict[int, HuffTable],
    restart_interval: int = 0,
) -> bytes:
    """Everything before the entropy-coded data (SOI..SOS) — cacheable per
    (geometry, quality, tables) bucket; the fused native encoder returns the
    scan bytes to append."""
    out = bytearray(b"\xff\xd8")  # SOI
    # APP0 JFIF v1.1, 1:1 aspect
    out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    # DQT (zigzag order on the wire; pq=1 16-bit entries for 12-bit streams)
    for tq, q in sorted(frame.quant.items()):
        zz = np.asarray(q)[ZIGZAG]
        if zz.max() > 255:
            out += _seg(0xDB, bytes([(1 << 4) | tq]) + zz.astype(">u2").tobytes())
        else:
            out += _seg(0xDB, bytes([tq]) + zz.astype(np.uint8).tobytes())
    # SOF0
    sof = bytes([frame.precision]) + frame.height.to_bytes(2, "big") + \
        frame.width.to_bytes(2, "big") + bytes([len(frame.components)])
    for c in frame.components:
        sof += bytes([c.comp_id, (c.h << 4) | c.v, c.tq])
    out += _seg(frame.marker, sof)
    # DHT
    for tc, tables in ((0, dc_tables), (1, ac_tables)):
        for th, t in sorted(tables.items()):
            out += _seg(
                0xC4, bytes([(tc << 4) | th]) + bytes(t.bits) + bytes(t.values)
            )
    if restart_interval:
        out += _seg(0xDD, restart_interval.to_bytes(2, "big"))
    # SOS
    sos = bytes([len(frame.components)])
    for c in frame.components:
        sos += bytes([c.comp_id, (c.dc_tbl << 4) | c.ac_tbl])
    sos += bytes([0, 63, 0])
    out += _seg(0xDA, sos)
    return bytes(out)


def _entropy_encode(frame, coefs, dc_tables, ac_tables, restart_interval=0,
                    setup=None):
    """Native C++ encoder when built, Python fallback. `setup` may carry
    `native_encode.scan_setup` of the frame and tables."""
    try:
        from .native_encode import entropy_encode_native

        return entropy_encode_native(
            frame, coefs, dc_tables, ac_tables, restart_interval, setup
        )
    except Exception:
        return entropy_encode_py(
            frame, coefs, dc_tables, ac_tables, restart_interval
        )


def encode_jpeg(
    img: np.ndarray,
    params: Optional[EncodeParams] = None,
    device=None,
) -> bytes:
    """Encode a uint8 [H,W] / [H,W,1] / [H,W,3] image to baseline JFIF bytes.
    The pixel stage runs on `device` (the CPU when None), the rest here.

    Reference behavior parity: quality + chroma subsampling + optimized
    Huffman per extensions/nvjpeg/cuda_encoder.cpp:284-436.
    """
    params = params or EncodeParams()
    jp = params.jpeg or JpegEncodeParams()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    nchan = 1 if img.ndim == 2 else img.shape[-1]
    H, W = img.shape[:2]
    css = _resolve_css(params, nchan)
    precision = 12 if np.dtype(str(img.dtype)) == np.uint16 else 8
    frame = build_encode_frame(H, W, nchan, params.quality, css, precision)

    coefs = [c.cpu().numpy() for c in encode_pixels(img, frame, device)]

    if jp.progressive:
        from .progressive import encode_jpeg_progressive

        frame.marker = 0xC2
        return encode_jpeg_progressive(frame, coefs)

    # table classes: 0 = luma, 1 = chroma (assigned before counting so the
    # optimized-table pass groups symbols by class)
    for i, c in enumerate(frame.components):
        c.dc_tbl = c.ac_tbl = 0 if i == 0 else 1

    if jp.optimized_huffman:
        try:
            from .native_encode import count_symbols_native

            dc_counts, ac_counts = count_symbols_native(frame, coefs)
        except Exception:
            dc_counts, ac_counts = count_symbols(frame, coefs)
        dc_tables = {i: gen_optimal_table(f) for i, f in dc_counts.items()}
        ac_tables = {i: gen_optimal_table(f) for i, f in ac_counts.items()}
    else:
        # Annex K tables are stored 1-indexed (17 entries, bits[L] = count of
        # length L); HuffTable wants the 16-entry form
        std = lambda t: HuffTable(list(t[0][1:]), list(t[1]))
        dc_tables = {0: std(STD_DC_LUMA)}
        ac_tables = {0: std(STD_AC_LUMA)}
        if len(frame.components) > 1:
            dc_tables[1] = std(STD_DC_CHROMA)
            ac_tables[1] = std(STD_AC_CHROMA)

    entropy = _entropy_encode(frame, coefs, dc_tables, ac_tables)
    return write_jpeg(frame, entropy, dc_tables, ac_tables)
