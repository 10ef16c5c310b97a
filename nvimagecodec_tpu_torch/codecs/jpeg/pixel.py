"""JPEG pixel stage on tensors: dequant+IDCT → upsample → colour convert.

The torch counterpart of nvimagecodec_tpu/codecs/jpeg/pixel.py (:42-219).
The float IDCT is K1 (ops/kernels.py), which launches the CUDA kernel for a
CUDA tensor; `bitexact` takes the integer islow IDCT instead. Every stage is
batch-agnostic: coefficient stacks are [..., bh, bw, K] and planes
[..., H, W].
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...ops import color as color_ops
from ...ops import resample as resample_ops
from ...ops.dct import idct_islow_blocks
from ...ops.kernels import (  # noqa: F401
    ZIGZAG_NAT,
    dequant_idct_blocks,
    idct_matrix,
    to_natural,
)
from .headers import JpegFrame

GeomKey = Tuple


def geometry_key(frame: JpegFrame) -> GeomKey:
    """Everything a bucket's pixel stage depends on. Memoized on the frame
    object — batch bucketing and routing call this per sample."""
    k = getattr(frame, "_geom_key", None)
    if k is None:
        comps = tuple(
            (c.h, c.v, np.asarray(frame.quant[c.tq]).tobytes())
            for c in frame.components
        )
        k = (frame.width, frame.height, frame.precision, comps,
             frame.adobe_transform)
        frame._geom_key = k
    return k


def planes_from_blocks(blocks: torch.Tensor, bh: int, bw: int):
    """[..., bh*bw, 64] → [..., bh*8, bw*8]."""
    lead = blocks.shape[:-2]
    x = blocks.reshape(*lead, bh, bw, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, bh * 8, bw * 8)


def idct_planes(frame, coefs: List[torch.Tensor], zigzag: bool = False,
                bitexact: bool = False) -> List[torch.Tensor]:
    """Per-component dequant+IDCT to cropped int32 sample planes:
    coefs[c] [..., bh, bw, K] → plane [..., ch, cw]. zigzag=True means the
    last axis is in zigzag order (K may then be a prefix)."""
    H, W = frame.height, frame.width
    hmax, vmax = frame.hmax, frame.vmax
    planes = []
    for c, blocks in zip(frame.components, coefs):
        bh, bw, K = blocks.shape[-3:]
        lead = blocks.shape[:-3]
        if bitexact:
            nat = to_natural(blocks, zigzag).reshape(*lead, bh * bw, 64)
            samp = idct_islow_blocks(nat, frame.quant[c.tq], frame.precision)
        else:
            M = idct_matrix(frame.quant[c.tq], blocks.device)
            flat = blocks.reshape(-1, bh, bw, K).contiguous()
            samp = dequant_idct_blocks(flat, M, frame.precision, zigzag)
            samp = samp.reshape(*lead, bh * bw, 64)
        plane = planes_from_blocks(samp, bh, bw)
        # crop to the component's true sample area before upsampling so the
        # replicated-edge math sees real edge samples
        cw = (W * c.h + hmax - 1) // hmax
        ch = (H * c.v + vmax - 1) // vmax
        planes.append(plane[..., :ch, :cw])
    return planes


def assemble_image_i32(frame, planes: List[torch.Tensor],
                       fancy: bool = True) -> torch.Tensor:
    """Upsample chroma + colour-convert cropped planes → int32 image
    [..., H, W] or [..., H, W, C] clipped to the sample range."""
    H, W = frame.height, frame.width
    hmax, vmax = frame.hmax, frame.vmax
    maxval = (1 << frame.precision) - 1
    full = []
    for c, plane in zip(frame.components, planes):
        p = resample_ops.upsample_to(plane, vmax // c.v, hmax // c.h,
                                     fancy=fancy)
        full.append(p[..., :H, :W].to(torch.int32))
    n = len(full)
    if n == 1:
        return full[0].clamp(0, maxval)
    if n == 3:
        return torch.stack(
            color_ops.ycbcr_to_rgb_i32(*full, maxval=maxval), dim=-1)
    if n == 4:
        # Adobe CMYK (transform=0) or YCCK (transform=2)
        if frame.adobe_transform == 2:
            full = color_ops.ycck_to_cmyk_i32(*full)
        return torch.stack([v.clamp(0, maxval) for v in full], dim=-1)
    raise ValueError(f"unsupported component count {n}")


def assemble_image(frame, planes: List[torch.Tensor],
                   fancy: bool = True) -> torch.Tensor:
    """As `assemble_image_i32`, in uint8 (uint16 above 8-bit precision)."""
    img = assemble_image_i32(frame, planes, fancy)
    return img.to(torch.uint8 if frame.precision <= 8 else torch.uint16)


def decode_pixels(frame, coefs: List[torch.Tensor], fancy: bool = True,
                  zigzag: bool = False, bitexact: bool = False):
    """coefs[c]: [..., bh, bw, K] int16 → image [..., H, W(, C)]."""
    planes = idct_planes(frame, coefs, zigzag=zigzag, bitexact=bitexact)
    return assemble_image(frame, planes, fancy)


def cmyk_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """[..., 4] CMYK → [..., 3] uint8 RGB."""
    return cmyk_to_rgb_i32(img).to(torch.uint8)


def cmyk_to_rgb_i32(img: torch.Tensor) -> torch.Tensor:
    rgb = color_ops.cmyk_to_rgb_i32(*(img[..., i] for i in range(4)))
    return torch.stack(rgb, dim=-1)


def finish_image(frame, img_i32: torch.Tensor, to_rgb: bool,
                 to_u8: bool) -> torch.Tensor:
    """The batch path's tail on an int32 image: CMYK → RGB unless the caller
    keeps native channels, and >8-bit samples shifted down to uint8 unless
    any depth is allowed. Same results as the reference's uint8/uint16
    steps (`batch.py` :231-234)."""
    img = img_i32
    narrow = frame.precision <= 8
    if to_rgb and img.dim() >= 3 and img.shape[-1] == 4:
        img = cmyk_to_rgb_i32(img) & 0xFF  # the reference casts to uint8
        narrow = True
    if to_u8 and frame.precision > 8:
        img = img >> (frame.precision - 8)
        narrow = True
    return img.to(torch.uint8 if narrow else torch.uint16)
