"""The 8x8 block products of the JPEG pixel stages.

K1 `dequant_idct_blocks` (decode) replaces the Pallas kernel of
nvimagecodec_tpu/ops/pallas_kernels.py (`_build_idct_blocks_fn`). A CUDA
tensor goes to the hand-written kernel in csrc/idct.cu; a CPU tensor goes to
`dequant_idct_blocks_plain`, the same function in plain PyTorch. Either way
the sum runs over natural coefficient order, so zigzag and natural input of
the same block give the same pixels.

`fdct_quant_blocks` (encode) is the fDCT+quant product that the JAX package
leaves to XLA (nvimagecodec_tpu/codecs/jpeg/encode.py:187): a CUDA tensor
goes to csrc/fdct.cu, which sums every coefficient in one fixed order, so a
block's coefficients do not depend on the batch around it; a CPU tensor goes
to `fdct_quant_blocks_plain` (`torch.matmul`), whose coefficients equal the
JAX package's numpy path.

Each launch runs under `torch.cuda.device` of its tensors: the C entry
points launch on the CUDA runtime's current device, which need not be the
tensors' (a shard on `cuda:1`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .dct import dequant_idct_matrix

# zigzag index -> natural position (ITU-T T.81 figure A.6)
ZIGZAG_NAT = np.array([
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)
# natural position n -> zigzag index
ZZ_OF_NAT = np.argsort(ZIGZAG_NAT).astype(np.int64)


def to_natural(blocks: torch.Tensor, zigzag: bool) -> torch.Tensor:
    """[..., K] coefficients → [..., 64] in natural order. Zigzag input may
    be a truncated prefix (K < 64); natural input must be whole."""
    K = blocks.shape[-1]
    if not zigzag:
        if K != 64:
            raise ValueError("truncated coefficients require zigzag order")
        return blocks
    if K != 64:
        pad = blocks.new_zeros(blocks.shape[:-1] + (64 - K,))
        blocks = torch.cat([blocks, pad], dim=-1)
    idx = torch.from_numpy(ZZ_OF_NAT).to(blocks.device)
    return blocks.index_select(-1, idx)


@functools.lru_cache(maxsize=64)
def _matrix(quant_bytes: bytes, device: torch.device) -> torch.Tensor:
    quant = np.frombuffer(quant_bytes, np.int32).reshape(64)
    return torch.from_numpy(dequant_idct_matrix(quant)).to(device)


def idct_matrix(quant: np.ndarray, device) -> torch.Tensor:
    """K1's matrix: the dequant-folded IDCT matrix (`dequant_idct_matrix`)
    [64 pixels, 64 natural coefficients] float32 on `device`. Kept per
    table and device, so a pixel stage uploads (and waits for) no copy of
    a table it has seen; callers must not write to it."""
    q = np.ascontiguousarray(np.asarray(quant, np.int32).reshape(64))
    return _matrix(q.tobytes(), torch.device(device))


def dequant_idct_blocks_plain(coefs: torch.Tensor, M: torch.Tensor,
                              precision: int = 8,
                              zigzag: bool = False) -> torch.Tensor:
    """[..., K] int16 → [..., 64] int32 clipped samples, plain PyTorch."""
    maxval = (1 << precision) - 1
    center = float(1 << (precision - 1))
    nat = to_natural(coefs, zigzag).to(torch.float32)
    samp = nat @ M.T + center
    return samp.round().clamp(0, maxval).to(torch.int32)


def dequant_idct_blocks(coefs: torch.Tensor, M: torch.Tensor,
                        precision: int = 8,
                        zigzag: bool = False) -> torch.Tensor:
    """[B, bh, bw, K] int16 → [B, bh, bw, 64] int32 clipped samples.

    M is `idct_matrix(quant)`. K is 64 for natural order, or a zigzag prefix
    length. A CPU tensor takes the plain version; a CUDA tensor launches K1
    (csrc/idct.cu) or raises."""
    if coefs.device.type == "cpu":
        return dequant_idct_blocks_plain(coefs, M, precision, zigzag)
    if coefs.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {coefs.device}")
    K = coefs.shape[-1]
    if coefs.dtype != torch.int16 or not coefs.is_contiguous():
        raise ValueError("K1: coefficients must be contiguous int16")
    if not (1 <= K <= 64) or (not zigzag and K != 64):
        raise ValueError(f"K1: bad coefficient count {K}")
    if (M.dtype != torch.float32 or tuple(M.shape) != (64, 64)
            or M.device != coefs.device or not M.is_contiguous()):
        raise ValueError("K1: M must be contiguous float32 [64, 64] on the "
                         "coefficients' device")
    out = torch.empty(coefs.shape[:-1] + (64,), dtype=torch.int32,
                      device=coefs.device)
    nblocks = coefs.numel() // K
    with torch.cuda.device(coefs.device):
        stream = torch.cuda.current_stream(coefs.device).cuda_stream
        rc = _build.lib().tic_idct_blocks(
            coefs.data_ptr(), K, int(zigzag), M.data_ptr(), out.data_ptr(),
            nblocks, float(1 << (precision - 1)), (1 << precision) - 1,
            stream)
    _build.check(rc, "K1 idct launch")
    _build.count_launch(dequant_idct_blocks)
    return out


dequant_idct_blocks.launches = 0


def fdct_quant_blocks_plain(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[..., 64] float32 centred samples → [..., 64] int32 quantised
    coefficients, plain PyTorch: `x @ M.T`, rounded half away from zero."""
    coef = torch.matmul(x, M.T)
    return (torch.sign(coef) * torch.floor(coef.abs() + 0.5)).to(torch.int32)


def fdct_quant_blocks(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[..., 64] float32 centred samples (natural order) → [..., 64] int32
    coefficients `sign(c) * floor(|c| + 0.5)` of c = x @ M.T.

    M is `encode.quant_matrix(quant)` [64 coefficients, 64 pixels]. A CPU
    tensor takes the plain version; a CUDA tensor launches csrc/fdct.cu or
    raises. On the card every coefficient is summed over its 64 samples in
    one fixed order, so it depends on its block alone; it stays within 1 of
    the plain version on fewer than 1% of entries."""
    if x.device.type == "cpu":
        return fdct_quant_blocks_plain(x, M)
    if x.device.type != "cuda":
        raise ValueError(f"fdct_quant_blocks: unsupported device {x.device}")
    if (x.dtype != torch.float32 or x.shape[-1] != 64
            or not x.is_contiguous()):
        raise ValueError("fdct_quant_blocks: samples must be contiguous "
                         "float32 [..., 64]")
    if (M.dtype != torch.float32 or tuple(M.shape) != (64, 64)
            or M.device != x.device or not M.is_contiguous()):
        raise ValueError("fdct_quant_blocks: M must be contiguous float32 "
                         "[64, 64] on the samples' device")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.lib().tic_fdct_quant_blocks(
            x.data_ptr(), M.data_ptr(), out.data_ptr(), x.numel() // 64,
            stream)
    _build.check(rc, "fdct_quant_blocks launch")
    _build.count_launch(fdct_quant_blocks)
    return out


fdct_quant_blocks.launches = 0
