"""8x8 DCT matrices (numpy) and the integer-exact islow IDCT on tensors.

The port's counterpart of nvimagecodec_tpu/ops/dct.py. The float path folds
dequantization and the 2-D IDCT into one [64, 64] matrix per quant table
(`dequant_idct_matrix`, which K1 multiplies by; `quant_dct_matrix` is the
forward counterpart the host JPEG encoder uses): these are the JAX package's
numpy functions, copied, so both packages compute from identical matrices.
`idct_islow_blocks` is the `bitexact` mode: libjpeg's fixed-point
Loeffler-Ligtenberg-Moshovitz IDCT with 13-bit constants and two-pass
descaling on int32 tensors, so decodes match libjpeg-turbo's islow byte for
byte.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct1d_basis() -> np.ndarray:
    """C[k, x] = c(k)/2 * cos((2x+1) k pi / 16); IDCT: s = C^T S."""
    k = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return (0.5 * c * np.cos((2 * x + 1) * k * np.pi / 16.0))


@functools.lru_cache(maxsize=None)
def idct_matrix_64() -> np.ndarray:
    """M such that vec(pixels) = M @ vec(coefs), both row-major 64-vectors.

    pixels = C^T @ S @ C  →  M = kron(C^T, C^T).
    """
    C = _dct1d_basis()
    return np.kron(C.T, C.T)  # float64 [64, 64]


@functools.lru_cache(maxsize=None)
def dct_matrix_64() -> np.ndarray:
    """Forward: vec(S) = D @ vec(pixels); D = kron(C, C)."""
    C = _dct1d_basis()
    return np.kron(C, C)


def dequant_idct_matrix(quant_natural: np.ndarray) -> np.ndarray:
    """Fold per-coefficient dequantization into the IDCT matrix:
    pixels = M @ (q * coef) = (M * q[None, :]) @ coef."""
    M = idct_matrix_64()
    return (M * quant_natural.astype(np.float64)[None, :]).astype(np.float32)


def quant_dct_matrix(quant_natural: np.ndarray) -> np.ndarray:
    """Forward DCT with quantization folded: coef_q ≈ (D / q[:, None]) @ pixels
    (caller rounds)."""
    D = dct_matrix_64()
    return (D / quant_natural.astype(np.float64)[:, None]).astype(np.float32)


_CONST_BITS = 13
_PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _islow_1d(d, shift_out: int):
    """One 8-point fixed-point inverse transform over axis -1 of d
    ([..., 8] int32/int64 stacks given as a tuple of 8 arrays). Returns a
    tuple of 8 output arrays, descaled by `shift_out` with round-half-up."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d

    z1 = (d2 + d6) * _F_0_541196100
    tmp2 = z1 - d6 * _F_1_847759065
    tmp3 = z1 + d2 * _F_0_765366865
    tmp0 = (d0 + d4) << _CONST_BITS
    tmp1 = (d0 - d4) << _CONST_BITS
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    t0, t1, t2, t3 = d7, d5, d3, d1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _F_1_175875602
    t0 = t0 * _F_0_298631336
    t1 = t1 * _F_2_053119869
    t2 = t2 * _F_3_072711026
    t3 = t3 * _F_1_501321110
    z1 = -z1 * _F_0_899976223
    z2 = -z2 * _F_2_562915447
    z3 = -z3 * _F_1_961570560 + z5
    z4 = -z4 * _F_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift_out - 1)
    ds = lambda x: (x + half) >> shift_out
    return (
        ds(tmp10 + t3), ds(tmp11 + t2), ds(tmp12 + t1), ds(tmp13 + t0),
        ds(tmp13 - t0), ds(tmp12 - t1), ds(tmp11 - t2), ds(tmp10 - t3),
    )


def idct_islow_blocks(coefs: torch.Tensor, quant_natural,
                      precision: int = 8) -> torch.Tensor:
    """Dequantize + integer IDCT: [..., 64] natural-order coefficients →
    [..., 64] clipped int32 samples."""
    q = torch.from_numpy(np.asarray(quant_natural, np.int32).reshape(64))
    x = (coefs.to(torch.int32) * q.to(coefs.device)).reshape(
        coefs.shape[:-1] + (8, 8))
    # the butterfly is pure +, -, *, << and >>, which torch int32 tensors
    # carry out with the same wrap and arithmetic shifts as numpy's
    cols = _islow_1d(tuple(x[..., u, :] for u in range(8)),
                     _CONST_BITS - _PASS1_BITS)
    y = torch.stack(cols, dim=-2)
    rows = _islow_1d(tuple(y[..., v] for v in range(8)),
                     _CONST_BITS + _PASS1_BITS + 3)
    out = torch.stack(rows, dim=-1)
    center = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    return (out + center).clamp(0, maxval).reshape(coefs.shape[:-1] + (64,))
