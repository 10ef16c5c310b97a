"""The work of each kernel, counted from the corpus the benchmark made,
and the card's published peaks.

Counted from what the images are, never from the program's tensors, so a
kernel that changes its layout is still held to the same work:

- blocks: every 8x8 block a frame codes (its MCU grid, T.81 A.2);
- K1 (dequant + IDCT) and the fDCT: 2 * 2 * 8 * 64 = 2,048 operations a
  block (two passes of 8-point products over 8 rows of 8, the least of the
  matrix forms), and one int16 coefficient and one uint8 sample a
  coefficient.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Tuple

OPS_PER_BLOCK = 2 * 2 * 8 * 64
COEF_BYTES = 2     # int16
SAMPLE_BYTES = 1   # uint8

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def blocks(height: int, width: int, subsampling: str = "420") -> int:
    """Blocks a baseline frame codes: whole MCUs, luma h x v blocks an MCU
    and one block of each chroma component (4:2:0), or one of each (4:4:4,
    gray)."""
    if subsampling == "420":
        mcus = (-(-height // 16)) * (-(-width // 16))
        return mcus * 6
    per = 1 if subsampling == "gray" else 3
    return (-(-height // 8)) * (-(-width // 8)) * per


def transform_work(dims: Iterable[Tuple[int, int]], subsampling: str
                   ) -> Tuple[float, float]:
    """(operations, bytes) of an 8x8 transform over every block of frames
    of `dims` [(h, w)]: K1 or the fDCT."""
    n = sum(blocks(h, w, subsampling) for h, w in dims)
    return float(n * OPS_PER_BLOCK), float(n * 64 * (COEF_BYTES
                                                     + SAMPLE_BYTES))


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of a card by its name, or None."""
    with open(_PEAKS) as f:
        table = json.load(f)
    return table.get(device_name)


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: operations over the fp32 rate
    or bytes over the memory rate, whichever is longer."""
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])


def roofline_pct(ops: float, nbytes: float, seconds: float,
                 device_name: str) -> Optional[float]:
    """A kernel's share of its roofline in %, or None without a time or a
    row for the card."""
    peak = peaks(device_name)
    if peak is None or not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes, peak) / seconds
