"""The work of the J2K irreversible device pixel stage (dequantisation,
inverse 9/7, inverse ICT, level shift, rounding and the cast to uint16),
counted from the images the corpus made, as work_j2k.py counts the 5/3
stage's: each sample's int32 subband coefficient (its mid-interval
half-steps) read once and its uint16 sample written once, 6 bytes a
sample. Its lifting is a few multiply-adds a sample, so the stage is held
by bytes; the least time is those bytes over the card's memory rate
(work.peaks).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from benchmark import work

SUBBAND_BYTES = 4  # int32
SAMPLE_BYTES = 2   # uint16


def stage_bytes(dims: Iterable[Tuple[int, int]], components: int) -> float:
    """Bytes the stage moves over images of `dims` [(h, w)]."""
    return float(sum(h * w for h, w in dims) * components
                 * (SUBBAND_BYTES + SAMPLE_BYTES))


def stage_roofline_pct(dims: Iterable[Tuple[int, int]], components: int,
                       seconds: float, device_name: str) -> Optional[float]:
    """The stage's share of its roofline in %: least time over `seconds`
    of its kernels, or None without a time or a row for the card."""
    return work.roofline_pct(0.0, stage_bytes(dims, components), seconds,
                             device_name)
