"""The work of the J2K device pixel stage (inverse 5/3, inverse RCT, level
shift and the cast to uint8), counted from the images the corpus made, as
work.py counts the JPEG kernels': each sample's int32 subband coefficient
read once and its uint8 sample written once, 5 bytes a sample. Its lifting
is a few adds a sample, so the stage is held by bytes; the least time is
those bytes over the card's memory rate (work.peaks).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from benchmark import work

SUBBAND_BYTES = 4  # int32
SAMPLE_BYTES = 1   # uint8


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
