"""Check "decode_pixels": the decoded RGB images against the plain
reference decoder (reference/jpeg.py) on the same streams.

The reference gives, sample by sample, every value a float32 decode may
give (`jpeg.decode_bounds`: where the exact IDCT output lies within float32
rounding of a rounding boundary, both neighbours are right). The number
compared is exact:
- `samples_outside`: samples of the judged images outside those bounds,
  every sample of an image that is missing or of another shape counted;
  limit 0.

The control is the reference with its IDCT product in TF32, put in the
program's place.
"""
from __future__ import annotations

import numpy as np

from ..reference import jpeg

NUMBERS = ("samples_outside",)


def bounds(streams, k: int, cache: dict):
    if k not in cache:
        frame = jpeg.parse(streams[k])
        cache[k] = jpeg.decode_bounds(frame, jpeg.entropy_decode(frame))
    return cache[k]


def control_output(streams, k: int, traffic: dict):
    """What the reference gives in the program's place, in TF32."""
    return jpeg.decode(streams[k], precision="tf32")


def judge(samples, streams, traffic: dict) -> dict:
    """samples: [(stream index, uint8 image)] -> the numbers compared."""
    cache: dict = {}
    outside = 0
    for k, got in samples:
        lo, hi = bounds(streams, k, cache)
        got = None if got is None else np.asarray(got)
        if got is None or got.shape != lo.shape:
            outside += lo.size
            continue
        outside += int(((got < lo) | (got > hi)).sum())
    return {"samples_outside": outside}
