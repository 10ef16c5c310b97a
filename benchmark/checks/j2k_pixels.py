"""Check "j2k_pixels": each judged image of a lossless J2K cell against
the pixels its codestream was made from (j2k_streams.source_pixels of the
pool's JPEG stream, the helper the entry converts with). A lossless
decode's answer is exact, so the numbers compared are exact:
- `samples_outside`: samples of the judged images that differ from the
  source, every sample of an image that is missing or of another shape or
  type counted; limit 0;
- `off_device`: judged images of a CUDA run that are not on the card (a
  host route's output); limit 0.

The control is the plain reference's 5/3 synthesis and inverse RCT
(reference/j2k.py) computed in bfloat16, the nearest precision below the
configuration's at which the arithmetic stops being exact (float32 and
float16 hold every integer of these subbands), on the subbands of the
source pixels, put in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import j2k_streams
from ..reference import j2k

NUMBERS = ("samples_outside", "off_device")


def control_output(streams, k: int, traffic: dict) -> np.ndarray:
    """What the reference gives in the program's place, in bfloat16."""
    px = j2k_streams.source_pixels(streams[k])
    LL, bands = j2k.analyse_image(px, j2k_streams.LEVELS)
    return j2k.synthesise_image(LL, bands, dtype=torch.bfloat16)


def judge(samples, streams, traffic: dict) -> dict:
    """samples: [(stream index, (uint8 image, off the card) or an image)]
    -> the numbers compared."""
    cache: dict = {}
    outside = off = 0
    for k, got in samples:
        if k not in cache:
            cache[k] = j2k_streams.source_pixels(streams[k])
        want = cache[k]
        if isinstance(got, tuple):
            got, moved = got
            off += bool(moved)
        got = None if got is None else np.asarray(got)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            outside += want.size
            continue
        outside += int((got != want).sum())
    return {"samples_outside": outside, "off_device": off}
