"""Check "j2k_dci_samples": each judged frame of the digital-cinema cell
against OpenJPEG's own decode of the same codestream at 12 bits
(dci_streams.answer of the pool's JPEG stream: the codestream the entry
decoded, made again, then decoded by libopenjp2). The numbers compared:
- `samples_beyond_one`: samples of the judged frames more than 1 from
  OpenJPEG's, every sample of a frame that is missing or of another shape
  or type counted; limit 0. OpenJPEG and the program both dequantise and
  synthesise in float32, in other orders, so a sample may round the other
  way at a .5 boundary, and never by 2;
- `off_device`: judged frames of a CUDA run that are not on the card (a
  host route's output); limit 0.

The control is the plain reference's 9/7 synthesis and inverse ICT
(reference/j2k97.py) computed in bfloat16, the nearest precision below the
configuration's float32, on the float64 analysis of OpenJPEG's frame, put
in the program's place.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import dci_streams
from ..reference import j2k97

NUMBERS = ("samples_beyond_one", "off_device")

# judged streams of more JPEG bytes than this in all are answered in
# worker processes (a 2K frame's answer takes seconds)
POOL_FROM = 1 << 20


def answers(streams, ks) -> dict:
    """{k: OpenJPEG's frame} of the pool's streams `ks`."""
    ks = sorted(set(ks))
    jpegs = [streams[k] for k in ks]
    if len(ks) > 1 and sum(len(j) for j in jpegs) > POOL_FROM:
        conv = dci_streams.Converter(min(len(ks), os.cpu_count() or 1))
        try:
            frames = conv.map(jpegs, dci_streams.answer)
        finally:
            conv.close()
    else:
        frames = [dci_streams.answer(j) for j in jpegs]
    return dict(zip(ks, frames))


def control_output(streams, k: int, traffic: dict) -> np.ndarray:
    """What the reference gives in the program's place, in bfloat16."""
    px = dci_streams.answer(streams[k])
    LL, bands = j2k97.analyse_image(px, dci_streams.LEVELS,
                                    dci_streams.DEPTH)
    return j2k97.synthesise_image(LL, bands, dci_streams.DEPTH,
                                  dtype=torch.bfloat16)


def judge(samples, streams, traffic: dict) -> dict:
    """samples: [(stream index, (uint16 frame, off the card) or a frame)]
    -> the numbers compared."""
    want_of = answers(streams, [k for k, _got in samples])
    beyond = off = 0
    for k, got in samples:
        want = want_of[k]
        if isinstance(got, tuple):
            got, moved = got
            off += bool(moved)
        got = None if got is None else np.asarray(got)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            beyond += want.size
            continue
        beyond += int((np.abs(got.astype(np.int32)
                              - want.astype(np.int32)) > 1).sum())
    return {"samples_beyond_one": beyond, "off_device": off}
