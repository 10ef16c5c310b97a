"""JPEG streams for the CUDA port's card checks, committed as files.

The GPU machine may lack the system codec libraries that the test oracle
links, and the card checks read only bytes, so the restart-marker streams
are made once by `make_corpus.py` and committed here:

- `progressive_streams`: libjpeg's default progressive script
  (successive-approximation DC and AC scans) with restart interval 16,
  made with the oracle;
- `dri_streams`: baseline 4:2:0 JPEGs with standard tables and a restart
  marker every MCU row (32 MCUs), made by `encode_dri`.

`encode_dri` itself uses the JAX package's host encoder (numpy and its
native entropy coder) and is for tests and `make_corpus.py` only.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

DIR = os.path.dirname(os.path.abspath(__file__))

# the progressive corpus: bench.py's progressive stream, for 8 photos
PROG_H, PROG_W, PROG_Q, PROG_RI = 375, 500, 85, 16
PROG_SEEDS = range(8)


def prog_path(seed: int) -> str:
    return os.path.join(DIR, f"prog_{PROG_H}x{PROG_W}_q{PROG_Q}_420_"
                             f"ri{PROG_RI}_s{seed}.jpg")


def progressive_streams() -> List[bytes]:
    """The committed progressive streams, seeds 0-7 in order."""
    return [_read(prog_path(s)) for s in PROG_SEEDS]


# the dri corpus: bench.py's restart-marker stream, for 8 photos
DRI_H, DRI_W, DRI_Q, DRI_RI = 375, 500, 85, 32
DRI_SEEDS = range(8)


def dri_path(seed: int) -> str:
    return os.path.join(DIR, f"dri_{DRI_H}x{DRI_W}_q{DRI_Q}_420_"
                             f"ri{DRI_RI}_s{seed}.jpg")


def dri_streams() -> List[bytes]:
    """The committed restart-marker streams, seeds 0-7 in order."""
    return [_read(dri_path(s)) for s in DRI_SEEDS]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def encode_dri(img: np.ndarray, quality: int,
               restart_interval: int) -> bytes:
    """Baseline 4:2:0 JPEG of a uint8 [H, W, 3] image with standard Huffman
    tables and a restart marker every `restart_interval` MCUs."""
    from nvimagecodec_tpu.codecs.jpeg.encode import (
        _entropy_encode,
        build_encode_frame,
        encode_pixels,
        write_jpeg,
    )
    from nvimagecodec_tpu.codecs.jpeg.headers import HuffTable
    from nvimagecodec_tpu.codecs.jpeg.tables import (
        STD_AC_CHROMA,
        STD_AC_LUMA,
        STD_DC_CHROMA,
        STD_DC_LUMA,
    )
    from nvimagecodec_tpu.core.types import ChromaSubsampling

    H, W = img.shape[:2]
    frame = build_encode_frame(H, W, 3, quality, ChromaSubsampling.CSS_420)
    coefs = [np.asarray(c) for c in encode_pixels(img, frame)]
    for i, c in enumerate(frame.components):
        c.dc_tbl = c.ac_tbl = 0 if i == 0 else 1

    def std(t):  # Annex K tables are stored 1-indexed
        return HuffTable(list(t[0][1:]), list(t[1]))

    dc = {0: std(STD_DC_LUMA), 1: std(STD_DC_CHROMA)}
    ac = {0: std(STD_AC_LUMA), 1: std(STD_AC_CHROMA)}
    entropy = _entropy_encode(frame, coefs, dc, ac, restart_interval)
    return write_jpeg(frame, entropy, dc, ac, restart_interval)
