"""The JPEG 2000 codestreams of a J2K cell, made from the pool's JPEG
streams: each is decoded to RGB by Pillow (its libjpeg) and encoded again,
losslessly, by Pillow's OpenJPEG with the settings of `opj_compress`'s
defaults. Never by the measured program.

`source_pixels` is also what the check rebuilds: for a lossless stream the
pixels it was made from are the exact answer of every correct decoder.
`Converter` makes the codestreams in worker processes, so that a pool of
large images adds little to set-up.
"""
from __future__ import annotations

import io
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

# opj_compress's defaults: reversible 5/3 and RCT (Pillow writes MCT 0 in
# the COD marker unless asked), 6 resolutions (5 decomposition levels),
# 64x64 code-blocks, LRCP, one layer, one tile, no precincts; a raw
# codestream as DICOM encapsulates it
SETTINGS = dict(irreversible=False, mct=1, num_resolutions=6,
                codeblock_size=(64, 64), progression="LRCP", no_jp2=True)
LEVELS = SETTINGS["num_resolutions"] - 1


def source_pixels(jpeg: bytes) -> np.ndarray:
    """The RGB uint8 [H, W, 3] pixels of a JPEG stream, as Pillow decodes
    them."""
    from PIL import Image

    with Image.open(io.BytesIO(jpeg)) as im:
        return np.asarray(im.convert("RGB"))


def encode(pixels: np.ndarray, irreversible: bool = False) -> bytes:
    """A J2K codestream of `pixels` by Pillow's OpenJPEG at SETTINGS;
    irreversible=True makes the lossy 9/7 stream of the same settings
    otherwise (the tests' fault)."""
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels)).save(
        out, format="JPEG2000", **dict(SETTINGS, irreversible=irreversible))
    return out.getvalue()


def convert(jpeg: bytes) -> bytes:
    """The lossless codestream of a JPEG stream's pixels."""
    return encode(source_pixels(jpeg))


class Converter:
    """`convert` over worker processes that start at once (at most
    `workers`, one a core by default); `close()` ends them."""

    def __init__(self, workers: int = 0):
        workers = workers or os.cpu_count() or 1
        self.pool = ProcessPoolExecutor(workers,
                                        mp_context=get_context("spawn"))

    def map(self, jpegs):
        return list(self.pool.map(convert, jpegs))

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None
