"""Check "transcode_coefs": each output stream, read by the plain
reference decoder, against the reference's own transcode of the same
input: decode (reference/jpeg.py), the traffic's `resize` by the plain
bilinear resize (reference/resize.py), and the quantised coefficients of
the reference encoder at the traffic's `encode` settings.

The reference carries bounds through every stage: every value a float32
evaluation may give (`decode_bounds`, `bilinear_bounds`,
`encode_bounds`). The numbers compared are exact:
- `header_faults`: outputs that do not parse, or whose size, sampling,
  quantisation tables or (with standard tables asked for) Huffman tables
  are not what the settings give; limit 0;
- `coefs_outside`: quantised coefficients of the judged outputs outside
  the bounds; limit 0.

The control is the same reference transcode with its IDCT and fDCT
products in TF32, put in the program's place.
"""
from __future__ import annotations

import numpy as np

from ..reference import jpeg
from ..reference.resize import bilinear, bilinear_bounds

NUMBERS = ("header_faults", "coefs_outside")


def expected(streams, k: int, traffic: dict):
    """(frame, [(lo, hi)] coefficient bounds) the settings give for input
    k."""
    enc = traffic["encode"]
    frame = jpeg.parse(streams[k])
    lo, hi = jpeg.decode_bounds(frame, jpeg.entropy_decode(frame))
    r = traffic.get("resize")
    if r:
        if r["interp"] != "bilinear":
            raise ValueError(f"no plain resize for {r['interp']!r}")
        lo, hi = bilinear_bounds(lo, hi, r["height"], r["width"])
    out = jpeg.layout(lo.shape[0], lo.shape[1], enc["subsampling"],
                      enc["quality"])
    return out, jpeg.encode_bounds(lo, hi, out)


def control_output(streams, k: int, traffic: dict) -> bytes:
    """The reference transcode in TF32, in the program's place."""
    enc = traffic["encode"]
    img = jpeg.decode(streams[k], precision="tf32")
    r = traffic.get("resize")
    if r:
        img = bilinear(img, r["height"], r["width"])
    data, _f, _c = jpeg.encode(img, enc["quality"], enc["subsampling"],
                               enc["optimized_huffman"], precision="tf32")
    return data


def _header_ok(got: jpeg.Frame, want: jpeg.Frame, standard: bool) -> bool:
    if (got.height, got.width) != (want.height, want.width):
        return False
    if [c[1:3] for c in got.components] != [c[1:3]
                                            for c in want.components]:
        return False
    for c_got, c_want in zip(got.components, want.components):
        if not np.array_equal(got.quant.get(c_got[3]),
                              want.quant[c_want[3]]):
            return False
    if standard:
        std = {(0, 0): jpeg.STD_DC_LUMA, (0, 1): jpeg.STD_DC_CHROMA,
               (1, 0): jpeg.STD_AC_LUMA, (1, 1): jpeg.STD_AC_CHROMA}
        for ci, td, ta in got.scan:
            kind = 0 if ci == 0 else 1
            for cls, t in ((0, td), (1, ta)):
                spec = got.huffman.get((cls, t))
                if spec is None or (list(spec[0]), list(spec[1])) != (
                        list(std[(cls, kind)][0]), list(std[(cls, kind)][1])):
                    return False
    return True


def judge(samples, streams, traffic: dict) -> dict:
    """samples: [(input stream index, output bytes)] -> the numbers."""
    standard = not traffic["encode"]["optimized_huffman"]
    faults, outside = 0, 0
    for k, data in samples:
        want_frame, want = expected(streams, k, traffic)
        try:
            got_frame = jpeg.parse(bytes(data))
            got = jpeg.entropy_decode(got_frame)
        except (ValueError, IndexError, TypeError, KeyError):
            faults += 1
            continue
        if not _header_ok(got_frame, want_frame, standard) or [
                g.shape for g in got] != [lo.shape for lo, _hi in want]:
            faults += 1
            continue
        for g, (lo, hi) in zip(got, want):
            outside += int(((g < lo) | (g > hi)).sum())
    return {"header_faults": faults, "coefs_outside": outside}
