"""Seeded photographs: the benchmark's pixels.

`make_photo` is a frozen copy of the repository's test helper
(tests/util.py): smooth low-frequency content, hard-edged shapes and mild
noise. Alone it compresses to under 1 bit a pixel at quality 85, far below
a camera photograph, so `textured_photo` adds a 1/f (pink) texture and
white noise on top: with the traffic's std of 50 and 28, a 375x500 photo
comes to about 4.85 bits a pixel at quality 85, some 111 KiB a stream.
"""
from __future__ import annotations

import numpy as np


def make_photo(h: int = 426, w: int = 640, seed: int = 0, channels: int = 3) -> np.ndarray:
    """Smooth low-frequency content + edges + mild noise; JPEG-friendly but
    non-trivial (emulates the padlock/cat photos in the reference corpus)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w, channels), np.float32)
    for c in range(channels):
        f1, f2 = rng.uniform(0.005, 0.03, 2)
        p1, p2 = rng.uniform(0, 6.28, 2)
        base = (
            110
            + 70 * np.sin(xx * f1 + p1) * np.cos(yy * f2 + p2)
            + 40 * np.sin((xx + yy) * rng.uniform(0.004, 0.02))
        )
        out[:, :, c] = base
    # a few hard-edged rectangles and circles for high-frequency content
    for _ in range(6):
        y0, x0 = rng.integers(0, max(1, h - 20)), rng.integers(0, max(1, w - 20))
        hh, ww = rng.integers(1, max(2, h // 3)), rng.integers(1, max(2, w // 3))
        col = rng.uniform(0, 255, channels)
        out[y0 : y0 + hh, x0 : x0 + ww] = 0.6 * out[y0 : y0 + hh, x0 : x0 + ww] + 0.4 * col
    cy, cx, r = h // 2, w // 2, min(h, w) // 4
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    out[mask] = 0.7 * out[mask] + 0.3 * 200
    out += rng.normal(0, 2.0, out.shape)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[:, :, 0] if channels == 1 else out


def textured_photo(h: int, w: int, seed: int, texture_std: float,
                   noise_std: float) -> np.ndarray:
    """`make_photo` plus a 1/f texture of standard deviation `texture_std`
    shared by the three channels and white noise of `noise_std` in each."""
    base = make_photo(h, w, seed=seed).astype(np.float32)
    rng = np.random.default_rng([seed, 1])
    f = np.sqrt(np.fft.fftfreq(h)[:, None] ** 2
                + np.fft.rfftfreq(w)[None, :] ** 2)
    f[0, 0] = 1.0
    spec = (rng.normal(size=f.shape) + 1j * rng.normal(size=f.shape)) / f
    spec[0, 0] = 0.0
    tex = np.fft.irfft2(spec, s=(h, w))
    tex *= texture_std / max(float(tex.std()), 1e-9)
    out = (base + tex[..., None].astype(np.float32)
           + rng.normal(0.0, noise_std, base.shape).astype(np.float32))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
