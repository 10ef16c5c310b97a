"""Animated WebP: native ANIM/ANMF container decode + mux encode.

The reference's WebP support tops out at stills — its parser reads the
VP8X header (src/parsers/webp.cpp:28-200, EXTENDED_LAYOUT_ANIMATION flag)
and decode goes through cv::imdecode (extensions/opencv/
opencv_decoder.cpp:31-150), which composits nothing. Here the container
logic (frame rectangles, blend/dispose state machine per the WebP
container spec) is ~200 lines on top of the native VP8/VP8L/ALPH frame
decoders, so animations decode fully natively:

- ``decode_webp_animation`` → every composited RGBA canvas frame,
  per-frame durations, loop count (exceeds the reference);
- ``WebpAnimDecoder`` plugin → first composited frame through the
  standard ``Decoder`` API (what cv::imdecode would return);
- ``encode_webp_animation`` → mux frames into ANIM/ANMF using the
  native still encoders for the per-frame payloads.

Compositing follows libwebp's WebPAnimDecoder (the test oracle):
canvas starts transparent black, "dispose to background" clears the
frame rectangle to transparent black, and alpha blending uses the
container spec's non-premultiplied integer formula.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.interfaces import DecoderPlugin, DecodeResult
from ..core.types import BackendKind, Priority, ProcessingStatus
from .webp import (_decode_alph, _riff_chunks, decode_webp_lossless,
                   decode_webp_lossy, encode_webp_lossless,
                   encode_webp_lossy)


class AnimFrame:
    """One ANMF record: placement, timing, compositing flags, payload."""

    __slots__ = ("x", "y", "w", "h", "duration_ms", "blend", "dispose",
                 "chunks")

    def __init__(self, x, y, w, h, duration_ms, blend, dispose, chunks):
        self.x = x
        self.y = y
        self.w = w
        self.h = h
        self.duration_ms = duration_ms
        self.blend = blend      # True: alpha-blend onto canvas
        self.dispose = dispose  # True: clear frame rect after display
        self.chunks = chunks    # [(tag, body), ...] — ALPH/VP8/VP8L


def parse_animation(data: bytes):
    """→ (canvas_w, canvas_h, bg_rgba, loop_count, [AnimFrame, ...]).

    ANMF layout (container spec): X/2 u24, Y/2 u24, W-1 u24, H-1 u24,
    duration u24, flags byte (bit1 B: 1 = no blend; bit0 D: 1 = dispose
    to background).
    """
    canvas_w = canvas_h = 0
    bg = (0, 0, 0, 0)
    loop = 0
    frames: List[AnimFrame] = []
    for tag, body in _riff_chunks(data):
        b = bytes(body)
        if tag == b"VP8X" and len(b) >= 10:
            canvas_w = 1 + int.from_bytes(b[4:7], "little")
            canvas_h = 1 + int.from_bytes(b[7:10], "little")
        elif tag == b"ANIM" and len(b) >= 6:
            # background color bytes are [B, G, R, A]
            bg = (b[2], b[1], b[0], b[3])
            loop = struct.unpack_from("<H", b, 4)[0]
        elif tag == b"ANMF" and len(b) >= 16:
            x = 2 * int.from_bytes(b[0:3], "little")
            y = 2 * int.from_bytes(b[3:6], "little")
            w = 1 + int.from_bytes(b[6:9], "little")
            h = 1 + int.from_bytes(b[9:12], "little")
            dur = int.from_bytes(b[12:15], "little")
            flags = b[15]
            sub = list(_riff_chunks(b"RIFFxxxxWEBP" + b[16:]))
            frames.append(AnimFrame(x, y, w, h, dur,
                                    blend=not (flags & 2),
                                    dispose=bool(flags & 1),
                                    chunks=sub))
    if canvas_w == 0 or not frames:
        raise ValueError("WebP: not an animation (no VP8X/ANMF)")
    return canvas_w, canvas_h, bg, loop, frames


def _synth_still(chunks) -> bytes:
    """Wrap ANMF sub-chunks back into a standalone RIFF/WEBP container so
    the still decoders can run unchanged."""
    body = b""
    for tag, ch in chunks:
        ch = bytes(ch)
        body += tag + struct.pack("<I", len(ch)) + ch
        if len(ch) & 1:
            body += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _decode_frame_rgba(frame: AnimFrame) -> np.ndarray:
    tags = [t for t, _ in frame.chunks]
    still = _synth_still(frame.chunks)
    if b"VP8L" in tags:
        img = decode_webp_lossless(still)
    elif b"VP8 " in tags:
        img = decode_webp_lossy(still)
    else:
        raise ValueError("ANMF: no VP8/VP8L payload")
    if img.shape[-1] == 3:
        img = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    if img.shape[0] != frame.h or img.shape[1] != frame.w:
        raise ValueError("ANMF: frame payload size mismatch")
    return img


def _blend_nonpremult(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Non-premultiplied alpha blend with libwebp's exact integer
    arithmetic (demux/anim_decode.c): dst factor ``da*(256-sa) >> 8``,
    then a Q24 reciprocal of the blended alpha scales each channel.
    Verified bit-exact against WebPAnimDecoder over dense random alpha
    (tests/test_webp_anim.py)."""
    sa = src[..., 3:4].astype(np.int64)
    da = dst[..., 3:4].astype(np.int64)
    dfa = (da * (256 - sa)) >> 8
    ba = sa + dfa
    scale = np.where(ba > 0, (1 << 24) // np.maximum(ba, 1), 0)
    num = (src[..., :3].astype(np.int64) * sa
           + dst[..., :3].astype(np.int64) * dfa)
    rgb = (num * scale) >> 24
    out = np.concatenate([rgb, ba], axis=-1).astype(np.uint8)
    transparent = (sa == 0)[..., 0]
    out[transparent] = dst[transparent]
    opaque = (sa == 255)[..., 0]
    out[opaque] = src[opaque]
    return out


def decode_webp_animation(
    data: bytes,
) -> Tuple[List[np.ndarray], List[int], int]:
    """Decode every frame of an animated WebP natively.

    Returns (frames, durations_ms, loop_count) where each frame is the
    fully composited [canvas_h, canvas_w, 4] u8 RGBA canvas at that point
    of the timeline — the same frames libwebp's WebPAnimDecoder yields.
    """
    W, H, _bg, loop, anmf = parse_animation(data)
    canvas = np.zeros((H, W, 4), np.uint8)
    frames: List[np.ndarray] = []
    durations: List[int] = []
    for fr in anmf:
        if fr.x + fr.w > W or fr.y + fr.h > H:
            raise ValueError("ANMF frame rect outside canvas")
        sub = _decode_frame_rgba(fr)
        ys, xs = slice(fr.y, fr.y + fr.h), slice(fr.x, fr.x + fr.w)
        if fr.blend:
            canvas[ys, xs] = _blend_nonpremult(sub, canvas[ys, xs])
        else:
            canvas[ys, xs] = sub
        frames.append(canvas.copy())
        durations.append(fr.duration_ms)
        if fr.dispose:
            canvas[ys, xs] = 0
    return frames, durations, loop


def encode_webp_animation(
    frames: Sequence[np.ndarray],
    durations_ms=100,
    loop: int = 0,
    lossless: bool = True,
    quality: float = 75.0,
    bg_rgba: Tuple[int, int, int, int] = (255, 255, 255, 0),
) -> bytes:
    """Mux full-canvas frames into an animated WebP (ANIM/ANMF).

    Each frame is encoded with the native still encoder (VP8L when
    ``lossless`` else VP8, ALPH carried for RGBA lossy input) and placed
    at (0, 0) with no blending and no disposal — every ANMF carries the
    complete canvas, so any spec-conforming player composits the exact
    input frames back.
    """
    if not frames:
        raise ValueError("animation needs at least one frame")
    H, W = frames[0].shape[:2]
    if isinstance(durations_ms, int):
        durations_ms = [durations_ms] * len(frames)
    if len(durations_ms) != len(frames):
        raise ValueError("durations length mismatch")
    if W > 1 << 24 or H > 1 << 24:
        raise ValueError("canvas dimensions exceed WebP's 24-bit limit")
    if any(not (0 <= d < 1 << 24) for d in durations_ms):
        raise ValueError("frame duration must be in [0, 2**24) ms")
    has_alpha = any(f.ndim == 3 and f.shape[-1] == 4 for f in frames)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (tag + struct.pack("<I", len(body)) + body
                + (b"\x00" if len(body) & 1 else b""))

    out = b""
    flags = 0x02 | (0x10 if has_alpha else 0)  # animation (+ alpha)
    vp8x = bytes([flags, 0, 0, 0]) + struct.pack("<I", W - 1)[:3] \
        + struct.pack("<I", H - 1)[:3]
    out += chunk(b"VP8X", vp8x)
    r, g, b, a = bg_rgba
    out += chunk(b"ANIM", bytes([b, g, r, a]) + struct.pack("<H", loop))
    for img, dur in zip(frames, durations_ms):
        img = np.asarray(img)
        if img.shape[:2] != (H, W):
            raise ValueError("all frames must share the canvas size")
        still = (encode_webp_lossless(img) if lossless
                 else encode_webp_lossy(img, quality))
        payload = b""
        for tag, body in _riff_chunks(still):
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                payload += chunk(tag, bytes(body))
        anmf = (b"\x00\x00\x00" * 2                      # x=0, y=0
                + struct.pack("<I", W - 1)[:3]
                + struct.pack("<I", H - 1)[:3]
                + struct.pack("<I", dur)[:3]
                + bytes([0x02]))                         # no blend, keep
        out += chunk(b"ANMF", anmf + payload)
    return b"RIFF" + struct.pack("<I", 4 + len(out)) + b"WEBP" + out


class WebpAnimDecoder(DecoderPlugin):
    """Animated WebP through the standard Decoder API: returns the first
    composited canvas frame (the reference's cv::imdecode analog for
    animations); the full timeline is available via
    ``decode_webp_animation``. Sits above the system-libwebp rung."""

    codec = "webp"
    plugin_id = "tpu_webp_anim_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for data in data_batch:
            try:
                tags = [t for t, _ in _riff_chunks(bytes(data))]
                ok = b"ANIM" in tags and b"ANMF" in tags
            except Exception:
                ok = False
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            )
        return out

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data in data_batch:
            try:
                frames, _, _ = decode_webp_animation(bytes(data))
                img = frames[0]
                if (img[..., 3] == 255).all():
                    img = np.ascontiguousarray(img[..., :3])
                out.append(DecodeResult(ProcessingStatus.SUCCESS, img))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out
