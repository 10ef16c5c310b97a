#!/usr/bin/env python
"""The PyTorch + CUDA port's bench: images/s of its paths on one card.

    python3 bench_torch.py [--device cuda|cpu] [--seed N] [--quick]
    python3 bench_torch.py --section NAME [--device ...] [--seed N] [--quick]

The port's counterpart of bench.py, at that bench's sizes. The parent process
builds the kernel library (nvcc, csrc/*.cu) and the host library (c++,
native/*.cpp) once, then runs each configuration in a process of its own,
with its own time limit, and reads the one JSON line each prints last:

- jpeg_idx: 512 baseline 375x500 q85 4:2:0 JPEGs (standard Huffman tables,
  no restart markers, 8 make_photo seeds cycled, made by the port's encoder)
  through `pipeline.decode_batches` in batches of 256 at depth 2 and
  `Decoder(device=...)`: the index-scan route (K2, K1);
- jpeg_dri: the same photos with a restart marker every MCU row, encoded
  here by the port's native encoder: the dri route (K2, K1);
- jpeg_host: the jpeg_idx corpus with `cuda_jpeg_hybrid_decoder:
  device_entropy=false`: the host entropy route (K1);
- jpeg_prog: the 8 committed progressive streams (tests/torch_corpus; the
  seed does not move them), `decode_progressive` on the device (K3, K1)
  against the Decoder, which keeps progressive streams on the host entropy
  route;
- jpeg_encode: 256 decoded images, on the device and on the host, each
  encoded at q85 4:2:0 by the device route (`fdct_quant_blocks`) and by the
  host route (`cuda_jpeg_hybrid_encoder:device_stage=false`);
- transcode: 256 streams as 4 batches of 64 through `decode_batches` at
  depth 2, a resize to 224x224 on the device, `Encoder.encode`;
- j2k: 8 lossless 1024x1024 RGB streams from the port's `encode_j2k`,
  `Decoder(device=...)` with the device pixel stage against
  `device_pixel_stage=false`;
- kernels (on a card only): K1, K2, K3 and `fdct_quant_blocks` alone at the
  main paths' shapes, CUDA events behind a spin kernel, beside their bound
  and their launches in a pass of jpeg_idx, jpeg_prog and jpeg_encode.

Each metric comes from at least 10 timed passes (4 with --quick), compared
routes in turns (A B B A, repeated), each pass ending in
`torch.cuda.synchronize()`, tracing off; it is reported as median, first and
third quartile and count. After the timed passes one traced pass gives the
spans and byte counters of core/trace.py per batch, and one
`torch.profiler` window over a jpeg_idx and a jpeg_encode batch gives the
device's busy time and idle share. Each configuration is checked once
outside the timed passes: decodes within 1 of the port's CPU decoder, every
sample on its route (the ROUTES counters), encodes decoding again to PSNR
>= 33 dB, J2K equal to its photo, failures counted against samples
attempted. libjpeg-turbo (tests/oracle) and openjpeg (native/opj_bridge.py)
are timed beside the port where those libraries load, and named under
"skipped" where they do not.

Detail goes to stderr and to one line a section on stdout; the last line of
stdout is one JSON object of under 2000 characters. The exit code is 1 if a
check failed or a section crashed or ran out of time, 2 without a card for
`--device cuda`. `--device cpu` (the tests) runs every path with the
kernels' plain versions and labels every result "platform": "cpu".
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

SEEDS = 8  # distinct photos, cycled through every JPEG corpus
QUALITY = 85
PSNR_BAR_DB = 33.0
MAX_LINE = 2000  # characters of the last line
HOLD_MS = 20  # the spin kernel each kernel's timed launches queue behind
RUN_LIMIT_S = 900  # the whole run; a section gets what is left of it

# (configuration, seconds it may take)
SECTIONS = [("jpeg_idx", 300), ("jpeg_dri", 300), ("jpeg_host", 300),
            ("jpeg_prog", 300), ("jpeg_encode", 300), ("transcode", 300),
            ("j2k", 400), ("kernels", 300)]

# the spans and counters of core/trace.py a traced pass reports
LAYER_SPANS = [
    "imgcodec.jpeg.parse", "imgcodec.jpeg.index_scan",
    "imgcodec.jpeg.dri_split", "imgcodec.jpeg.host_entropy",
    "imgcodec.jpeg.device_entropy", "imgcodec.jpeg.prog_split",
    "imgcodec.jpeg.prog_kernel", "imgcodec.jpeg.prog_flags",
    "imgcodec.jpeg.pixel_stage", "imgcodec.pipeline.device_wait",
    "imgcodec.jpeg.encode_device_stage", "imgcodec.jpeg.encode_host_entropy",
    "imgcodec.jpeg2k.host_stage", "imgcodec.jpeg2k.upload",
    "imgcodec.jpeg2k.device_stage"]
# the configuration whose traced pass gives a kernel's launches
KERNEL_PATHS = {"K1": "jpeg_idx", "K2": "jpeg_idx", "K3": "jpeg_prog",
                "FDCT": "jpeg_encode"}
LAYER_COUNTERS = ["imgcodec.jpeg.h2d_bytes", "imgcodec.jpeg.d2h_bytes",
                  "imgcodec.jpeg2k.h2d_bytes"]


class Sizes:
    """The corpus and pass counts: the reference bench's (bench.py:35-38,
    :501-502) or, with --quick, a tiny one for the CPU test."""

    def __init__(self, quick: bool):
        self.passes = 4 if quick else 10
        self.hw = (48, 64) if quick else (375, 500)
        self.n_images = 32 if quick else 512
        self.batch = 16 if quick else 256  # the idx route takes >= 16
        self.encode_n = 16 if quick else 256
        self.transcode = (2, 16) if quick else (4, 64)  # batches, images
        self.resize_hw = 48 if quick else 224
        self.j2k_n, self.j2k_hw, self.j2k_levels = (
            (2, 128, 5) if quick else (8, 1024, 5))
        self.prog_n = 1 if quick else 8


# --------------------------------------------------------------------------
# statistics and order of passes
# --------------------------------------------------------------------------

def quartiles(xs):
    """(median, first quartile, third quartile, n) of xs, each quartile
    interpolated linearly between order statistics (numpy's default)."""
    ys = sorted(xs)
    n = len(ys)
    if n == 0:
        raise ValueError("quartiles of no values")

    def at(p):
        k = p * (n - 1)
        lo = int(math.floor(k))
        hi = min(lo + 1, n - 1)
        return ys[lo] + (ys[hi] - ys[lo]) * (k - lo)

    return at(0.5), at(0.25), at(0.75), n


def turns(names, passes: int):
    """The order of `passes` timed passes of each of `names`: the names, then
    the same names reversed (A B B A), repeated."""
    if passes % 2:
        raise ValueError("passes must be even")
    names = list(names)
    return (names + names[::-1]) * (passes // 2)


def run_turns(routes: dict, passes: int) -> dict:
    """{name: [rates]} of each route's fn() in turns."""
    out = {name: [] for name in routes}
    for name in turns(routes, passes):
        out[name].append(routes[name]())
    return out


# --------------------------------------------------------------------------
# one configuration, in its own process
# --------------------------------------------------------------------------

class Record(dict):
    """What a section measured and checked; printed as its last line."""

    def __init__(self, name: str, device):
        super().__init__(config=name, platform=device.type, passes={},
                         attempted=0, failures=0, errors=[], skipped={})

    def count(self, results) -> None:
        """Samples attempted, and those that came back None."""
        self["attempted"] += len(results)
        self["failures"] += sum(r is None for r in results)

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self["errors"].append(what)
            log(f"[{self['config']}] check failed: {what}")

    def emit(self) -> None:
        self["correct"] = not self["errors"] and self["failures"] == 0
        print(json.dumps(self), flush=True)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def require_built(device) -> None:
    """The parent builds both libraries before any section; a section that
    finds one missing or older than its sources stops instead of starting a
    second build."""
    from nvimagecodec_tpu_torch import _build, native

    stale = []
    if native.needs_build(native._SO, native._sources() + native._headers()):
        stale.append("libtic_host.so")
    if device.type == "cuda" and _build._needs_build():
        stale.append("libtic_cuda.so")
    if stale:
        raise RuntimeError(f"{', '.join(stale)} missing or older than its "
                           "sources: run bench_torch.py without --section, "
                           "which builds them first")


def jpeg_params():
    """q85 4:2:0 with the standard Huffman tables."""
    import nvimagecodec_tpu_torch as nic

    return nic.EncodeParams(
        quality=QUALITY, chroma_subsampling=nic.ChromaSubsampling.CSS_420,
        jpeg=nic.JpegEncodeParams(optimized_huffman=False))


def jpeg_corpus(sz: Sizes, seed: int):
    """The photos, their baseline streams (made as chip_smoke.py makes them)
    and the corpus of sz.n_images streams cycling them."""
    import nvimagecodec_tpu_torch as nic
    from util import make_photo

    photos = [make_photo(*sz.hw, seed=seed + k) for k in range(SEEDS)]
    uniq = nic.Encoder(device="cpu").encode(photos, "jpeg", jpeg_params())
    if any(d is None for d in uniq):
        raise RuntimeError("corpus encode failed")
    return photos, uniq, [uniq[i % SEEDS] for i in range(sz.n_images)]


def encode_dri(img, quality: int, restart_interval: int) -> bytes:
    """Baseline 4:2:0 JPEG of a uint8 [H, W, 3] image with standard Huffman
    tables and a restart marker every `restart_interval` MCUs, by the port's
    encoder (the bytes of tests/torch_corpus.encode_dri)."""
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import (
        _entropy_encode,
        build_encode_frame,
        encode_pixels,
        write_jpeg,
    )
    from nvimagecodec_tpu_torch.codecs.jpeg.headers import HuffTable
    from nvimagecodec_tpu_torch.codecs.jpeg.tables import (
        STD_AC_CHROMA,
        STD_AC_LUMA,
        STD_DC_CHROMA,
        STD_DC_LUMA,
    )
    from nvimagecodec_tpu_torch.core.types import ChromaSubsampling

    H, W = img.shape[:2]
    frame = build_encode_frame(H, W, 3, quality, ChromaSubsampling.CSS_420)
    coefs = [c.numpy() for c in encode_pixels(img, frame, "cpu")]
    for i, c in enumerate(frame.components):
        c.dc_tbl = c.ac_tbl = 0 if i == 0 else 1

    def std(t):  # Annex K tables are stored 1-indexed
        return HuffTable(list(t[0][1:]), list(t[1]))

    dc = {0: std(STD_DC_LUMA), 1: std(STD_DC_CHROMA)}
    ac = {0: std(STD_AC_LUMA), 1: std(STD_AC_CHROMA)}
    entropy = _entropy_encode(frame, coefs, dc, ac, restart_interval)
    return write_jpeg(frame, entropy, dc, ac, restart_interval)


def cpu_reference(streams):
    """The port's CPU decoder (cpu_jpeg_decoder: native host entropy decode
    and the plain pixel stage), as int32 tensors."""
    import nvimagecodec_tpu_torch as nic

    dec = nic.Decoder(device="cpu",
                      backends=[nic.Backend(nic.BackendKind.CPU_ONLY)])
    return [im.array.int() for im in dec.decode(streams)]


def max_diff(images, ref) -> int:
    """Max |a - b| of every image against ref[j % len(ref)]; 256 for an
    image that is missing or of another shape."""
    worst = 0
    for j, im in enumerate(images):
        want = ref[j % len(ref)]
        if im is None or tuple(im.shape) != tuple(want.shape):
            return 256
        got = im.array if hasattr(im, "array") else im
        worst = max(worst, int((got.cpu().int() - want).abs().max()))
    return worst


def psnr_min(decoded, sources) -> float:
    """The lowest PSNR (dB) of a decoded image against its source; 0 for a
    decode that failed or came back in another shape."""
    import torch
    from chip_smoke import psnr_db

    worst = math.inf
    for im, src in zip(decoded, sources):
        src = torch.as_tensor(src)
        if im is None or tuple(im.shape) != tuple(src.shape):
            return 0.0
        worst = min(worst, psnr_db(im.array.to(src.device), src))
    return worst


def route_delta(routes: dict, before: dict) -> dict:
    return {k: routes[k] - before[k] for k in before}


def traced(fn, batches: int, rec: Record, device) -> None:
    """One traced run of fn(): ms of each layer span and bytes of each
    counter per batch (spans add up over the threads that ran them), and on
    a card the kernels' launches."""
    from chip_smoke import counts, counts_zero
    from nvimagecodec_tpu_torch.core import trace

    counts_zero()
    trace.start_collect()
    try:
        fn()
        sync(device)
    finally:
        got = trace.stop_collect()
    rec["ms_per_batch"] = {k.rsplit(".", 1)[1]: got["spans"][k] * 1e3 / batches
                           for k in LAYER_SPANS if k in got["spans"]}
    rec["bytes_per_batch"] = {
        k.rsplit(".", 1)[1]: got["counters"][k] / batches
        for k in LAYER_COUNTERS if k in got["counters"]}
    if device.type == "cuda":
        rec["launches"] = {k: v for k, v in counts().items() if v}


def idle_share(fn, device):
    """Device busy ms and idle share of fn() under torch.profiler: the sum
    of the device's kernel and copy times against the host's wall time to
    `torch.cuda.synchronize()`. "not measured" off the card, or where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return "not measured"
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if busy_ms <= 0:
        return "not measured"
    return {"busy_ms": busy_ms, "wall_ms": wall_ms,
            "share": 1 - busy_ms / wall_ms}


def rate_of(fn, n: int, device):
    """Images/s of fn(), which handles n images, to a synchronise."""
    def timed():
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return n / (time.perf_counter() - t0)
    return timed


def libjpeg_pairing(streams, rec: Record):
    """The one-thread libjpeg-turbo decode of `streams` (tests/oracle), as a
    route of run_turns, or None with the reason under "skipped"."""
    try:
        import oracle

        oracle.lib()
    except Exception as e:  # no system libjpeg, or no compiler for the shim
        rec["skipped"]["libjpeg_turbo"] = f"no oracle: {type(e).__name__}"
        return None

    def one_pass():
        t0 = time.perf_counter()
        for d in streams:
            oracle.jpeg_decode(d)
        return len(streams) / (time.perf_counter() - t0)
    return one_pass


def section_jpeg(route: str, args, sz: Sizes, dev) -> Record:
    """jpeg_idx, jpeg_dri or jpeg_host: the corpus through decode_batches."""
    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.pipeline import decode_batches

    rec = Record(f"jpeg_{route}", dev)
    photos, uniq, jpgs = jpeg_corpus(sz, args.seed)
    options = ""
    if route == "dri":
        ri = -(-sz.hw[1] // 16)  # MCUs in a row of a 4:2:0 frame
        uniq = [encode_dri(p, QUALITY, ri) for p in photos]
        jpgs = [uniq[i % SEEDS] for i in range(sz.n_images)]
        rec["restart_interval"] = ri
    elif route == "host":
        options = "cuda_jpeg_hybrid_decoder:device_entropy=false"
    dec = nic.Decoder(device=dev, options=options)
    batches = [jpgs[i:i + sz.batch] for i in range(0, len(jpgs), sz.batch)]
    rec["corpus"] = (f"{len(jpgs)} x {sz.hw[0]}x{sz.hw[1]} q{QUALITY} 4:2:0, "
                     f"batches of {sz.batch}, depth 2")

    def one_pass(keep=None):
        outs = []
        for got in decode_batches(batches, decoder=dec, drop_failed=False,
                                  depth=2):
            outs.extend(got)
        rec.count(outs)
        if keep is not None:
            keep.extend(outs)

    # warm-up, and the check, outside the timed passes
    before = dict(jb.ROUTES)
    outs = []
    one_pass(outs)
    sync(dev)
    took = route_delta(jb.ROUTES, before)
    rec["routes"] = took
    rec.check(took == {**dict.fromkeys(before, 0), route: len(jpgs)},
              f"routes {took}, expected all {len(jpgs)} on {route}")
    diff = max_diff(outs, cpu_reference(uniq))
    rec["max_abs_diff"] = diff
    rec.check(diff <= 1, f"max |diff| {diff} against the CPU decode > 1")
    del outs

    routes = {"decode_images_per_s": rate_of(one_pass, len(jpgs), dev)}
    if route == "idx":
        base = libjpeg_pairing(jpgs[:sz.batch], rec)
        if base is not None:
            routes["libjpeg_turbo_1t_images_per_s"] = base
    rec["passes"] = run_turns(routes, sz.passes)
    traced(one_pass, len(batches), rec, dev)
    if dev.type == "cuda":
        launches = rec.get("launches", {})
        want_k2 = route != "host"
        rec.check(launches.get("K1", 0) > 0
                  and (launches.get("K2", 0) > 0) == want_k2,
                  f"launches {launches}")
    if route == "idx":
        rec["idle"] = idle_share(lambda: dec.decode(batches[0]), dev)
    return rec


def section_jpeg_idx(args, sz, dev):
    return section_jpeg("idx", args, sz, dev)


def section_jpeg_dri(args, sz, dev):
    return section_jpeg("dri", args, sz, dev)


def section_jpeg_host(args, sz, dev):
    return section_jpeg("host", args, sz, dev)


def section_jpeg_prog(args, sz, dev):
    """The committed progressive streams: decode_progressive on the device
    (K3 scan by scan, then K1 and the pixel stage) against the Decoder,
    which keeps progressive streams on the host entropy route."""
    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb

    rec = Record("jpeg_prog", dev)
    streams = torch_corpus.progressive_streams()[:sz.prog_n]
    rec["corpus"] = (f"{len(streams)} committed progressive streams "
                     "(tests/torch_corpus prog_*); --seed does not move them")
    rec["seeded"] = False
    nscans = sum(len(jb.parse_jpeg_structure(d).scans) for d in streams)
    dec = nic.Decoder(device=dev)
    ref = cpu_reference(streams)

    def device_route():
        outs = [jb.decode_progressive(d, dev) for d in streams]
        rec.count(outs)
        return outs

    def host_route():
        outs = dec.decode(streams)
        rec.count(outs)
        return outs

    from chip_smoke import counts, counts_zero

    counts_zero()
    got = device_route()
    sync(dev)
    launches = counts()
    if dev.type == "cuda":
        rec.check(launches["K3"] == nscans and launches["K1"] > 0,
                  f"device route launches {launches} for {nscans} scans")
    diff = max_diff(got, ref)
    before = dict(jb.ROUTES)
    got = host_route()
    sync(dev)
    took = route_delta(jb.ROUTES, before)
    rec.check(took["host"] == len(streams),
              f"the Decoder's routes {took}, expected host")
    diff = max(diff, max_diff(got, ref))
    rec["max_abs_diff"] = diff
    rec.check(diff <= 1, f"max |diff| {diff} against the CPU decode > 1")
    del got
    rec["passes"] = run_turns(
        {"prog_device_images_per_s": rate_of(device_route, len(streams), dev),
         "prog_host_images_per_s": rate_of(host_route, len(streams), dev)},
        sz.passes)
    traced(device_route, 1, rec, dev)
    return rec


def section_jpeg_encode(args, sz, dev):
    """The decoded images, on the device and on the host, through the
    device route and the host route of the JPEG encoder."""
    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be

    rec = Record("jpeg_encode", dev)
    _photos, _uniq, jpgs = jpeg_corpus(sz, args.seed)
    dec = nic.Decoder(device=dev)
    decoded = dec.decode(jpgs[:sz.encode_n])
    rec.count(decoded)
    on_card = [im.array for im in decoded]
    on_host = [t.cpu().numpy() for t in on_card]
    rec["corpus"] = (f"{len(on_card)} decoded {sz.hw[0]}x{sz.hw[1]} images, "
                     f"q{QUALITY} 4:2:0")
    params = jpeg_params()
    encs = {"device": nic.Encoder(device=dev),
            "host": nic.Encoder(device=dev, options=(
                "cuda_jpeg_hybrid_encoder:device_stage=false"))}
    images = {"card": on_card, "host": on_host}

    def encode(where, route):
        out = encs[route].encode(images[where], "jpeg", params)
        rec.count(out)
        return out

    worst = math.inf
    for where in images:
        for route in encs:
            before = dict(be.ROUTES)
            streams = encode(where, route)
            took = route_delta(be.ROUTES, before)
            rec.check(took[route] == len(on_card),
                      f"{where} images, {route} route: routes {took}")
            back = dec.decode([s for s in streams if s is not None])
            rec.count(back)
            worst = min(worst, psnr_min(back, on_card)
                        if None not in streams else 0.0)
    rec["psnr_min_db"] = worst
    rec.check(worst >= PSNR_BAR_DB, f"PSNR {worst:.2f} dB < {PSNR_BAR_DB}")
    routes = {f"{where}_{route}_route_images_per_s": rate_of(
                  lambda w=where, r=route: encode(w, r), len(on_card), dev)
              for where in images for route in encs}
    rec["passes"] = run_turns(routes, sz.passes)
    traced(lambda: encode("card", "device"), 1, rec, dev)
    if dev.type == "cuda":
        rec.check(rec.get("launches", {}).get("FDCT", 0) > 0,
                  f"device route launches {rec.get('launches')}")
    rec["idle"] = idle_share(lambda: encode("card", "device"), dev)
    return rec


def section_transcode(args, sz, dev):
    """decode_batches at depth 2, a stacked bilinear resize on the device,
    Encoder.encode (device route)."""
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.ops.resize import resize
    from nvimagecodec_tpu_torch.pipeline import decode_batches

    rec = Record("transcode", dev)
    _photos, _uniq, jpgs = jpeg_corpus(sz, args.seed)
    nb, per = sz.transcode
    batches = [jpgs[b * per:(b + 1) * per] for b in range(nb)]
    hw = sz.resize_hw
    rec["corpus"] = (f"{nb * per} streams as {nb} batches of {per}, depth "
                     f"2, resize to {hw}x{hw}, q{QUALITY} 4:2:0")
    dec, enc = nic.Decoder(device=dev), nic.Encoder(device=dev)
    params = jpeg_params()

    def one_pass(keep=None):
        for batch in decode_batches(batches, decoder=dec, drop_failed=False,
                                    depth=2):
            rec.count(batch)
            if None in batch:
                continue
            small = resize(torch.stack([im.array for im in batch]), hw, hw,
                           "bilinear")
            out = enc.encode(list(small), "jpeg", params)
            rec.count(out)
            if keep is not None:
                keep.append((small, out))

    before, before_enc = dict(jb.ROUTES), dict(be.ROUTES)
    keep = []
    one_pass(keep)
    sync(dev)
    took = route_delta(jb.ROUTES, before)
    took_enc = route_delta(be.ROUTES, before_enc)
    rec["routes"] = {**took, "encode_device": took_enc["device"]}
    rec.check(took["idx"] == nb * per and took_enc["device"] == nb * per,
              f"decode routes {took}, encode routes {took_enc}")
    worst = math.inf
    for small, out in keep:
        back = dec.decode([s for s in out if s is not None])
        rec.count(back)
        worst = min(worst, psnr_min(back, list(small))
                    if None not in out else 0.0)
    del keep
    rec["psnr_min_db"] = worst
    rec.check(worst >= PSNR_BAR_DB, f"PSNR {worst:.2f} dB < {PSNR_BAR_DB}")
    rec["passes"] = run_turns(
        {"images_per_s": rate_of(one_pass, nb * per, dev)}, sz.passes)
    traced(one_pass, nb, rec, dev)
    return rec


def section_j2k(args, sz, dev):
    """Lossless J2K through the Decoder, device pixel stage against the host
    pixel stage (and one-thread openjpeg where it loads)."""
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k
    from util import make_photo

    rec = Record("j2k", dev)
    n, hw, levels = sz.j2k_n, sz.j2k_hw, sz.j2k_levels
    photos = [make_photo(hw, hw, seed=args.seed + k) for k in range(n)]
    with ThreadPoolExecutor(4) as pool:
        streams = list(pool.map(
            lambda im: j2k.encode_j2k(im, reversible=True, levels=levels,
                                      stream_type="j2k"), photos))
    rec["corpus"] = (f"{n} lossless {hw}x{hw} RGB, {levels} levels, "
                     f"{sum(map(len, streams)) // n} B mean")
    opt = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage="
    decs = {"device": nic.Decoder(device=dev, options=opt + "true"),
            "host": nic.Decoder(device=dev, options=opt + "false")}

    def decode(route):
        out = decs[route].decode(streams)
        rec.count(out)
        return out

    for route in decs:
        before = dict(j2k.ROUTES)
        out = decode(route)
        sync(dev)
        took = route_delta(j2k.ROUTES, before)
        rec.check(took[route] == n, f"{route} stage: routes {took}")
        same = all(im is not None and torch.equal(
            im.array.cpu(), torch.from_numpy(p)) for im, p in zip(out, photos))
        rec.check(same, f"{route} stage: an image is not its photo")
    routes = {f"decode_{r}_stage_images_per_s": rate_of(
        lambda r=r: decode(r), n, dev) for r in decs}
    try:
        from nvimagecodec_tpu_torch.native import opj_bridge

        opj_bridge.decode(streams[0])

        def openjpeg():
            for s in streams:
                opj_bridge.decode(s)
        routes["openjpeg_1t_images_per_s"] = rate_of(openjpeg, n, dev)
    except Exception as e:  # no system libopenjp2, or no compiler
        rec["skipped"]["openjpeg"] = f"no opj_bridge: {type(e).__name__}"
    rec["passes"] = run_turns(routes, sz.passes)
    traced(lambda: decode("device"), 1, rec, dev)
    return rec


@contextlib.contextmanager
def capture(module, name: str, calls: list, prepare=None):
    """Wrap module.name so that each call appends its arguments (through
    prepare(args), when given, before the call) to `calls`."""
    real = getattr(module, name)

    def wrapper(*args):
        calls.append(prepare(args) if prepare else args)
        return real(*args)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def section_kernels(args, sz, dev):
    """K1, K2, K3 and fdct_quant_blocks alone on the inputs the main paths
    give them (captured from one run of each path), CUDA events behind a
    spin kernel, so that the events see the card and not the host's pace of
    launching; each beside its bound, computed as chip_smoke.py computes it:
    the larger of the bytes moved once over the memory rate and the
    operations over the fp32 rate (K2 and K3: bytes alone)."""
    import torch

    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from chip_smoke import (
        FP32_FLOPS,
        HBM_BYTES_PER_S,
        bytes_bound_ms,
        cuda_ms,
        k3_bytes,
    )
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
    from nvimagecodec_tpu_torch.codecs.jpeg import encode, pixel
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from nvimagecodec_tpu_torch.ops import kernels

    rec = Record("kernels", dev)
    if dev.type != "cuda":
        raise RuntimeError("the kernels are timed on a card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    _photos, _uniq, jpgs = jpeg_corpus(sz, args.seed)
    dec = nic.Decoder(device=dev)
    k1, k2, k3, fd = [], [], [], []
    with capture(pixel, "dequant_idct_blocks", k1), \
            capture(jb, "decode_segments_into", k2):
        imgs = dec.decode(jpgs[:sz.batch])
    with capture(encode, "fdct_quant_blocks", fd):
        nic.Encoder(device=dev).encode([im.array for im in imgs], "jpeg",
                                       jpeg_params())
    prog = torch_corpus.progressive_streams()[0]

    def before(a):  # K3 works in place: keep the planes as they were
        return a[:5] + ([p.clone() for p in a[5]],) + a[6:]

    with capture(de, "decode_prog_scan_into", k3, before):
        de.decode_progressive_device(jb.parse_jpeg_structure(prog), prog,
                                     dev)
    sync(dev)
    out = {}
    # K1: coefficients read, int32 samples written, the matrix; 2 * K * 64
    # operations a block
    ms = sum(cuda_ms(lambda i, a=a: kernels.dequant_idct_blocks(*a), 20,
                     hold_ms=HOLD_MS) for a in k1)
    by_bytes = sum(bytes_bound_ms(a[0], a[1]) + a[0].numel() * 4
                   / HBM_BYTES_PER_S * 1e3 for a in k1)
    by_ops = sum(2 * a[0].numel() * 64 for a in k1) / FP32_FLOPS * 1e3
    out["K1"] = (ms, by_bytes, by_ops, len(k1))
    # K2: words, side, tables, lookahead rows read; stacks and err written
    (a,) = k2
    stacks, _err = ek.decode_segments_into(*a)
    ms = cuda_ms(lambda i: ek.decode_segments_into(*a), 10, hold_ms=HOLD_MS)
    by_bytes = (bytes_bound_ms(*a[:4], *stacks)
                + a[1].shape[1] * 4 / HBM_BYTES_PER_S * 1e3)
    out["K2"] = (ms, by_bytes, 0.0, 1)
    # K3: every scan of one stream, each launch on fresh planes
    ms = 0.0
    for kind, words, side, tables, look, planes, *geom in k3:
        copies = [[p.clone() for p in planes] for _ in range(21)]
        ms += cuda_ms(lambda i: ek.decode_prog_scan_into(
            kind, words, side, tables, look, copies[i], *geom), 20,
            hold_ms=HOLD_MS)
    by_bytes = sum(k3_bytes((c[0], c[1:5], c[5], tuple(c[6:])))
                   for c in k3) / HBM_BYTES_PER_S * 1e3
    out["K3"] = (ms, by_bytes, 0.0, len(k3))
    # fdct_quant_blocks: samples read, int32 coefficients written, the
    # matrix; 2 * 64 * 64 operations a block
    ms = sum(cuda_ms(lambda i, a=a: kernels.fdct_quant_blocks(*a), 20,
                     hold_ms=HOLD_MS) for a in fd)
    by_bytes = sum(bytes_bound_ms(x, M) + x.numel() * 4
                   / HBM_BYTES_PER_S * 1e3 for x, M in fd)
    by_ops = sum(x.numel() // 64 * 2 * 64 * 64 for x, _ in fd) \
        / FP32_FLOPS * 1e3
    out["FDCT"] = (ms, by_bytes, by_ops, len(fd))
    rec["kernels"] = {
        k: {"ms": ms, "bound_ms": max(b, o),
            "bound_by": "bytes" if b >= o else "operations", "calls": n}
        for k, (ms, b, o, n) in out.items()}
    rec["shapes"] = {"K1": [list(a[0].shape) for a in k1],
                     "K2": list(k2[0][0].shape),
                     "FDCT": [list(x.shape) for x, _ in fd]}
    return rec


def run_section(name: str, args) -> int:
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device")
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    require_built(dev)
    sz = Sizes(args.quick)
    t0 = time.perf_counter()
    rec = globals()[f"section_{name}"](args, sz, dev)
    rec["seconds"] = time.perf_counter() - t0
    rec.emit()
    return 0


# --------------------------------------------------------------------------
# the parent: build, run each configuration, print the summary last
# --------------------------------------------------------------------------

def build(device) -> float:
    """Both libraries, side by side, where they are missing or older than
    their sources; returns the seconds taken."""
    from nvimagecodec_tpu_torch import _build, native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.lib)
        if device.type == "cuda":
            _build.lib()
        host.result()
    return time.perf_counter() - t0


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "count": 1}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = smi.splitlines()[0].rsplit(",", 1)
    return {"platform": "gpu", "name": name.strip(),
            "power_limit": limit.strip(), "count": torch.cuda.device_count()}


def run_child(name: str, args, limit: float):
    """One section in its own process: (its record, None) or (None, why it
    failed). Its stderr goes to ours as it runs."""
    cmd = [sys.executable, os.path.abspath(__file__), "--section", name,
           "--device", args.device, "--seed", str(args.seed)]
    if args.quick:
        cmd.append("--quick")
    if limit <= 0:
        return None, "no time left in the run"
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                           timeout=limit, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return None, f"timed out after {limit:.0f} s"
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        return None, f"exit code {r.returncode}"
    try:
        return json.loads(lines[-1]), None
    except json.JSONDecodeError:
        return None, "no JSON last line"


def _r(x, digits: int = 3):
    """A number for the last line: `digits` significant digits, an int from
    10 ** (digits - 1) on."""
    return (round(x) if abs(x) >= 10 ** (digits - 1)
            else float(f"{x:.{digits}g}"))


def summary(dev_info, seed, setup_s, records, failed, skipped) -> dict:
    """The last line: every metric as median / q1 / q3 / n, per-layer ms per
    batch, idle shares and kernel times beside their bounds."""
    out = {"device": dev_info, "seed": seed, "setup_s": _r(setup_s)}
    attempted = failures = 0
    correct = not failed
    idle, kernels = {}, {}
    for name, rec in records.items():
        attempted += rec["attempted"]
        failures += rec["failures"]
        correct = correct and rec["correct"]
        skipped.update(rec["skipped"])
        if name == "kernels":
            kernels = {k: [_r(v["ms"]), _r(v["bound_ms"]), v["bound_by"][0],
                           records.get(KERNEL_PATHS[k], {}).get(
                               "launches", {}).get(k, 0)]
                       for k, v in rec["kernels"].items()}
            continue
        entry = {}
        for metric, xs in rec["passes"].items():
            med, q1, q3, n = quartiles(xs)
            entry[metric] = [_r(med), _r(q1), _r(q3), n]
        if rec.get("ms_per_batch"):
            entry["ms"] = {k: _r(v, 2)
                           for k, v in rec["ms_per_batch"].items()}
        if rec.get("bytes_per_batch"):
            entry["MB"] = {k.split("_")[0]: _r(v / 1e6, 2)
                           for k, v in rec["bytes_per_batch"].items()}
        if "idle" in rec:
            v = rec["idle"]
            idle[name] = v if isinstance(v, str) else [
                _r(v["busy_ms"]), _r(v["wall_ms"]), _r(v["share"])]
        out[name] = entry
    out.update({"correct": correct and failures == 0, "attempted": attempted,
                "failures": failures})
    out["idle"] = idle or "not measured"
    out["kernels"] = kernels or "not measured"
    out["skipped"] = skipped
    out["failed"] = failed
    out["legend"] = ("[median,q1,q3,n]; ms,MB a batch; idle [busy,wall ms,"
                     "share]; kernels [ms,bound,by,launches]")
    return out


def last_line(out: dict) -> str:
    """The summary as one line of under MAX_LINE characters: where it is
    longer, the per-layer bytes and then the per-layer ms of the later
    configurations give way (every section's own line above keeps them)."""
    line = json.dumps(out, separators=(",", ":"))
    names = [s for s, _ in SECTIONS if isinstance(out.get(s), dict)]
    for key in ("MB", "ms"):
        for name in reversed(names):
            if len(line) < MAX_LINE:
                return line
            if out[name].pop(key, None) is not None:
                out.setdefault("trimmed", []).append(f"{name}.{key}")
                line = json.dumps(out, separators=(",", ":"))
    if len(line) >= MAX_LINE:
        raise RuntimeError(f"the summary line has {len(line)} characters")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="a tiny corpus and 4 passes (the CPU test)")
    ap.add_argument("--section", choices=[s for s, _ in SECTIONS])
    args = ap.parse_args(argv)
    if args.section:
        return run_section(args.section, args)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("bench_torch: no CUDA device; --device cpu runs the plain "
            "versions on the CPU")
        return 2
    sys.path.insert(0, ROOT)
    t_end = time.perf_counter() + RUN_LIMIT_S
    dev_info = card(dev)
    log(f"bench_torch: {dev_info}")
    records, failed, skipped = {}, [], {}
    try:
        setup_s = build(dev)
    except Exception as e:  # nvcc or c++ failed: no section can run
        log(f"bench_torch: build failed: {e}")
        setup_s, failed = 0.0, ["build"]
    log(f"bench_torch: libraries built in {setup_s:.2f} s")
    for name, limit in ([] if failed else SECTIONS):
        if name == "kernels" and dev.type != "cuda":
            skipped["kernels"] = "no card: the kernels are timed on one"
            continue
        t0 = time.perf_counter()
        rec, why = run_child(name, args,
                             min(limit, t_end - time.perf_counter()))
        if rec is None:
            failed.append(name)
            log(f"bench_torch: section {name} failed: {why}")
            continue
        records[name] = rec
        print(f"[{name}] {json.dumps(rec)}", flush=True)
        log(f"bench_torch: section {name} done in "
            f"{time.perf_counter() - t0:.1f} s, correct {rec['correct']}")
    line = last_line(summary(dev_info, args.seed, setup_s, records, failed,
                             skipped))
    print(line, flush=True)
    return 0 if json.loads(line)["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
