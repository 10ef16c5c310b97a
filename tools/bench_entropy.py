"""K2 and K3 (Huffman decode, csrc/huffman.cu and csrc/prog_huffman.cu) alone
on one NVIDIA GPU: build, check, time.

    python3 tools/bench_entropy.py [--images 256] [--reps 20] [--sweep]

Needs one CUDA device and nvcc. It prints the card's name and power limit
and what ptxas says of the two kernels (registers, shared memory, spills),
then, on inputs that lie on the card before the clock starts:

- K2 on the idx bucket (`--images` baseline 4:2:0 JPEGs of 375x500 at q85
  made by the port's encoder, index-scanned and packed as the idx route
  does) and on the dri bucket (the committed restart-marker streams of
  tests/torch_corpus, split as the dri route does): bit-exact against the
  plain version on a 4-image bucket with one corrupted lane, then timed on
  the full bucket with CUDA events over `--reps` launches;
- K3 on every scan of the first committed progressive stream, on the inputs
  the progressive route builds: planes and flags bit-exact against the
  plain version, clean and with one corrupted lane, then each scan timed
  (every launch on a fresh copy of the planes as they were before that
  scan) and summed per kind;
- with `--sweep`, the same timings over K2's lanes a warp, warps a CTA and
  lookahead bits, which is how the defaults in ops/entropy_kernels.py were
  chosen.

Times stand beside the bound: the bytes each kernel must move (every input
read once, every output written once; for K3 only the band positions of the
blocks it touches) over 3.35 TB/s. The last line is one JSON object with the
numbers. Any failed check raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
H, W, QUALITY, SEEDS = 375, 500, 85, 8
KINDS = ("dc", "dcref", "ac", "acref")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k3_bytes(call) -> int:
    """Bytes one K3 launch must move: words, side, tables, lookahead rows and
    flags once; of the planes, coefficient 0 of every block of a DC scan
    (read too by a refinement) and positions ss..se of every block of the
    AC scan's grid (read too by a refinement)."""
    kind, (words, side, tables, look), planes, geom = call
    R, hv, mcus_x, ci, grid, ss, se, al = geom
    if ss == 0:
        coefs = sum(p.shape[0] * p.shape[1] for p in planes)
    else:
        coefs = grid[0] * grid[1] * (se - ss + 1)
    moved = 2 if kind in ("dcref", "acref") else 1
    return (nbytes(words, side, tables, look) + side.shape[1] * 4
            + coefs * 2 * moved)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_entropy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from nvimagecodec_tpu_torch import _build
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from util import make_photo

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    for name in ("huffman.cu", "prog_huffman.cu"):
        src = os.path.join(ROOT, "nvimagecodec_tpu_torch", "csrc", name)
        r = subprocess.run(
            [_build._nvcc(), "-gencode", _build._ARCH, "-std=c++17", "-O3",
             "-Xptxas", "-v", "-c", src, "-o", os.devnull],
            capture_output=True, text=True)
        print(r.stderr.strip(), flush=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name} does not compile")
    print(f"build: {_build.build():.2f} s", flush=True)

    def cuda_ms(fn, reps, hold_ms=20.0):
        """Mean milliseconds of fn(i), i = 0..reps-1, after one warm-up. The
        launches queue up behind a kernel that spins hold_ms, so the events
        see the card's time alone and not the host's pace of launching (a
        small kernel runs shorter than its wrapper)."""
        fn(0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(hold_ms * 2.0e6))  # >= hold_ms below 2 GHz
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms > hold_ms * 0.5:
            raise RuntimeError(f"the host took {host_ms:.2f} ms to launch "
                               f"behind a spin of {hold_ms} ms")
        return start.elapsed_time(end) / reps

    # -- K2 ---------------------------------------------------------------
    params = nic.EncodeParams(
        quality=QUALITY, chroma_subsampling=nic.ChromaSubsampling.CSS_420,
        jpeg=nic.JpegEncodeParams(optimized_huffman=False))
    uniq = nic.Encoder(device="cpu").encode(
        [make_photo(H, W, seed=s) for s in range(SEEDS)], "jpeg", params)
    buckets = {"idx": [uniq[i % SEEDS] for i in range(args.images)],
               "dri": [torch_corpus.dri_streams()[i % SEEDS]
                       for i in range(args.images)]}

    def k2_args(kind, jpgs, n, look_bits=None):
        """`decode_segments_into`'s arguments for the first n streams, on
        the card, split as the route of that kind splits them."""
        frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs[:n])}
        raws = dict(enumerate(jpgs[:n]))
        f0 = frames[0]
        _k, _key, R, nsegs = jb.route_plan(f0)
        if kind == "idx":
            ok, bad, bad_scan, words, side = jb.split_indexed(
                list(range(n)), frames, raws, R, nsegs, dev)
            if len(ok) != n or bad or bad_scan:
                raise RuntimeError("index scan rejected corpus samples")
        else:
            bad, words, side = jb.split_dri(list(range(n)), frames, raws,
                                            nsegs, dev)
            if bad:
                raise RuntimeError("dri split rejected corpus samples")
        R, _cmap, tables = ek.huffman_tables(f0, R)
        look = ek.lookahead_tables(tables, look_bits or ek.LOOK_BITS)
        mx = -(-f0.width // (8 * f0.hmax))
        my = -(-f0.height // (8 * f0.vmax))
        return (words.to(dev), side.to(dev), torch.from_numpy(tables).to(dev),
                torch.from_numpy(look).to(dev), R,
                [(c.h, c.v) for c in f0.components], mx, my, n, nsegs)

    def k2_check(a):
        stacks, err = ek.decode_segments_into(*a)
        want, err_p = ek.decode_segments_into_plain(*a[:3], *a[4:])
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(stacks, want))
                and torch.equal(err, err_p)):
            raise RuntimeError("K2 differs from its plain version")
        return err

    result = {"card": card, "images": args.images, "k2": {}, "k3": {}}
    k2_full = {}
    for kind, jpgs in buckets.items():
        a4 = k2_args(kind, jpgs, 4)
        if int(k2_check(a4).sum()) != 0:
            raise RuntimeError(f"K2 flagged clean {kind} lanes")
        bad = list(a4)
        bad[0] = a4[0].clone()
        bad[0][3:7, 5] = -1  # no Huffman code is sixteen 1 bits
        if int(k2_check(bad)[5]) != 1:
            raise RuntimeError(f"K2 did not flag the corrupted {kind} lane")
        a = k2_args(kind, jpgs, args.images)
        k2_full[kind] = a
        stacks, err = ek.decode_segments_into(*a)
        ms = cuda_ms(lambda i: ek.decode_segments_into(*a), args.reps)
        ms2 = cuda_ms(lambda i: ek.decode_segments_into(*a), args.reps)
        bound = nbytes(*a[:4], err, *stacks) / HBM_BYTES_PER_S * 1e3
        result["k2"][kind] = {"lanes": a[8] * a[9], "words": list(a[0].shape),
                              "ms": ms, "ms_again": ms2, "bound_ms": bound}
        print(f"K2 {kind}: words {tuple(a[0].shape)}, {a[8] * a[9]} lanes; "
              f"bit-exact vs plain on a 4-image bucket, clean and with a "
              f"corrupted lane; kernel {ms:.4f} ms (again {ms2:.4f}), bound "
              f"by bytes {bound:.4f}", flush=True)

    # -- K3 ---------------------------------------------------------------
    data = torch_corpus.progressive_streams()[0]
    frame = jb.parse_jpeg_structure(data)
    calls = []  # (kind, (words, side, tables, look), planes before, geometry)
    real = de.decode_prog_scan_into

    def capture(kind, words, side, tables, look, planes, *geom):
        calls.append((kind, (words, side, tables, look),
                      [p.clone() for p in planes], geom))
        return real(kind, words, side, tables, look, planes, *geom)

    de.decode_prog_scan_into = capture
    try:
        de.decode_progressive_device(frame, data, dev)
    finally:
        de.decode_prog_scan_into = real

    def k3_check(kind, inputs, before, geom):
        mine = [p.clone() for p in before]
        want = [p.clone() for p in before]
        err = ek.decode_prog_scan_into(kind, *inputs, mine, *geom)
        err_p = ek.decode_prog_scan_into_plain(kind, *inputs[:3], want, *geom)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(mine, want))
                and torch.equal(err, err_p)):
            raise RuntimeError(f"K3 {kind} differs from its plain version")
        return err

    first = set()  # a later band's lane may end before the corrupted words
    for kind, inputs, before, geom in calls:
        if int(k3_check(kind, inputs, before, geom).sum()) != 0:
            raise RuntimeError(f"K3 flagged clean {kind} lanes")
        bad = (inputs[0].clone(),) + inputs[1:]
        bad[0][1:5, 3] = -1
        err = k3_check(kind, bad, before, geom)
        if kind in ("dc", "ac") and kind not in first and int(err[3]) != 1:
            raise RuntimeError(f"K3 did not flag the corrupted {kind} lane")
        first.add(kind)
    print(f"K3: {len(calls)} scans, kinds "
          f"{sorted({c[0] for c in calls})}: planes and flags bit-exact vs "
          "plain, clean and with a corrupted lane", flush=True)

    def k3_times():
        ms = dict.fromkeys(KINDS, 0.0)
        for kind, inputs, before, geom in calls:
            copies = [[p.clone() for p in before]
                      for _ in range(args.reps + 1)]
            ms[kind] += cuda_ms(
                lambda i: ek.decode_prog_scan_into(kind, *inputs, copies[i],
                                                   *geom), args.reps)
        return ms

    ms, ms2 = k3_times(), k3_times()
    kind, inputs, before, geom = calls[-1]
    copies = [p.clone() for p in before]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        ek.decode_prog_scan_into(kind, *inputs, copies, *geom)
    host_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    bound = {k: sum(k3_bytes(c) for c in calls if c[0] == k)
             / HBM_BYTES_PER_S * 1e3 for k in KINDS}
    result["k3"] = {"scans": len(calls), "ms": ms, "ms_again": ms2,
                    "bound_ms": bound, "total_ms": sum(ms.values()),
                    "total_bound_ms": sum(bound.values()),
                    "host_ms_per_launch": host_ms}
    print("K3, summed over the scans of one stream: " + "; ".join(
        f"{k} {ms[k]:.4f} ms (again {ms2[k]:.4f}, bound {bound[k]:.5f})"
        for k in KINDS) + f"; together {sum(ms.values()):.4f} ms; one call "
        f"of the wrapper costs the host {host_ms:.4f} ms", flush=True)

    # -- launch shapes and lookahead bits ------------------------------------
    if args.sweep:
        sweep = {"k2": [], "k3": [], "look_bits": []}
        keep = (ek.K2_LANES_PER_WARP, ek.K2_WARPS, ek.K3_WARPS)
        try:
            for lpw in (1, 2, 4, 8, 16, 32):
                for warps in (1, 2, 4, 8):
                    ek.K2_LANES_PER_WARP, ek.K2_WARPS = lpw, warps
                    row = {"lpw": lpw, "warps": warps}
                    for kind, a in k2_full.items():
                        row[kind] = cuda_ms(
                            lambda i: ek.decode_segments_into(*a), 10)
                    sweep["k2"].append(row)
                    print(f"K2 sweep: {row}", flush=True)
            for warps in (1, 2, 4, 8):
                ek.K3_WARPS = warps
                row = {"warps": warps, **k3_times()}
                sweep["k3"].append(row)
                print(f"K3 sweep: {row}", flush=True)
        finally:
            ek.K2_LANES_PER_WARP, ek.K2_WARPS, ek.K3_WARPS = keep
        for bits in (7, 8, 9, 10, 11):
            row = {"L": bits}
            for kind, jpgs in buckets.items():
                a = k2_args(kind, jpgs, args.images, bits)
                k2_check(k2_args(kind, jpgs, 4, bits))
                row[kind] = cuda_ms(lambda i: ek.decode_segments_into(*a), 10)
            sweep["look_bits"].append(row)
            print(f"lookahead sweep: {row}", flush=True)
        result["sweep"] = sweep

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
