"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (csrc/*.cu) with nvcc and the host library
(native/*.cpp) with c++, both from the sources in this checkout, then drives
the port's three device paths on the GPU and checks that each ran through
its kernels (launch counts set to 0 just before the path, read just after):

- main path: 256 baseline 4:2:0 JPEGs of 375x500 at q85 (the corpus
  bench.py times) through the public Decoder, idx route (K2, K1);
- dri path: the same photos with a restart marker every MCU row (committed
  in tests/torch_corpus), through the Decoder's dri route (K2, K1);
- prog path: 8 progressive streams (libjpeg's default script, restart
  interval 16; tests/torch_corpus) through `decode_progressive` (K3, K1).

It checks the images and coefficients against the CPU and the native host
decoder, holds each kernel against its plain PyTorch version on the card,
and times them beside their bound (the larger of bytes moved over 3.35 TB/s
and operations over the card's peak for their type) and, for K1, beside the
one library call that computes its product (`torch.matmul`, used nowhere in
the port). The second-to-last line is one JSON object describing the
kernels; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the exit code is not 0. Without a CUDA device it
exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 256
H, W = 375, 500
QUALITY = 85
SEEDS = 8
# NVIDIA's data sheet for the H100 SXM: device memory rate, and the fp32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
K1_GOAL_MS = 0.30  # the three main-path launches together


def bytes_bound_ms(*tensors) -> float:
    """Milliseconds to move each of `tensors` once at the memory rate."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / HBM_BYTES_PER_S * 1e3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch import _build, native
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg.device_entropy import (
        reassemble_components,
    )
    from nvimagecodec_tpu_torch.ops.entropy_kernels import (
        decode_segments,
        decode_segments_plain,
        huffman_tables,
    )
    from nvimagecodec_tpu_torch.ops.kernels import (
        ZIGZAG_NAT,
        dequant_idct_blocks,
        dequant_idct_blocks_plain,
        idct_matrix,
    )
    import torch_corpus
    from util import make_photo

    # plain versions on the card run full float32, as the kernels do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {card}")

    # 2) both libraries from the sources in this checkout, side by side
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        host = pool.submit(native.build)
        secs = _build.build()
        host.result()
        host_secs = time.perf_counter() - t0
    _build.lib()
    native.lib()
    phase("build", f"nvcc sm_90a {len(_build.sources())} sources in "
          f"{secs:.2f} s; c++ host library in {host_secs:.2f} s beside it")

    # 3) the corpus: 8 photos cycled, standard Huffman tables
    t0 = time.perf_counter()
    params = nic.EncodeParams(
        quality=QUALITY, chroma_subsampling=nic.ChromaSubsampling.CSS_420,
        jpeg=nic.JpegEncodeParams(optimized_huffman=False))
    photos = [make_photo(H, W, seed=s) for s in range(SEEDS)]
    uniq = nic.Encoder().encode(photos, "jpeg", params)
    if any(d is None for d in uniq):
        raise RuntimeError("corpus encode failed")
    jpgs = [uniq[i % SEEDS] for i in range(BATCH)]
    phase("corpus", f"{BATCH} streams {H}x{W} q{QUALITY} 4:2:0, "
          f"{sum(map(len, uniq)) // SEEDS} B mean, "
          f"{time.perf_counter() - t0:.2f} s")

    # 4) the main path, through the public API, GPU backend only
    dec = nic.Decoder(device="cuda",
                      backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])
    routes0 = dict(jb.ROUTES)
    counts_zero()
    imgs, k1_main_err, _shapes = k1_held(lambda: dec.decode(jpgs))
    torch.cuda.synchronize()
    launches = counts()
    routes = {k: jb.ROUTES[k] - routes0[k] for k in routes0}
    bad = [j for j, im in enumerate(imgs)
           if im is None or im.device.type != "cuda"
           or im.dtype != np.uint8 or im.shape != (H, W, 3)]
    if bad:
        raise RuntimeError(f"main path: {len(bad)} bad results, e.g. {bad[:4]}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise RuntimeError(f"main path missed a kernel: {launches}")
    if routes != {"idx": BATCH, "dri": 0, "host": 0, "reissued": 0}:
        raise RuntimeError(f"main path did not take the idx route: {routes}")
    if k1_main_err > 1:
        raise RuntimeError(f"main path: K1 vs plain max |diff| "
                           f"{k1_main_err} > 1")
    diff = max_diff(imgs, nic.Decoder(device="cpu").decode(jpgs[:SEEDS]))
    if diff > 1:
        raise RuntimeError(f"main path vs CPU host-route decode: {diff} > 1")
    phase("main_path", f"{BATCH}/{BATCH} CUDA uint8 [{H},{W},3] via idx "
          f"route; launches {launches}; all {BATCH} within {diff} of the "
          f"CPU decode (native host entropy + plain pixel stage); K1 vs plain "
          f"on every launch max |diff| {k1_main_err}")

    # K2's inputs for the full bucket and for a 4-image bucket
    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs)}
    raws = dict(enumerate(jpgs))
    plan = jb.route_plan(frames[0])
    _kind, _key, R, nsegs = plan
    R, comp_map, tables = huffman_tables(frames[0], R)
    tables_d = torch.from_numpy(tables).to(dev)

    def k2_inputs(n):
        split = jb.split_indexed(list(range(n)), frames, raws, R, nsegs, dev)
        ok, bad_pack, bad_scan, words, side = split
        if len(ok) != n or bad_pack or bad_scan:
            raise RuntimeError("index scan rejected corpus samples")
        return words.to(dev), side.to(dev)

    # 5) K2 against its plain version (4 images, then the full bucket) and
    # against the native host decoder (the full bucket)
    w4, s4 = k2_inputs(4)
    o_k, e_k = decode_segments(w4, s4, tables_d, R, comp_map)
    o_p, e_p = decode_segments_plain(w4, s4, tables_d, R, comp_map)
    if not (torch.equal(o_k, o_p) and torch.equal(e_k, e_p)):
        raise RuntimeError("K2 kernel differs from its plain version "
                           "(4-image bucket)")
    words, side = k2_inputs(BATCH)
    out, err = decode_segments(words, side, tables_d, R, comp_map)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, err_p = decode_segments_plain(words, side, tables_d, R, comp_map)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1000
    k2_err = max(int((out.int() - out_p.int()).abs().max()),
                 int((err - err_p).abs().max()))
    if not (torch.equal(out, out_p) and torch.equal(err, err_p)):
        raise RuntimeError(f"K2 kernel differs from its plain version on the "
                           f"full bucket: max |diff| {k2_err}")
    if int(err.sum()) != 0:
        raise RuntimeError(f"K2 flagged {int((err != 0).sum())} lanes")
    coefs = reassemble_components(out, frames[0], BATCH, nsegs, R)
    check_host_coefs(coefs, frames, raws, "K2 (idx)")
    phase("K2", f"words {tuple(words.shape)} -> out {tuple(out.shape)}: "
          f"bit-exact vs plain (4-image and {BATCH}-image buckets, out and "
          f"err, max |diff| {k2_err}) and vs native host coefficients (all "
          f"{BATCH} samples); 0 err flags")

    # 6) K1 at the main path's shapes (zigzag coefficients from K2)
    k1_err = k1_main_err
    k1_in = []
    nat_of_zz = torch.from_numpy(ZIGZAG_NAT.astype(np.int64)).to(dev)
    for c, comp in zip(coefs, frames[0].components):
        x = c.contiguous()
        M = idct_matrix(frames[0].quant[comp.tq], dev)
        got = dequant_idct_blocks(x, M, 8, zigzag=True)
        want = dequant_idct_blocks_plain(x, M, 8, zigzag=True)
        k1_err = max(k1_err, int((got - want).abs().max()))
        nat = torch.empty_like(x)
        nat[..., nat_of_zz] = x  # the same blocks in natural order
        if not torch.equal(dequant_idct_blocks(nat, M, 8, zigzag=False), got):
            raise RuntimeError("K1: natural and zigzag input of the same "
                               "blocks give different samples")
        del want, nat
        k1_in.append((x, M))
    if k1_err > 1:
        raise RuntimeError(f"K1 kernel vs plain: max |diff| {k1_err} > 1")
    phase("K1", "shapes " + ", ".join(str(tuple(x.shape)) for x, _ in k1_in)
          + f": max |kernel - plain| = {k1_err} (bar 1); natural and zigzag "
          "input give identical samples")

    # 7) the dri path: restart-marker streams through the Decoder
    dri = dri_phase(dec, dev)

    # 8) K3 against its plain version, every scan of two streams
    prog = torch_corpus.progressive_streams()
    k3 = k3_phase(prog[:2], dev)

    # 9) the prog path: 8 progressive streams through decode_progressive
    prog_ips = prog_phase(prog, dev)

    # 10) times (informational; no claim)
    k1_ms = sum(cuda_ms(lambda x=x, M=M: dequant_idct_blocks(x, M, 8, True),
                        20) for x, M in k1_in)
    k1_plain_ms = sum(
        cuda_ms(lambda x=x, M=M: dequant_idct_blocks_plain(x, M, 8, True), 5)
        for x, M in k1_in)
    # the library call beside K1: the same product in fp32, nothing else
    k1_lib_ms = 0.0
    for x, M in k1_in:
        a32 = x.reshape(-1, 64).to(torch.float32)
        mt = M.T.contiguous()
        k1_lib_ms += cuda_ms(lambda a32=a32, mt=mt: torch.matmul(a32, mt), 20)
        del a32
    # K1's bound: every coefficient read and every int32 sample written
    # once, M once a launch, against 2 * K * 64 fp32 operations a block
    k1_blocks = [x.numel() // x.shape[-1] for x, _ in k1_in]
    k1_bytes_ms = (sum(bytes_bound_ms(x, M) for x, M in k1_in)
                   + sum(k1_blocks) * 64 * 4 / HBM_BYTES_PER_S * 1e3)
    k1_ops_ms = sum(2 * x.numel() * 64 for x, _ in k1_in) / FP32_FLOPS * 1e3
    k1_bound_ms = max(k1_bytes_ms, k1_ops_ms)
    k2_ms = cuda_ms(lambda: decode_segments(words, side, tables_d, R,
                                            comp_map), 10)
    # K2 and K3 walk their bits in series with integer operations, for which
    # the data sheet names no peak: their bound is the bytes alone
    k2_bound_ms = bytes_bound_ms(words, side, tables_d, out, err)
    dec.decode(jpgs)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        dec.decode(jpgs)
    torch.cuda.synchronize()
    ips = reps * BATCH / (time.perf_counter() - t0)
    phase("times", f"on {card}: main path {ips:.1f} images/s; dri path "
          f"{dri['ips']:.1f} images/s; K1's {launches['K1']} main-path "
          f"launches together {k1_ms:.4f} ms (goal <= {K1_GOAL_MS}: "
          f"{'met' if k1_ms <= K1_GOAL_MS else 'missed'}; torch.matmul "
          f"{k1_lib_ms:.4f}; plain {k1_plain_ms:.4f}; bound "
          f"{k1_bound_ms:.4f}, bytes {k1_bytes_ms:.4f} / operations "
          f"{k1_ops_ms:.4f}); K2 {k2_ms:.4f} ms (plain {k2_plain_ms:.1f}, "
          f"one run; bound by bytes {k2_bound_ms:.4f}); K2 on the dri bucket "
          f"{dri['k2_ms']:.4f} ms")
    phase("times", f"on {card}: K3 per kind, summed over the scans of one "
          f"stream, kernel (plain, one run): " + "; ".join(
              f"{kd} {k3['ms'][kd]:.4f} ms ({k3['plain_ms'][kd]:.1f})"
              for kd in K3_KINDS))
    phase("times", f"on {card}: progressive entropy decode, "
          f"decode_progressive_device {prog_ips['device']:.1f} images/s "
          f"against the native host entropy decoder {prog_ips['host']:.1f} "
          f"images/s "
          f"(x{prog_ips['device'] / prog_ips['host']:.3f})")

    loaded = [m for m in sys.modules
              if m == "jax" or m.split(".")[0] == "nvimagecodec_tpu"]
    if loaded:
        raise RuntimeError(f"the port imported {loaded[:4]}")
    print(json.dumps({"kernels": [
        {"name": "K1 dequant_idct_blocks", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/idct.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_kernels.py:23",
         "launches": launches["K1"],
         "max_abs_err": max(k1_err, dri["k1_err"], prog_ips["k1_err"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
         "library_ms": k1_lib_ms,
         "launches_by_path": {"main": launches["K1"],
                              "dri": dri["launches"]["K1"],
                              "prog": prog_ips["launches"]["K1"]}},
        {"name": "K2 decode_segments", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/huffman.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_entropy.py:120",
         "launches": launches["K2"], "max_abs_err": max(k2_err,
                                                         dri["k2_err"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {"main": launches["K2"],
                              "dri": dri["launches"]["K2"]}},
        {"name": "K3 decode_prog_scan", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/prog_huffman.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_entropy.py:493",
         "launches": prog_ips["launches"]["K3"], "max_abs_err": k3["err"],
         "ms": sum(k3["ms"].values()),
         "plain_ms": sum(k3["plain_ms"].values()),
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {"prog": prog_ips["launches"]["K3"]}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def counts_zero():
    """Set every kernel's launch count to 0."""
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from nvimagecodec_tpu_torch.ops import kernels

    kernels.dequant_idct_blocks.launches = 0
    ek.decode_segments.launches = 0
    ek.decode_prog_scan.launches = 0


def counts():
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from nvimagecodec_tpu_torch.ops import kernels

    return {"K1": kernels.dequant_idct_blocks.launches,
            "K2": ek.decode_segments.launches,
            "K3": ek.decode_prog_scan.launches}


def max_diff(imgs, ref) -> int:
    """Max |a - b| of every image against the reference decode of its
    photo (the corpora cycle SEEDS photos)."""
    return max(int((im.array.cpu().int()
                    - ref[j % SEEDS].array.int()).abs().max())
               for j, im in enumerate(imgs))


def check_host_coefs(coefs, frames, raws, label):
    """K2's reassembled [B, bh, bw, 64] zigzag coefficients of every sample
    against the native host decoder (sample j repeats at j, j + SEEDS, ...)."""
    import numpy as np
    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg.pixel import ZIGZAG_NAT

    dev = coefs[0].device
    nat = torch.from_numpy(np.argsort(ZIGZAG_NAT)).to(dev)
    for j in range(SEEDS):
        host = [np.empty((bh, bw, 64), np.int16)
                for (bw, bh) in frames[j].mcu_geometry()[2]]
        jb.decode_coefficients_into(frames[j], raws[j], host)
        for c, h in enumerate(host):
            mine = coefs[c][j::SEEDS].index_select(-1, nat)
            if not bool((mine == torch.from_numpy(h).to(dev)).all()):
                raise RuntimeError(f"{label} sample {j} component {c} "
                                   "differs from the native host decoder")


def k1_held(fn):
    """Run fn() with every K1 launch of the pixel stage held against
    dequant_idct_blocks_plain on the same inputs (the plain version
    launches no kernel). Returns (fn's result, max |kernel - plain|, the
    input shapes)."""
    from nvimagecodec_tpu_torch.codecs.jpeg import pixel
    from nvimagecodec_tpu_torch.ops.kernels import dequant_idct_blocks_plain

    real = pixel.dequant_idct_blocks
    err, shapes = [0], set()

    def both(x, M, *args):
        got = real(x, M, *args)
        want = dequant_idct_blocks_plain(x, M, *args)
        err[0] = max(err[0], int((got - want).abs().max()))
        shapes.add(tuple(x.shape))
        return got

    pixel.dequant_idct_blocks = both
    try:
        return fn(), err[0], sorted(shapes)
    finally:
        pixel.dequant_idct_blocks = real


def dri_phase(dec, dev):
    """BATCH restart-marker streams (one restart interval per MCU row)
    through the Decoder's dri route, K1 held against its plain version on
    every launch; K2 against its plain version on a 4-image dri bucket and
    on the full bucket the route builds, and against the native host
    decoder. Returns the phase's numbers."""
    import numpy as np
    import torch

    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg.device_entropy import (
        reassemble_components,
    )
    from nvimagecodec_tpu_torch.ops.entropy_kernels import (
        decode_segments,
        decode_segments_plain,
        huffman_tables,
    )

    uniq = torch_corpus.dri_streams()
    jpgs = [uniq[i % SEEDS] for i in range(BATCH)]
    routes0 = dict(jb.ROUTES)
    counts_zero()
    imgs, k1_err, _shapes = k1_held(lambda: dec.decode(jpgs))
    torch.cuda.synchronize()
    launches = counts()
    routes = {k: jb.ROUTES[k] - routes0[k] for k in routes0}
    bad = [j for j, im in enumerate(imgs)
           if im is None or im.device.type != "cuda"
           or im.dtype != np.uint8 or im.shape != (H, W, 3)]
    if bad:
        raise RuntimeError(f"dri path: {len(bad)} bad results, e.g. {bad[:4]}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise RuntimeError(f"dri path missed a kernel: {launches}")
    if routes != {"idx": 0, "dri": BATCH, "host": 0, "reissued": 0}:
        raise RuntimeError(f"dri path did not take the dri route: {routes}")
    if k1_err > 1:
        raise RuntimeError(f"dri path: K1 vs plain max |diff| {k1_err} > 1")
    diff = max_diff(imgs, nic.Decoder(device="cpu").decode(jpgs[:SEEDS]))
    if diff > 1:
        raise RuntimeError(f"dri path vs CPU host-route decode: {diff} > 1")

    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs)}
    raws = dict(enumerate(jpgs))
    _kind, _key, R, nsegs = jb.route_plan(frames[0])
    R, comp_map, tables = huffman_tables(frames[0], R)
    tables_d = torch.from_numpy(tables).to(dev)
    bad_pos, w4, s4 = jb.split_dri(list(range(4)), frames, raws, nsegs, dev)
    if bad_pos:
        raise RuntimeError("dri split rejected corpus samples")
    w4, s4 = w4.to(dev), s4.to(dev)
    o_k, e_k = decode_segments(w4, s4, tables_d, R, comp_map)
    o_p, e_p = decode_segments_plain(w4, s4, tables_d, R, comp_map)
    k2_err = max(int((o_k.int() - o_p.int()).abs().max()),
                 int((e_k - e_p).abs().max()))
    if not (torch.equal(o_k, o_p) and torch.equal(e_k, e_p)):
        raise RuntimeError(f"K2 kernel differs from its plain version on a "
                           f"4-image dri bucket: max |diff| {k2_err}")
    if int(e_k.sum()) != 0:
        raise RuntimeError("K2 flagged lanes of the dri bucket")
    # the full bucket, as the route splits it (W from the first guess)
    split = jb.split_dri(list(range(BATCH)), frames, raws, nsegs, dev)
    if split is None or split[0]:
        raise RuntimeError("dri split rejected corpus samples")
    wb, sb = split[1].to(dev), split[2].to(dev)
    o_b, e_b = decode_segments(wb, sb, tables_d, R, comp_map)
    o_pb, e_pb = decode_segments_plain(wb, sb, tables_d, R, comp_map)
    k2_err = max(k2_err, int((o_b.int() - o_pb.int()).abs().max()),
                 int((e_b - e_pb).abs().max()))
    if not (torch.equal(o_b, o_pb) and torch.equal(e_b, e_pb)):
        raise RuntimeError(f"K2 kernel differs from its plain version on the "
                           f"{BATCH}-image dri bucket: max |diff| {k2_err}")
    if int(e_b.sum()) != 0:
        raise RuntimeError("K2 flagged lanes of the full dri bucket")
    check_host_coefs(reassemble_components(o_b, frames[0], BATCH, nsegs, R),
                     frames, raws, "K2 (dri)")
    k2_ms = cuda_ms(lambda: decode_segments(wb, sb, tables_d, R, comp_map),
                    10)
    phase("dri_path", f"{BATCH}/{BATCH} CUDA uint8 [{H},{W},3] via dri route "
          f"(restart interval {torch_corpus.DRI_RI} MCUs, {nsegs} segments "
          f"each, words {tuple(wb.shape)}); launches {launches}; all {BATCH} "
          f"within {diff} of the CPU decode; K1 vs plain on every launch max "
          f"|diff| {k1_err}; K2 bit-exact vs plain on 4-image and "
          f"{BATCH}-image dri buckets (out and err, max |diff| {k2_err}) and "
          f"vs native host coefficients (all {BATCH} samples)")
    dec.decode(jpgs)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        dec.decode(jpgs)
    torch.cuda.synchronize()
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err,
            "k2_ms": k2_ms, "ips": reps * BATCH / (time.perf_counter() - t0)}


K3_KINDS = ("dc", "dcref", "ac", "acref")


def k3_phase(streams, dev):
    """Every scan's K3 output against decode_prog_scan_plain on the card,
    on the inputs the progressive route builds; then each scan of the first
    stream timed (CUDA events) beside one plain run. Returns the phase's
    numbers."""
    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek

    real = de.decode_prog_scan
    calls = []

    def both(kind, *args):
        got = real(kind, *args)
        want = ek.decode_prog_scan_plain(kind, *args)
        calls.append((kind, args, got, want))
        return got

    err = 0
    de.decode_prog_scan = both
    try:
        for n, data in enumerate(streams):
            calls.clear()
            de.decode_progressive_device(jb.parse_jpeg_structure(data),
                                         data, dev)
            torch.cuda.synchronize()
            for kind, args, got, want in calls:
                for a, b in zip(got, want):
                    err = max(err, int((a.int() - b.int()).abs().max()))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"K3 {kind} differs from its plain "
                                       f"version (stream {n})")
            kinds = {c[0] for c in calls}
            if kinds != set(K3_KINDS):
                raise RuntimeError(f"K3 ran kinds {kinds} only")
            if n == 0:
                timed = list(calls)
    finally:
        de.decode_prog_scan = real
    ms = dict.fromkeys(K3_KINDS, 0.0)
    plain_ms = dict.fromkeys(K3_KINDS, 0.0)
    bound_ms = 0.0
    for kind, args, got, _want in timed:
        # words, side, tables, the band where there is one; out and err
        bound_ms += bytes_bound_ms(
            *(a for a in args if isinstance(a, torch.Tensor)), *got)
        ms[kind] += cuda_ms(lambda: ek.decode_prog_scan(kind, *args), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ek.decode_prog_scan_plain(kind, *args)
        torch.cuda.synchronize()
        plain_ms[kind] += (time.perf_counter() - t0) * 1000
    shapes = sorted({(c[0], tuple(c[2][0].shape)) for c in timed})
    phase("K3", f"{len(streams)} streams x {len(timed)} scans, kinds "
          f"{sorted({c[0] for c in timed})}, out shapes {shapes}: bit-exact vs "
          f"plain (out and err, max |diff| {err}), 0 err flags")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def prog_phase(streams, dev):
    """All streams through decode_progressive on the card, K1 held against
    its plain version on every launch: planes bit-exact against the native
    host decoder, pixels within 1 of the CPU decode.
    Then the entropy stage's rate against the host's, as bench.py measures
    it. Returns the phase's numbers."""
    import numpy as np
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
    from nvimagecodec_tpu_torch.codecs.jpeg.pixel import ZIGZAG_NAT

    counts_zero()
    imgs, k1_err, k1_shapes = k1_held(
        lambda: [jb.decode_progressive(d, dev) for d in streams])
    torch.cuda.synchronize()
    launches = counts()
    if launches["K3"] == 0 or launches["K1"] == 0:
        raise RuntimeError(f"prog path missed a kernel: {launches}")
    if k1_err > 1:
        raise RuntimeError(f"prog path: K1 vs plain max |diff| {k1_err} > 1")
    nscans = [len(jb.parse_jpeg_structure(d).scans) for d in streams]
    if launches["K3"] != sum(nscans):
        raise RuntimeError(f"prog path: {launches['K3']} K3 launches for "
                           f"{sum(nscans)} scans")
    ref = nic.Decoder(device="cpu").decode(streams)
    diff = 0
    for im, r in zip(imgs, ref):
        if (im.device.type != "cuda" or im.dtype != torch.uint8
                or tuple(im.shape) != (H, W, 3)):
            raise RuntimeError(f"prog path: bad image {im.dtype} "
                               f"{tuple(im.shape)} on {im.device}")
        diff = max(diff, int((im.cpu().int() - r.array.int()).abs().max()))
    if diff > 1:
        raise RuntimeError(f"prog path vs CPU decode: {diff} > 1")
    def host_planes(frame, d):
        """The native host decoder's natural-order coefficient planes."""
        out = [np.empty((bh, bw, 64), np.int16)
               for bw, bh in frame.mcu_geometry()[2]]
        jb.decode_coefficients_into(frame, d, out)
        return out

    nat = torch.from_numpy(np.argsort(ZIGZAG_NAT)).to(dev)
    for n, d in enumerate(streams):
        frame = jb.parse_jpeg_structure(d)
        planes = de.decode_progressive_device(frame, d, dev)
        for c, h in enumerate(host_planes(frame, d)):
            mine = planes[c].index_select(-1, nat)
            if tuple(mine.shape) != h.shape or not bool(
                    (mine == torch.from_numpy(h).to(dev)).all()):
                raise RuntimeError(f"prog stream {n} component {c} differs "
                                   "from the native host decoder")
    phase("prog_path", f"{len(streams)}/{len(streams)} progressive streams "
          f"({nscans[0]} scans each) CUDA uint8 [{H},{W},3]; launches "
          f"{launches}; planes bit-exact vs the native host decoder; pixels "
          f"within {diff} of the CPU decode; K1 vs plain on every launch "
          f"(shapes {k1_shapes}) max |diff| {k1_err}")

    frames = [jb.parse_jpeg_structure(d) for d in streams]

    def rate(fn, budget=2.0):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < budget:
            fn()
            n += 1
        torch.cuda.synchronize()
        return n * len(streams) / (time.perf_counter() - t0)

    def device_all():
        for f, d in zip(frames, streams):
            de.decode_progressive_device(f, d, dev)

    def host_all():
        for f, d in zip(frames, streams):
            host_planes(f, d)

    return {"launches": launches, "k1_err": k1_err,
            "device": rate(device_all), "host": rate(host_all)}


if __name__ == "__main__":
    sys.exit(main())
