"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (csrc/*.cu) with nvcc and the host library
(native/*.cpp) with c++, both from the sources in this checkout, then drives
the port's device paths on the GPU and checks that each ran through its
kernels (launch counts set to 0 just before the path, read just after):

- main path: 256 baseline 4:2:0 JPEGs of 375x500 at q85 (the corpus
  bench.py times) through the public Decoder, idx route (K2, K1; K2 stores
  the coefficient stacks as K1 reads them, K3 works in place on the planes,
  and no path may reach the plain versions' reassembly, gather or scatter);
- dri path: the same photos with a restart marker every MCU row (committed
  in tests/torch_corpus), through the Decoder's dri route (K2, K1);
- prog path: 8 progressive streams (libjpeg's default script, restart
  interval 16; tests/torch_corpus) through `decode_progressive` (K3, K1);
- encode path: the main path's 256 decoded images, as the CUDA tensors they
  are, through `Encoder(device="cuda")`: the device route (one stacked
  tensor, `encode_pixels` on the card, int16 coefficients back, Huffman on
  the host), no image copied to the host whole, every stream decoded again
  to PSNR >= 33 dB; and 8-image 4:4:4, 4:2:2, gray and 12-bit buckets;
- transcode path: `pipeline.decode_batches` over 4 batches of 64 streams at
  depth 2 (K2, K1), `resize` to 224x224 on the card, `Encoder.encode`;
- cli: `python -m nvimagecodec_tpu_torch.cli` imtrans on 16 JPEGs and improc
  --resize on one, as a user would run them;
- j2k path: 8 lossless 1024x1024 RGB JPEG2000 streams (5 levels, made at run
  time by the port's own encoder) through the public Decoder: Tier-2 on the
  host, the code-block table and codestream up in one pinned buffer, Tier-1
  by csrc/j2k_t1.cu (one launch a stream) into the subbands on the card,
  IDWT + inverse RCT + level shift as torch ops there, equal to the photos
  and to the CPU decode; then a uniform and a partial tile grid, 9/7,
  16-bit, gray, HT and the committed HTJ2K streams, a J2K encode of a CUDA
  tensor, and a forced failure of the device stage, which must raise and
  reach no other decoder;
- mesh path: `Decoder(mesh=make_mesh())` over every visible card
  equals `Decoder()`; a dp=2 mesh of cuda:0 twice decodes the main and dri
  corpora bit-exactly to the unsharded decode with K2 once and K1 three
  times a shard (each held against its plain version on a shard's own
  inputs); the 1024x1024 J2K stream over sp=2 and sp=4 (rows, halo rows
  copied between shards) and its 16-tile grid over sp=4 (tiles) equal the
  unsharded decode; `GenericEncoder(mesh=dp2)` gives the unsharded bytes,
  and an image encoded alone the bytes it gets inside the 256-image batch.
  One card covers only meshes whose devices repeat that card;
- bench: `bench_torch.py --quick --device cuda`, each configuration in a
  process of its own, must exit 0 with a last line saying "correct": true.

The encode path's fDCT+quant product is the hand-written
`fdct_quant_blocks` (csrc/fdct.cu), held against its plain version
(`torch.matmul`) on every launch of the encode, transcode and mesh paths;
the encode phase also holds the 8 streams of `Encoder(device="cuda")`, run
through the kernel, and the kernel's coefficients on seeded blocks to the
SHA-256 digests that tests/test_torch_gpu.py pins (`digest_ok`), and its
times stand beside a copy-only floor and the FMA floor at the rate this
card sustains (tools/fp32_peak.py).

It checks the images and coefficients against the CPU and the native host
decoder, holds each kernel against its plain PyTorch version on the card,
(K2 and K3 bit for bit, on clean inputs and with a corrupted lane),
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

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
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
MESH_DP = 2  # shards of the mesh path's decode and encode
K2_GOAL_MS = 0.75  # one bucket of 256 images
K3_GOAL_MS = 0.65  # the 10 scans of one stream
PSNR_BAR_DB = 33.0  # a re-encoded image against the tensor it came from
TRANSCODE_BATCHES, TRANSCODE_BATCH, TRANSCODE_HW = 4, 64, 224
J2K_BATCH, J2K_HW, J2K_LEVELS = 8, 1024, 5  # the reference bench's J2K corpus
# the card's host link: PCIe Gen5 x16, 64 GB/s each way (H100 SXM data sheet:
# 128 GB/s both ways)
PCIE_BYTES_PER_S = 64e9
# torch.cuda._sleep counts the card's clock; at least this many a millisecond
# (the H100's boost clock is 1.98 GHz), so a spin is never shorter than asked
SPIN_CYCLES_PER_MS = 2.0e6


def bytes_bound_ms(*tensors) -> float:
    """Milliseconds to move each of `tensors` once at the memory rate."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / HBM_BYTES_PER_S * 1e3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int, hold_ms: float = 0.0) -> float:
    """Mean milliseconds per call of fn(i) on the current stream (CUDA
    events). With hold_ms > 0 the calls queue up behind a kernel that spins
    that long, so the events see the card's time alone and not the host's
    pace of launching (a small kernel runs shorter than its wrapper); it
    raises if the host was still launching when the spin ended."""
    import torch

    fn(0)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hold_ms > 0:
        torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if hold_ms > 0 and host_ms > hold_ms * 0.5:
        raise RuntimeError(f"cuda_ms: the host took {host_ms:.2f} ms to launch "
                           f"behind a spin of {hold_ms} ms")
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch import _build, native
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.ops.entropy_kernels import (
        decode_segments_into,
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
    uniq = nic.Encoder(device="cpu").encode(photos, "jpeg", params)
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
    with no_plain_versions():
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

    # 5) K2 against its plain version (a 4-image bucket, clean and with a
    # corrupted lane, then the full bucket) and against the native host
    # decoder (the full bucket)
    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(jpgs)}
    raws = dict(enumerate(jpgs))
    k2_err = k2_held("idx", frames, raws, 4, dev, corrupt=True)[0]
    k2_err2, k2_plain_ms, k2_args, coefs = k2_held("idx", frames, raws, BATCH,
                                                   dev)
    k2_err = max(k2_err, k2_err2)
    check_host_coefs(coefs, frames, raws, "K2 (idx)")
    words = k2_args[0]
    phase("K2", f"words {tuple(words.shape)} -> stacks "
          f"{[tuple(c.shape) for c in coefs]}: bit-exact vs plain (4-image "
          f"bucket clean and with a corrupted lane, {BATCH}-image bucket; "
          f"stacks and err, max |diff| {k2_err}) and vs native host "
          f"coefficients (all {BATCH} samples); 0 err flags on clean input")

    # 6) K1 at the main path's shapes (zigzag coefficients from K2)
    k1_err = k1_main_err
    k1_in = []
    nat_of_zz = torch.from_numpy(ZIGZAG_NAT.astype(np.int64)).to(dev)
    for x, comp in zip(coefs, frames[0].components):
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

    # 10) the encode path: the main path's CUDA tensors through the Encoder
    enc_path = encode_phase(imgs, dec, params, dev)
    encode_frame = enc_path["frame"]

    # 11) the transcode path: pipelined decode, resize on the card, encode
    trans = transcode_phase(jpgs, imgs, dec, params)

    # 12) the command line, as a user would run it
    cli_phase(uniq, dec)

    # 13) the J2K path: host Tier-2, Tier-1 and the pixel stage on the card
    j2k = j2k_phase(dev)
    j2k_frames_phase(j2k["photos"][0], dev)
    j2k_encode_phase(j2k["photos"][1], dev)
    j2k_failure_phase(j2k["streams"][:2])

    # 14) the mesh path: dp over the JPEG buckets, sp over J2K rows and tiles
    mesh = mesh_phase(jpgs, imgs, dec, params, j2k)

    # 15) times (informational; no claim)
    k1_ms = sum(cuda_ms(lambda i, x=x, M=M: dequant_idct_blocks(x, M, 8, True),
                        20) for x, M in k1_in)
    k1_plain_ms = sum(
        cuda_ms(lambda i, x=x, M=M: dequant_idct_blocks_plain(x, M, 8, True),
                5) for x, M in k1_in)
    # the library call beside K1: the same product in fp32, nothing else
    k1_lib_ms = 0.0
    for x, M in k1_in:
        a32 = x.reshape(-1, 64).to(torch.float32)
        mt = M.T.contiguous()
        k1_lib_ms += cuda_ms(lambda i, a32=a32, mt=mt: torch.matmul(a32, mt),
                             20)
        del a32
    # K1's bound: every coefficient read and every int32 sample written
    # once, M once a launch, against 2 * K * 64 fp32 operations a block
    k1_blocks = [x.numel() // x.shape[-1] for x, _ in k1_in]
    k1_bytes_ms = (sum(bytes_bound_ms(x, M) for x, M in k1_in)
                   + sum(k1_blocks) * 64 * 4 / HBM_BYTES_PER_S * 1e3)
    k1_ops_ms = sum(2 * x.numel() * 64 for x, _ in k1_in) / FP32_FLOPS * 1e3
    k1_bound_ms = max(k1_bytes_ms, k1_ops_ms)
    k2_ms = cuda_ms(lambda i: decode_segments_into(*k2_args), 10, hold_ms=20)
    # K2 and K3 walk their bits in series with integer operations, for which
    # the data sheet names no peak: their bound is the bytes alone (words,
    # side, tables and lookahead rows read, stacks and err written)
    k2_bound_ms = bytes_bound_ms(*k2_args[:4], *coefs) \
        + k2_args[1].shape[1] * 4 / HBM_BYTES_PER_S * 1e3
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
          f"{k1_ops_ms:.4f}); K2 {k2_ms:.4f} ms (goal <= {K2_GOAL_MS}: "
          f"{'met' if k2_ms <= K2_GOAL_MS else 'missed'}; plain "
          f"{k2_plain_ms:.1f}, one run; bound by bytes {k2_bound_ms:.4f}); "
          f"K2 on the dri bucket {dri['k2_ms']:.4f} ms")
    k3_ms = sum(k3["ms"].values())
    phase("times", f"on {card}: K3 per kind, summed over the scans of one "
          f"stream, kernel (plain, one run): " + "; ".join(
              f"{kd} {k3['ms'][kd]:.4f} ms ({k3['plain_ms'][kd]:.1f})"
              for kd in K3_KINDS) + f"; together {k3_ms:.4f} ms (goal <= "
          f"{K3_GOAL_MS}: {'met' if k3_ms <= K3_GOAL_MS else 'missed'}; "
          f"bound by bytes {k3['bound_ms']:.5f}); one launch of its wrapper "
          f"costs the host {k3['host_ms_per_launch']:.4f} ms")
    phase("times", f"on {card}: progressive entropy decode, "
          f"decode_progressive_device {prog_ips['device']:.1f} images/s "
          f"against the native host entropy decoder {prog_ips['host']:.1f} "
          f"images/s "
          f"(x{prog_ips['device'] / prog_ips['host']:.3f})")

    encode_times(imgs, jpgs, dec, params, dev, card, encode_frame)
    fdct = fdct_times(enc_path["fdct_in"], card)
    t1 = j2k_times(j2k, dev, card)
    mesh_times(jpgs, mesh["decoder"], card)

    # 16) the port's bench, at its quick size, in processes of its own
    bench_phase()

    loaded = [m for m in sys.modules
              if m == "jax" or m.split(".")[0] == "nvimagecodec_tpu"]
    if loaded:
        raise RuntimeError(f"the port imported {loaded[:4]}")
    print(json.dumps({"kernels": [
        {"name": "K1 dequant_idct_blocks", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/idct.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_kernels.py:23",
         "launches": launches["K1"],
         "max_abs_err": max(k1_err, dri["k1_err"], prog_ips["k1_err"],
                            trans["k1_err"], mesh["k1_err"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": "bytes" if k1_bytes_ms >= k1_ops_ms else "operations",
         "library_ms": k1_lib_ms,
         "launches_by_path": {"main": launches["K1"],
                              "dri": dri["launches"]["K1"],
                              "prog": prog_ips["launches"]["K1"],
                              "transcode": trans["launches"]["K1"],
                              "mesh": mesh["launches"]["K1"]}},
        {"name": "K2 decode_segments_into", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/huffman.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_entropy.py:120",
         "launches": launches["K2"],
         "max_abs_err": max(k2_err, dri["k2_err"], trans["k2_err"],
                            mesh["k2_err"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {"main": launches["K2"],
                              "dri": dri["launches"]["K2"],
                              "transcode": trans["launches"]["K2"],
                              "mesh": mesh["launches"]["K2"]}},
        {"name": "K3 decode_prog_scan_into", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/prog_huffman.cu",
         "replaces": "nvimagecodec_tpu/ops/pallas_entropy.py:493",
         "launches": prog_ips["launches"]["K3"], "max_abs_err": k3["err"],
         "ms": k3_ms, "ms_by_kind": k3["ms"],
         "plain_ms": sum(k3["plain_ms"].values()),
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {"prog": prog_ips["launches"]["K3"]}},
        {"name": "fdct_quant_blocks", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/fdct.cu",
         # the fDCT+quant product the JAX package leaves to XLA (no Pallas
         # kernel there)
         "replaces": "nvimagecodec_tpu/codecs/jpeg/encode.py:187",
         "launches": enc_path["launches"]["FDCT"],
         "max_abs_err": max(enc_path["fdct_err"], trans["fdct_err"],
                            mesh["fdct_err"]),
         "max_share_differing": max(enc_path["fdct_share"],
                                    trans["fdct_share"], mesh["fdct_share"]),
         "ms": fdct["ms"], "plain_ms": fdct["plain_ms"],
         "bound_ms": fdct["bound_ms"], "bound_by": fdct["bound_by"],
         "library_ms": fdct["library_ms"],
         "copy_floor_ms": fdct["copy_floor_ms"],
         "fma_floor_ms": fdct["fma_floor_ms"],
         "fma_tflops": fdct["fma_tflops"],
         "digest_ok": enc_path["digest_ok"],
         "launches_by_path": {"encode": enc_path["launches"]["FDCT"],
                              "transcode": trans["launches"]["FDCT"],
                              "mesh": mesh["launches"]["FDCT"]}},
        {"name": "J2K Tier-1 decode_codeblocks", "route": "cuda",
         "source": "nvimagecodec_tpu_torch/csrc/j2k_t1.cu",
         # the JAX package decodes Tier-1 on the host (no Pallas kernel)
         "replaces": None, "launches": J2K_BATCH, "max_abs_err": 0,
         "ms": t1["kernel_ms"], "plain_ms": t1["native_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "launches_by_path": {"j2k": J2K_BATCH}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bench_phase():
    """`bench_torch.py --quick --device cuda` as a user would run it: exit
    code 0 and a last line that parses with "correct": true."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--quick",
         "--device", "cuda"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    lines = r.stdout.strip().splitlines()
    try:
        got = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        got = {}
    if r.returncode != 0 or got.get("correct") is not True:
        raise RuntimeError(f"bench_torch.py --quick: exit code "
                           f"{r.returncode}, last line {lines[-1:]}; "
                           f"{r.stderr[-2000:]}")
    phase("bench", f"bench_torch.py --quick --device cuda: exit code 0 in "
          f"{time.perf_counter() - t0:.1f} s, correct true, "
          f"{got['attempted']} samples, {got['failures']} failures, "
          f"{len(lines[-1])} characters; kernels {got['kernels']}")


def counts_zero():
    """Set every kernel's launch count to 0."""
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from nvimagecodec_tpu_torch.ops import kernels

    kernels.dequant_idct_blocks.launches = 0
    ek.decode_segments_into.launches = 0
    ek.decode_prog_scan_into.launches = 0
    kernels.fdct_quant_blocks.launches = 0


def counts():
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek
    from nvimagecodec_tpu_torch.ops import kernels

    return {"K1": kernels.dequant_idct_blocks.launches,
            "K2": ek.decode_segments_into.launches,
            "K3": ek.decode_prog_scan_into.launches,
            "FDCT": kernels.fdct_quant_blocks.launches}


@contextlib.contextmanager
def no_plain_versions():
    """While a path is driven on the card: the lane-major decodes and the
    reassembly, gather and scatter around them belong to the kernels' plain
    versions, and reaching one of them is a failure."""
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek

    names = ("decode_segments_plain", "decode_prog_scan_plain",
             "reassemble_components", "_dc_index", "_ac_index")
    real = {n: getattr(ek, n) for n in names}

    def refuse(name):
        def fn(*args, **kwargs):
            raise RuntimeError(f"a device path reached {name}")
        return fn

    for n in names:
        setattr(ek, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ek, n, fn)


def k2_held(kind, frames, raws, n, dev, corrupt=False):
    """K2 on the first n streams, split as the route `kind` ("idx" or
    "dri") splits them, against its plain version: stacks and err bit for
    bit, no flag on clean input. With corrupt=True the same once more with
    a few words of one lane overwritten (no Huffman code is sixteen 1 bits):
    the lane is flagged and even its garbage is equal. Returns (max |diff|,
    the plain version's milliseconds, K2's arguments, its stacks)."""
    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek

    f0 = frames[0]
    _kind, _key, R, nsegs = jb.route_plan(f0)
    if kind == "idx":
        ok, bad, bad_scan, words, side = jb.split_indexed(
            list(range(n)), frames, raws, R, nsegs, dev)
        if len(ok) != n or bad or bad_scan:
            raise RuntimeError("index scan rejected corpus samples")
    else:
        split = jb.split_dri(list(range(n)), frames, raws, nsegs, dev)
        if split is None or split[0]:
            raise RuntimeError("dri split rejected corpus samples")
        _bad, words, side = split
    R, _comp_map, tables = ek.huffman_tables(f0, R)
    mcus_x = -(-f0.width // (8 * f0.hmax))
    mcus_y = -(-f0.height // (8 * f0.vmax))
    args = (words.to(dev), side.to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(ek.lookahead_tables(tables)).to(dev), R,
            [(c.h, c.v) for c in f0.components], mcus_x, mcus_y, n, nsegs)

    def both(args, what):
        stacks, err = ek.decode_segments_into(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, err_p = ek.decode_segments_into_plain(*args[:3], *args[4:])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1000
        diff = max(int((err - err_p).abs().max()),
                   *(int((a.int() - b.int()).abs().max())
                     for a, b in zip(stacks, want)))
        same = all(a.shape == b.shape and a.is_contiguous()
                   for a, b in zip(stacks, want))
        if diff != 0 or not same:
            raise RuntimeError(f"K2 differs from its plain version on the "
                               f"{n}-image {kind} bucket ({what}): max |diff| "
                               f"{diff}")
        return stacks, err, plain_ms

    stacks, err, plain_ms = both(args, "clean")
    if int(err.sum()) != 0:
        raise RuntimeError(f"K2 flagged {int((err != 0).sum())} lanes of the "
                           f"clean {n}-image {kind} bucket")
    if corrupt:
        lane = nsegs + 2  # the second image's third segment
        bad_words = args[0].clone()
        bad_words[3:7, lane] = -1
        _stacks, err, _ms = both((bad_words,) + args[1:], "corrupted lane")
        if int(err[lane]) != 1:
            raise RuntimeError(f"K2 did not flag the corrupted {kind} lane")
    return 0, plain_ms, args, stacks


def max_diff(imgs, ref) -> int:
    """Max |a - b| of every image against the reference decode of its
    photo (the corpora cycle SEEDS photos)."""
    return max(int((im.array.cpu().int()
                    - ref[j % SEEDS].array.int()).abs().max())
               for j, im in enumerate(imgs))


def check_host_coefs(coefs, frames, raws, label):
    """K2's [B, bh, bw, 64] zigzag coefficient stacks of every sample
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
    launches no kernel). fn may reach K1 from several threads at once.
    Returns (fn's result, max |kernel - plain|, the input shapes)."""
    import threading

    from nvimagecodec_tpu_torch.codecs.jpeg import pixel
    from nvimagecodec_tpu_torch.ops.kernels import dequant_idct_blocks_plain

    real = pixel.dequant_idct_blocks
    err, shapes, lock = [0], set(), threading.Lock()

    def both(x, M, *args):
        got = real(x, M, *args)
        want = dequant_idct_blocks_plain(x, M, *args)
        diff = int((got - want).abs().max())
        with lock:
            err[0] = max(err[0], diff)
            shapes.add(tuple(x.shape))
        return got

    pixel.dequant_idct_blocks = both
    try:
        return fn(), err[0], sorted(shapes)
    finally:
        pixel.dequant_idct_blocks = real


def fdct_held(fn, keep=None):
    """Run fn() with every fdct_quant_blocks launch of encode_pixels held
    against fdct_quant_blocks_plain on the same inputs (the plain version
    launches no kernel); `keep` collects each launch's (samples, matrix).
    Raises unless the kernel is within 1 of the plain version on fewer than
    1% of the entries of every launch. Returns (fn's result, max |kernel -
    plain|, the largest share of entries that differ)."""
    import threading

    from nvimagecodec_tpu_torch.codecs.jpeg import encode
    from nvimagecodec_tpu_torch.ops.kernels import fdct_quant_blocks_plain

    real = encode.fdct_quant_blocks
    st, lock = {"err": 0, "share": 0.0}, threading.Lock()

    def both(x, M):
        got = real(x, M)
        d = (got - fdct_quant_blocks_plain(x, M)).abs()
        with lock:
            st["err"] = max(st["err"], int(d.max()))
            st["share"] = max(st["share"], float((d > 0).double().mean()))
            if keep is not None:
                keep.append((x, M))
        return got

    encode.fdct_quant_blocks = both
    try:
        out = fn()
    finally:
        encode.fdct_quant_blocks = real
    if st["err"] > 1 or st["share"] >= 0.01:
        raise RuntimeError(f"fdct_quant_blocks vs plain: max |diff| "
                           f"{st['err']} on {st['share']:.4%} of entries")
    return out, st["err"], st["share"]


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
    from nvimagecodec_tpu_torch.ops.entropy_kernels import (
        decode_segments_into,
    )

    uniq = torch_corpus.dri_streams()
    jpgs = [uniq[i % SEEDS] for i in range(BATCH)]
    routes0 = dict(jb.ROUTES)
    counts_zero()
    with no_plain_versions():
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
    k2_err = k2_held("dri", frames, raws, 4, dev, corrupt=True)[0]
    # the full bucket, as the route splits it (W from the first guess)
    k2_err2, _plain_ms, args, stacks = k2_held("dri", frames, raws, BATCH,
                                               dev)
    k2_err = max(k2_err, k2_err2)
    check_host_coefs(stacks, frames, raws, "K2 (dri)")
    k2_ms = cuda_ms(lambda i: decode_segments_into(*args), 10, hold_ms=20)
    nsegs = args[-1]
    phase("dri_path", f"{BATCH}/{BATCH} CUDA uint8 [{H},{W},3] via dri route "
          f"(restart interval {torch_corpus.DRI_RI} MCUs, {nsegs} segments "
          f"each, words {tuple(args[0].shape)}); launches {launches}; all "
          f"{BATCH} within {diff} of the CPU decode; K1 vs plain on every "
          f"launch max |diff| {k1_err}; K2 bit-exact vs plain on a 4-image "
          f"dri bucket (clean and with a corrupted lane) and the "
          f"{BATCH}-image one (stacks and err, max |diff| {k2_err}) and vs "
          f"native host coefficients (all {BATCH} samples)")
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


def k3_bytes(call) -> int:
    """Bytes one K3 launch must move: words, side, tables, lookahead rows
    and flags once; of the planes, coefficient 0 of every block of a DC scan
    and positions ss..se of every block of an AC scan's grid, written once
    and, by a refinement, read once too."""
    kind, (words, side, tables, look), planes, geom = call
    _R, _hv, _mcus_x, _ci, grid, ss, se, _al = geom
    if ss == 0:
        coefs = sum(p.shape[0] * p.shape[1] for p in planes)
    else:
        coefs = grid[0] * grid[1] * (se - ss + 1)
    moved = 2 if kind in ("dcref", "acref") else 1
    return (sum(t.numel() * t.element_size()
                for t in (words, side, tables, look))
            + side.shape[1] * 4 + coefs * 2 * moved)


def k3_phase(streams, dev):
    """Every scan of `streams` through K3 and through its plain version on
    the card, on the inputs the progressive route builds and on the planes
    as they were before that scan: the planes after the scan and err bit for
    bit, no flag; then the same with a few words of one lane overwritten
    (the first scan of a kind must flag it). Then each scan of the first
    stream timed (CUDA events behind a spin, every launch on a fresh copy of
    the planes) beside one plain run. Returns the phase's numbers."""
    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import device_entropy as de
    from nvimagecodec_tpu_torch.ops import entropy_kernels as ek

    real = de.decode_prog_scan_into
    calls = []  # (kind, (words, side, tables, look), planes before, geometry)

    def capture(kind, words, side, tables, look, planes, *geom):
        calls.append((kind, (words, side, tables, look),
                      [p.clone() for p in planes], geom))
        return real(kind, words, side, tables, look, planes, *geom)

    def both(kind, inputs, before, geom, what):
        mine = [p.clone() for p in before]
        want = [p.clone() for p in before]
        err = ek.decode_prog_scan_into(kind, *inputs, mine, *geom)
        err_p = ek.decode_prog_scan_into_plain(kind, *inputs[:3], want, *geom)
        torch.cuda.synchronize()
        diff = max(int((err - err_p).abs().max()),
                   *(int((a.int() - b.int()).abs().max())
                     for a, b in zip(mine, want)))
        if diff != 0:
            raise RuntimeError(f"K3 {kind} differs from its plain version "
                               f"({what}): max |diff| {diff}")
        return err

    ncorrupt = 0
    for n, data in enumerate(streams):
        calls.clear()
        de.decode_prog_scan_into = capture
        try:
            de.decode_progressive_device(jb.parse_jpeg_structure(data), data,
                                         dev)
        finally:
            de.decode_prog_scan_into = real
        torch.cuda.synchronize()
        flagged = set()
        for kind, inputs, before, geom in calls:
            if int(both(kind, inputs, before, geom, f"stream {n}").sum()):
                raise RuntimeError(f"K3 flagged a clean {kind} lane")
            bad = (inputs[0].clone(),) + inputs[1:]
            bad[0][1:5, 3] = -1  # no Huffman code is sixteen 1 bits
            err = both(kind, bad, before, geom, f"stream {n}, corrupted lane")
            ncorrupt += 1
            # a later band's lane may end before the overwritten words
            if kind in ("dc", "ac") and kind not in flagged \
                    and int(err[3]) != 1:
                raise RuntimeError(f"K3 did not flag the corrupted {kind} "
                                   "lane")
            flagged.add(kind)
        kinds = {c[0] for c in calls}
        if kinds != set(K3_KINDS):
            raise RuntimeError(f"K3 ran kinds {kinds} only")
        if n == 0:
            timed = list(calls)
    ms = dict.fromkeys(K3_KINDS, 0.0)
    plain_ms = dict.fromkeys(K3_KINDS, 0.0)
    reps = 20
    host_ms = 0.0
    for kind, inputs, before, geom in timed:
        copies = [[p.clone() for p in before] for _ in range(reps + 1)]
        ms[kind] += cuda_ms(
            lambda i: ek.decode_prog_scan_into(kind, *inputs, copies[i],
                                               *geom), reps, hold_ms=20)
        t0 = time.perf_counter()
        for i in range(reps):
            ek.decode_prog_scan_into(kind, *inputs, copies[i], *geom)
        host_ms += (time.perf_counter() - t0) * 1000 / reps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ek.decode_prog_scan_into_plain(kind, *inputs[:3], copies[reps], *geom)
        torch.cuda.synchronize()
        plain_ms[kind] += (time.perf_counter() - t0) * 1000
    bound_ms = sum(map(k3_bytes, timed)) / HBM_BYTES_PER_S * 1e3
    bands = sorted({(c[0], c[3][5], c[3][6]) for c in timed})
    phase("K3", f"{len(streams)} streams x {len(timed)} scans, (kind, ss, se) "
          f"{bands}: planes after every scan and err bit-exact vs plain, "
          f"clean (0 err flags) and with a corrupted lane ({ncorrupt} "
          "cases), max |diff| 0")
    return {"err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "host_ms_per_launch": host_ms / len(timed)}


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
    with no_plain_versions():
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


def widen(t):
    """A tensor's samples as int32 (few torch ops take uint16)."""
    import torch

    from nvimagecodec_tpu_torch.ops.convert import widen_uint16

    return widen_uint16(t).to(torch.int32)


def psnr_db(a, b, peak: float = 255.0) -> float:
    mse = float(((widen(a) - widen(b)).double() ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(peak * peak / mse)


@contextlib.contextmanager
def count_host_copies(copies: list):
    """Append to `copies` whenever the encode path copies a whole image to
    the host (`batch_encode.host_array`, `Image.cpu`)."""
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.image import Image

    real_array, real_cpu = be.host_array, Image.cpu

    def host_array(img):
        copies.append(type(img).__name__)
        return real_array(img)

    def cpu(self):
        copies.append("Image.cpu")
        return real_cpu(self)

    be.host_array, Image.cpu = host_array, cpu
    try:
        yield
    finally:
        be.host_array, Image.cpu = real_array, real_cpu


def encode_bucket(name, tensors, params, enc, dec, dev, peak=255.0):
    """One same-shape bucket of CUDA tensors through `enc`: the device route
    took every image and copied none to the host whole, every stream decodes
    again (through `dec`) to PSNR >= PSNR_BAR_DB against the tensor it came
    from, and for the first SEEDS images (the distinct photos) the card's
    coefficients differ from `encode_pixels` on the CPU by at most 1 on
    fewer than 1% of entries. Returns (streams, frame, text)."""
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import encode_pixels

    n = len(tensors)
    copies = []
    routes0 = dict(be.ROUTES)
    counts_zero()
    with count_host_copies(copies):
        streams = enc.encode(tensors, "jpeg", params)
    launches = counts()
    routes = {k: be.ROUTES[k] - routes0[k] for k in routes0}
    if routes != {"device": n, "host": 0, "progressive": 0}:
        raise RuntimeError(f"encode path ({name}): routes {routes}")
    if copies:
        raise RuntimeError(f"encode path ({name}): {len(copies)} images "
                           f"were copied to the host, e.g. {copies[:4]}")
    if any(d is None for d in streams):
        raise RuntimeError(f"encode path ({name}): a sample failed")
    if launches["FDCT"] != len(frame_of(tensors[0], params).components):
        raise RuntimeError(f"encode path ({name}): launches {launches}, "
                           "expected one fdct_quant_blocks a component")
    back = dec.decode(streams, nic.DecodeParams(allow_any_depth=peak > 255))
    worst = math.inf
    for j, (t, im) in enumerate(zip(tensors, back)):
        if im is None or tuple(im.shape) != tuple(t.shape) \
                or im.array.dtype != t.dtype:
            raise RuntimeError(f"encode path ({name}): stream {j} decodes "
                               f"to {im}")
        worst = min(worst, psnr_db(im.array.to(dev), t, peak))
    if worst < PSNR_BAR_DB:
        raise RuntimeError(f"encode path ({name}): PSNR {worst:.2f} dB < "
                           f"{PSNR_BAR_DB}")
    deep = tensors[0].dtype == torch.uint16
    bits = torch.int16 if deep else torch.uint8
    x = torch.stack([t.view(bits) for t in tensors[:SEEDS]])
    x = x.view(torch.uint16) if deep else x
    frame = be.bucket_frame(tuple(tensors[0].shape), params,
                             12 if deep else 8)
    diff, share = 0, 0.0
    for a, b in zip(encode_pixels(x, frame, dev),
                    encode_pixels(x.cpu(), frame, "cpu")):
        d = (a.cpu() - b).abs()
        diff = max(diff, int(d.max()))
        share = max(share, float((d > 0).double().mean()))
    if diff > 1 or share >= 0.01:
        raise RuntimeError(f"encode path ({name}): coefficients on the card "
                           f"differ from the CPU's by {diff} on {share:.4%}")
    return streams, frame, launches, (
        f"{name}: {n}/{n} via the device route, no host copy of an image, "
        f"launches {launches}, decode again to PSNR >= {worst:.2f} dB, card "
        f"vs CPU coefficients max |diff| {diff} on {share:.4%} of entries")


def frame_of(tensor, params):
    """The encode frame of a bucket of such tensors."""
    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be

    deep = tensor.dtype == torch.uint16
    return be.bucket_frame(tuple(tensor.shape), params, 12 if deep else 8)


def encode_phase(imgs, dec, params, dev):
    """The main path's decoded images, CUDA tensors, through
    `Encoder(device="cuda")` with the GPU backend only: the full 4:2:0
    bucket, then 8-image 4:4:4, 4:2:2, gray and 12-bit (uint16) buckets,
    fdct_quant_blocks held against its plain version on every launch.
    Returns the main bucket's frame, its launch counts, the inputs of its
    fdct_quant_blocks launches and whether both pinned digests matched."""
    import torch
    from test_torch_gpu import (
        FDCT_BLOCKS_SHA256,
        FDCT_STREAMS_SHA256,
        fdct_blocks_digest,
        fdct_streams_digest,
    )

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.ops import kernels

    enc = nic.Encoder(device="cuda",
                      backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])
    tensors = [im.array for im in imgs]
    keep = []
    (streams, frame, launches, text), f_err, f_share = fdct_held(
        lambda: encode_bucket(f"{len(tensors)} x {H}x{W} 4:2:0 q{QUALITY}",
                              tensors, params, enc, dec, dev), keep)
    phase("encode_path", text + f"; {sum(map(len, streams)) // len(streams)}"
          f" B mean; fdct_quant_blocks vs plain on every launch max |diff| "
          f"{f_err} on {f_share:.4%} of entries")
    # the bits of the kernel's first design, kept by every later one: the
    # streams, which must come through the kernel, and the coefficients of
    # seeded blocks, which tell one summation order from another
    kernels.fdct_quant_blocks.launches = 0
    digest, err, share = fdct_held(
        lambda: fdct_streams_digest(nic.Encoder(device="cuda"), dev))
    streams_launches = kernels.fdct_quant_blocks.launches
    if streams_launches == 0:
        raise RuntimeError("encode path: the 8 pinned streams were encoded "
                           "without a fdct_quant_blocks launch")
    f_err, f_share = max(f_err, err), max(f_share, share)
    blocks_digest = fdct_blocks_digest(kernels.fdct_quant_blocks, dev)
    digest_ok = (digest == FDCT_STREAMS_SHA256
                 and blocks_digest == FDCT_BLOCKS_SHA256)
    if not digest_ok:
        raise RuntimeError(
            f"encode path: the 8 pinned streams digest to {digest} (pinned "
            f"{FDCT_STREAMS_SHA256}), the seeded blocks to {blocks_digest} "
            f"(pinned {FDCT_BLOCKS_SHA256})")
    phase("encode_path", f"8 streams of Encoder(device=\"cuda\") at q85 "
          f"4:2:0 ({streams_launches} fdct_quant_blocks launches) digest to "
          f"the pinned {digest[:16]}..., the kernel's seeded blocks to the "
          f"pinned {blocks_digest[:16]}...: digest_ok {digest_ok}")

    def with_css(css):
        return nic.EncodeParams(
            quality=QUALITY, chroma_subsampling=css,
            jpeg=nic.JpegEncodeParams(optimized_huffman=False))

    few = tensors[:SEEDS]
    deep = [((widen(t) << 4) | (widen(t) >> 4)).to(torch.int16)
            .view(torch.uint16) for t in few]
    for name, bucket, p, peak in [
            ("4:4:4", few, with_css(nic.ChromaSubsampling.CSS_444), 255.0),
            ("4:2:2", few, with_css(nic.ChromaSubsampling.CSS_422), 255.0),
            ("gray", [t[..., 0].contiguous() for t in few], with_css(None),
             255.0),
            ("12-bit 4:2:0 (uint16)", deep, params, 4095.0)]:
        (_s, _f, _l, text), err, share = fdct_held(
            lambda: encode_bucket(f"{len(bucket)} x {name}", bucket, p, enc,
                                  dec, dev, peak))
        f_err, f_share = max(f_err, err), max(f_share, share)
        phase("encode_path", text)
    # the main encode's three launches come first (the checks follow it)
    return {"frame": frame, "launches": launches, "fdct_err": f_err,
            "fdct_share": f_share, "fdct_in": keep[:len(frame.components)],
            "digest_ok": digest_ok}


def transcode_batches(jpgs):
    return [jpgs[b * TRANSCODE_BATCH:(b + 1) * TRANSCODE_BATCH]
            for b in range(TRANSCODE_BATCHES)]


def transcode_once(jpgs, dec, enc, params, keep=None):
    """decode_batches at depth 2 → one stacked resize to 224x224 on the card
    → Encoder.encode. Returns the streams; `keep` collects (decoded images,
    resized batch) per batch."""
    import torch

    from nvimagecodec_tpu_torch.ops.resize import resize
    from nvimagecodec_tpu_torch.pipeline import decode_batches

    out = []
    for batch in decode_batches(transcode_batches(jpgs), decoder=dec,
                                drop_failed=False, depth=2):
        if any(im is None for im in batch):
            raise RuntimeError("transcode path: a decode failed")
        small = resize(torch.stack([im.array for im in batch]),
                       TRANSCODE_HW, TRANSCODE_HW, "bilinear")
        out.extend(enc.encode(list(small), "jpeg", params))
        if keep is not None:
            keep.append((batch, small))
    return out


def transcode_phase(jpgs, imgs, dec, params):
    """The transcode path on the card, K1 held against its plain version on
    every launch and K2 on the bucket this path gives it (TRANSCODE_BATCH
    images, index-scanned): the pipelined decode equals the main path's
    unpipelined decode exactly, the resize is within 1 of `ops/resize` on
    the CPU for the distinct photos and all three filters, every stream
    decodes again to 224x224 at PSNR >= PSNR_BAR_DB, and K2 and K1 launched
    once and three times a batch. Returns the phase's numbers."""
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.ops.resize import resize

    enc = nic.Encoder(device="cuda",
                      backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])
    keep = []
    routes0 = dict(be.ROUTES)
    counts_zero()
    with no_plain_versions():
        (streams, k1_err, _shapes), f_err, f_share = fdct_held(
            lambda: k1_held(
                lambda: transcode_once(jpgs, dec, enc, params, keep)))
        torch.cuda.synchronize()
    launches = counts()
    n = TRANSCODE_BATCHES * TRANSCODE_BATCH
    want = {"K1": 3 * TRANSCODE_BATCHES, "K2": TRANSCODE_BATCHES, "K3": 0,
            "FDCT": 3 * TRANSCODE_BATCHES}
    if launches != want:
        raise RuntimeError(f"transcode path: launches {launches}, expected "
                           f"{want}")
    if k1_err > 1:
        raise RuntimeError(f"transcode path: K1 vs plain {k1_err} > 1")
    # K2 at this path's shape: one of its batches, split as the route does
    first = transcode_batches(jpgs)[0]
    frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(first)}
    k2_err, _plain_ms, k2_args, _stacks = k2_held(
        "idx", frames, dict(enumerate(first)), TRANSCODE_BATCH,
        torch.device("cuda"))
    if be.ROUTES["device"] - routes0["device"] != n:
        raise RuntimeError("transcode path: the encode left the device route")
    if len(streams) != n or any(d is None for d in streams):
        raise RuntimeError("transcode path: an encode failed")
    j = 0
    worst = math.inf
    for batch, small in keep:
        back = dec.decode(streams[j:j + len(batch)])
        for k, im in enumerate(batch):
            if not torch.equal(im.array, imgs[j + k].array):
                raise RuntimeError(f"transcode path: pipelined decode of "
                                   f"stream {j + k} differs from the "
                                   "unpipelined one")
            if back[k] is None or back[k].shape != (TRANSCODE_HW,
                                                    TRANSCODE_HW, 3):
                raise RuntimeError(f"transcode path: stream {j + k} decodes "
                                   f"to {back[k]}")
            worst = min(worst, psnr_db(back[k].array, small[k]))
        j += len(batch)
    if worst < PSNR_BAR_DB:
        raise RuntimeError(f"transcode path: PSNR {worst:.2f} dB < "
                           f"{PSNR_BAR_DB}")
    diffs = {}
    for interp in ("bilinear", "bicubic", "lanczos"):
        x = torch.stack([im.array for im in imgs[:SEEDS]])
        d = (resize(x, TRANSCODE_HW, TRANSCODE_HW, interp).cpu().int()
             - resize(x.cpu(), TRANSCODE_HW, TRANSCODE_HW, interp).int())
        diffs[interp] = int(d.abs().max())
        if diffs[interp] > 1:
            raise RuntimeError(f"transcode path: {interp} resize on the card "
                               f"differs from the CPU's by {diffs[interp]}")
    phase("transcode_path", f"{TRANSCODE_BATCHES} batches of "
          f"{TRANSCODE_BATCH} streams, depth 2: pipelined decode equals the "
          f"unpipelined one exactly; launches {launches}; K1 vs plain max "
          f"|diff| {k1_err}; K2 bit-exact vs plain on this path's "
          f"{TRANSCODE_BATCH}-image idx bucket (words "
          f"{tuple(k2_args[0].shape)}; stacks and err, max |diff| {k2_err}); "
          f"fdct_quant_blocks vs plain max |diff| {f_err} on {f_share:.4%}; "
          f"resize to {TRANSCODE_HW}x{TRANSCODE_HW} on the "
          f"card within {diffs} of the CPU's; {n}/{n} encoded via the device "
          f"route, decode again to PSNR >= {worst:.2f} dB")
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err,
            "fdct_err": f_err, "fdct_share": f_share}


def cli_phase(uniq, dec):
    """`imtrans` over a directory of 16 of the corpus's JPEGs to jpeg, and
    `improc --resize 224x224` on one, each in a process of its own on the
    card: exit code 0 and outputs that decode."""
    def run(*argv):
        r = subprocess.run(
            [sys.executable, "-m", "nvimagecodec_tpu_torch.cli", *argv],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"cli {argv[0]}: exit code {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        return r.stdout.strip()

    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in"), os.path.join(d, "out")
        os.makedirs(src)
        for i in range(16):
            with open(os.path.join(src, f"im{i:02d}.jpg"), "wb") as f:
                f.write(uniq[i % SEEDS])
        said = run("imtrans", "-i", src, "-c", "jpeg", "-q", str(QUALITY),
                   "--chroma_subsampling", "420", "-o", out).splitlines()[-1]
        names = sorted(os.listdir(out))
        if names != [f"im{i:02d}.jpg" for i in range(16)]:
            raise RuntimeError(f"cli imtrans wrote {names}")
        datas = []
        for name in names:
            with open(os.path.join(out, name), "rb") as f:
                datas.append(f.read())
        back = dec.decode(datas)
        if any(im is None or im.shape != (H, W, 3) for im in back):
            raise RuntimeError("cli imtrans: an output does not decode")
        small = os.path.join(d, "small.jpg")
        run("improc", "-i", os.path.join(src, "im00.jpg"), "--resize",
            f"{TRANSCODE_HW}x{TRANSCODE_HW}", "-c", "jpeg", "-o", small)
        with open(small, "rb") as f:
            im = dec.decode(f.read())
        if im is None or im.shape != (TRANSCODE_HW, TRANSCODE_HW, 3):
            raise RuntimeError(f"cli improc: the output decodes to {im}")
    phase("cli", f"imtrans on 16 JPEGs to jpeg: exit code 0, \"{said}\", all "
          f"16 outputs decode to [{H},{W},3]; improc --resize "
          f"{TRANSCODE_HW}x{TRANSCODE_HW}: exit code 0, decodes to "
          f"{list(im.shape)}")


def encode_times(imgs, jpgs, dec, params, dev, card, frame):
    """Informational: encode images/s of the device route and of the host
    route on the same 256 images, alternated, with the images on the card
    and on the host; the device stage's CUDA-event time and the time of its
    coefficient copy; the transcode path's images/s."""
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import encode_pixels

    hybrid = [nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)]
    encs = {"device": nic.Encoder(device="cuda", backends=hybrid),
            "host": nic.Encoder(
                device="cuda", backends=hybrid,
                options="cuda_jpeg_hybrid_encoder:device_stage=false")}
    on_card = [im.array for im in imgs]
    on_host = [t.cpu().numpy() for t in on_card]

    def rate(enc, images, reps=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            if any(d is None for d in enc.encode(images, "jpeg", params)):
                raise RuntimeError("times: an encode failed")
        return reps * len(images) / (time.perf_counter() - t0)

    for enc in encs.values():  # warm-up: pinned buffers, matrices, pools
        rate(enc, on_card, 1)
        rate(enc, on_host, 1)
    ips = {}
    for where, images in (("card", on_card), ("host", on_host)):
        for route in ("device", "host", "host", "device"):
            ips.setdefault((where, route), []).append(
                rate(encs[route], images))

    x = torch.stack(on_card)

    def stage(i):
        return [c.to(torch.int16) for c in encode_pixels(x, frame, dev)]

    stage_ms = cuda_ms(stage, 5)
    coefs = stage(0)
    hosts = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
             for c in coefs]

    def fetch(i):
        for h, c in zip(hosts, coefs):
            h.copy_(c, non_blocking=True)

    d2h_ms = cuda_ms(fetch, 5)
    d2h_bytes = sum(h.nbytes for h in hosts)
    stack_ms = cuda_ms(lambda i: torch.stack(on_card), 5)

    enc = encs["device"]
    transcode_once(jpgs, dec, enc, params)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        transcode_once(jpgs, dec, enc, params)
    torch.cuda.synchronize()
    trans_ips = (reps * TRANSCODE_BATCHES * TRANSCODE_BATCH
                 / (time.perf_counter() - t0))

    def both(where, route):
        return " / ".join(f"{v:.1f}" for v in ips[(where, route)])

    phase("times", f"on {card}: Encoder.encode of {len(imgs)} images "
          f"{H}x{W} 4:2:0 q{QUALITY}, images/s, two readings each, routes "
          f"alternated: images on the card, device route "
          f"{both('card', 'device')}, host route {both('card', 'host')}; "
          f"images on the host, device route {both('host', 'device')}, host "
          f"route {both('host', 'host')}")
    phase("times", f"on {card}: encode device stage (encode_pixels + int16) "
          f"{stage_ms:.4f} ms for {len(imgs)} images (CUDA events); stacking "
          f"the {len(imgs)} tensors {stack_ms:.4f} ms; copy of {d2h_bytes} B "
          f"of coefficients to pinned host memory {d2h_ms:.4f} ms "
          f"({d2h_bytes / d2h_ms / 1e6:.2f} GB/s); transcode path "
          f"(decode_batches depth 2, resize {TRANSCODE_HW}x{TRANSCODE_HW}, "
          f"encode) {trans_ips:.1f} images/s")


def fdct_times(f_in, card):
    """fdct_quant_blocks at the encode path's shapes (the main bucket's three
    components), CUDA events: beside its plain version, `torch.matmul` of the
    same product (the library call, used nowhere in the port) and its bound,
    the larger of the bytes (samples read, int32 coefficients written, the
    matrix, once each over 3.35 TB/s) and 2 * 64 * 64 fp32 operations a block
    over 67 TFLOP/s; and beside two floors: a copy-only one (`copy_` of the
    same float32 samples into an int32 buffer, the kernel's bytes without its
    arithmetic) and its FMAs at the rate this card sustains from registers
    (tools/fp32_peak.py)."""
    import torch
    from fp32_peak import fma_tflops

    from nvimagecodec_tpu_torch.ops.kernels import (
        fdct_quant_blocks,
        fdct_quant_blocks_plain,
    )

    ms = sum(cuda_ms(lambda i, x=x, M=M: fdct_quant_blocks(x, M), 20)
             for x, M in f_in)
    plain_ms = sum(cuda_ms(lambda i, x=x, M=M: fdct_quant_blocks_plain(x, M),
                           5) for x, M in f_in)
    lib_ms = copy_ms = 0.0
    for x, M in f_in:
        mt = M.T.contiguous()
        lib_ms += cuda_ms(lambda i, x=x, mt=mt: torch.matmul(x, mt), 20)
        dst = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        copy_ms += cuda_ms(lambda i, x=x, dst=dst: dst.copy_(x), 20)
        del dst
    blocks = sum(x.numel() // 64 for x, _ in f_in)
    bytes_ms = (sum(bytes_bound_ms(x, M) for x, M in f_in)
                + blocks * 64 * 4 / HBM_BYTES_PER_S * 1e3)
    ops = blocks * 2 * 64 * 64
    ops_ms = ops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    tflops = max(r[2] for r in fma_tflops())
    fma_ms = ops / (tflops * 1e12) * 1e3
    phase("times", f"on {card}: fdct_quant_blocks at the encode path's "
          f"shapes ({', '.join(str(tuple(x.shape)) for x, _ in f_in)}; "
          f"{blocks} blocks) {ms:.4f} ms for the 3 launches together; "
          f"torch.matmul {lib_ms:.4f}; plain {plain_ms:.4f}; bound "
          f"{bound_ms:.4f}, bytes {bytes_ms:.4f} / operations {ops_ms:.4f}; "
          f"copy-only floor {copy_ms:.4f}; FMA floor {fma_ms:.4f} at the "
          f"measured {tflops:.2f} TFLOP/s")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "copy_floor_ms": copy_ms, "fma_floor_ms": fma_ms,
            "fma_tflops": tflops}


def same_images(got, want, label):
    """Every image of `got` on the card and equal to the one of `want`."""
    import torch

    for j, (a, b) in enumerate(zip(got, want)):
        if a is None or not a.array.is_cuda or not torch.equal(a.array,
                                                               b.array):
            raise RuntimeError(f"{label}: image {j} differs from the "
                               "unsharded decode")
    if len(got) != len(want):
        raise RuntimeError(f"{label}: {len(got)} images for {len(want)}")


def mesh_phase(jpgs, imgs, dec, params, j2k):
    """The multi-device layer on the card: meshes of the visible cards,
    and of cuda:0 repeated (one card holds only such meshes; a shard on the
    same device as another is a shard all the same). Returns the phase's
    numbers and its dp=2 decoder."""
    import torch

    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.codecs.jpeg2000.core import encode_j2k
    from nvimagecodec_tpu_torch.core import trace
    from nvimagecodec_tpu_torch.core.scheduler import GenericEncoder
    from nvimagecodec_tpu_torch.parallel.mesh import make_mesh

    hybrid = [nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)]
    cuda0 = torch.device("cuda", 0)

    # 1) the mesh of every visible card
    full = make_mesh()
    same_images(nic.Decoder(mesh=full, backends=hybrid).decode(jpgs), imgs,
                "Decoder(mesh=make_mesh())")
    phase("mesh", f"make_mesh() here: shape {full.shape}, devices "
          f"{[str(d) for d in full.flat_devices()]}, torch.cuda.device_count()"
          f" {torch.cuda.device_count()}; Decoder(mesh=make_mesh()) equals "
          f"Decoder() on all {BATCH} main-path images")

    # 2) dp=2 over cuda:0 twice: main and dri corpora, K2 and K1 a shard
    dp2 = make_mesh(dp=MESH_DP, devices=[cuda0] * MESH_DP)
    mdec = nic.Decoder(mesh=dp2, backends=hybrid)
    dri_uniq = torch_corpus.dri_streams()
    dri_jpgs = [dri_uniq[i % SEEDS] for i in range(BATCH)]
    out = {"decoder": mdec, "k1_err": 0, "k2_err": 0}
    texts = []
    for name, streams, route in (("main", jpgs, "idx"),
                                 ("dri", dri_jpgs, "dri")):
        want = imgs if name == "main" else dec.decode(streams)
        routes0 = dict(jb.ROUTES)
        counts_zero()
        with no_plain_versions():
            got, k1_err, shapes = k1_held(lambda: mdec.decode(streams))
            torch.cuda.synchronize()
        launches = counts()
        routes = {k: jb.ROUTES[k] - routes0[k] for k in routes0}
        if launches != {"K1": 3 * MESH_DP, "K2": MESH_DP, "K3": 0,
                        "FDCT": 0}:
            raise RuntimeError(f"mesh {name}: launches {launches}, expected "
                               f"K2 once and K1 three times a shard")
        expect = dict.fromkeys(routes0, 0)
        expect[route] = BATCH
        if routes != expect:
            raise RuntimeError(f"mesh {name}: routes {routes}")
        if k1_err > 1:
            raise RuntimeError(f"mesh {name}: K1 vs plain {k1_err} > 1")
        same_images(got, want, f"mesh {name} (dp={MESH_DP})")
        # K2 on the first shard's own inputs: the bucket's first half
        frames = {i: jb.parse_jpeg_structure(d) for i, d in enumerate(streams)}
        k2_err = k2_held(route, frames, dict(enumerate(streams)),
                         BATCH // MESH_DP, cuda0)[0]
        out["k1_err"] = max(out["k1_err"], k1_err)
        out["k2_err"] = max(out["k2_err"], k2_err)
        if name == "main":
            out["launches"] = launches
        texts.append(f"{name}: {BATCH}/{BATCH} equal the unsharded decode, "
                     f"route {route}, launches {launches}, K1 vs plain on "
                     f"every launch (shapes {shapes}) max |diff| {k1_err}, K2 "
                     f"bit-exact vs plain on shard 0's {BATCH // MESH_DP} "
                     "streams")
    # a bucket at the route's floor whose shards are under it: the route is
    # chosen for the bucket, so each shard still takes K2
    small = dri_jpgs[:jb._MIN_BATCH + jb._MIN_BATCH // 2]
    counts_zero()
    routes0 = dict(jb.ROUTES)
    got = mdec.decode(small)
    torch.cuda.synchronize()
    launches = counts()
    if launches["K2"] != MESH_DP or jb.ROUTES["dri"] - routes0["dri"] != len(
            small) or jb.ROUTES["host"] != routes0["host"]:
        raise RuntimeError(f"mesh dri bucket of {len(small)}: launches "
                           f"{launches}, not K2 once a shard")
    same_images(got, dec.decode(small), f"mesh dri bucket of {len(small)}")
    texts.append(f"a dri bucket of {len(small)} (shards of {len(small) // 2}"
                 f", under the floor of {jb._MIN_BATCH}): K2 once a shard, "
                 "equal to the unsharded decode")
    phase("mesh", f"dp={MESH_DP} over cuda:0 twice: " + "; ".join(texts))

    # 3) J2K: one tile's rows over sp=2 and 4, the 16-tile grid over sp=4
    photo = j2k["photos"][0]
    single = j2k["streams"][0]
    tiled = encode_j2k(photo, reversible=True, levels=J2K_LEVELS,
                       tile_size=256)
    notes = []
    for data, sp, what in ((single, 2, "rows"), (single, 4, "rows"),
                           (tiled, 4, "tiles")):
        want = dec.decode(data)
        sdec = nic.Decoder(mesh=make_mesh(dp=1, sp=sp, devices=[cuda0] * sp),
                           backends=hybrid)
        trace.start_collect()
        with no_host_idwt():
            got = sdec.decode(data)
            torch.cuda.synchronize()
        seen = trace.stop_collect()["counters"]
        key = "row_shards" if what == "rows" else "tile_shards"
        if seen.get(f"imgcodec.jpeg2k.{key}") != sp:
            raise RuntimeError(f"mesh j2k {what} sp={sp}: counters {seen}")
        same_images([got], [want], f"mesh j2k {what} sp={sp}")
        if not torch.equal(got.array.cpu(), torch.from_numpy(photo)):
            raise RuntimeError(f"mesh j2k {what} sp={sp}: not the photo")
        notes.append(f"{what} over sp={sp}: {sp} shards, equal to the "
                     "unsharded decode and the photo")
    phase("mesh", f"J2K lossless {J2K_HW}x{J2K_HW}x3, {J2K_LEVELS} levels: "
          + "; ".join(notes) + "; no host IDWT ran")
    # an image under the device stage's floor stays on the host with a mesh
    tiny = photo[:256, :256].copy()
    before = j2k_routes()
    trace.start_collect()
    got = sdec.decode(encode_j2k(tiny, reversible=True, levels=3))
    seen = trace.stop_collect()["counters"]
    took = {k: n for k, n in j2k_took(before).items() if n}
    if took != {"host": 1} or "imgcodec.jpeg2k.tile_shards" in seen or (
            not torch.equal(torch.as_tensor(got.array).cpu(),
                            torch.from_numpy(tiny))):
        raise RuntimeError(f"mesh j2k 256x256: routes {took}, counters {seen}")
    phase("mesh", "J2K 256x256 through the sp=4 Decoder: host route (under "
          "the device stage's floor), the photo exactly")

    # 4) encode: sharded and alone give the unsharded bytes
    tensors = [im.array for im in imgs]
    enc = nic.Encoder(device="cuda", backends=hybrid)
    want = enc.encode(tensors, "jpeg", params)
    genc = GenericEncoder(registry=nic.port_registry(), backends=hybrid,
                          mesh=dp2)
    counts_zero()
    res, f_err, f_share = fdct_held(lambda: genc.encode_batch(
        tensors, [None] * BATCH, "jpeg", params))
    out["launches"]["FDCT"] = counts()["FDCT"]
    if out["launches"]["FDCT"] != 3 * MESH_DP:
        raise RuntimeError(f"mesh encode: {out['launches']['FDCT']} "
                           "fdct_quant_blocks launches, expected 3 a shard")
    got = [r.data for r in res]
    differ = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    if differ or None in want:
        raise RuntimeError(f"mesh encode: {len(differ)} streams differ from "
                           f"the unsharded encode, e.g. {differ[:4]}")
    alone = [j for j in range(SEEDS)
             if enc.encode(tensors[j], "jpeg", params) != want[j]]
    if alone:
        raise RuntimeError(f"encoded alone, images {alone} differ from their "
                           f"bytes in the {BATCH}-image batch")
    out["fdct_err"], out["fdct_share"] = f_err, f_share
    phase("mesh", f"GenericEncoder(mesh=dp{MESH_DP}): {BATCH}/{BATCH} "
          f"streams equal the unsharded encode's bytes, "
          f"{out['launches']['FDCT']} fdct_quant_blocks launches (vs plain "
          f"max |diff| {f_err} on {f_share:.4%}); each of the {SEEDS} "
          f"distinct images encoded alone gives its bytes in the {BATCH}-image"
          " batch")
    return out


def j2k_t1_times(data, photo, dev, card):
    """The Tier-1 kernel (csrc/j2k_t1.cu) on every code-block of one
    1024x1024x3 lossless stream, beside its bytes bound and the native host
    decoder on the same staged blocks, and the device route's whole stage
    (upload of the table and codestream, Tier-1, IDWT, RCT, shift)."""
    import os

    import torch

    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k_core
    from nvimagecodec_tpu_torch.ops import j2k_t1

    t0 = time.perf_counter()
    job = j2k_core._decode_host_stages(data, 0, dev, 0, None, False)
    host_stage_ms = (time.perf_counter() - t0) * 1e3
    if job.stage.t1 is None:
        raise RuntimeError("j2k t1 times: the stream kept the host Tier-1")
    buf, lay = job.stage.t1.staged(
        lambda n: torch.empty(n, dtype=torch.uint8, pin_memory=True))
    staged = buf.to(dev)
    out = torch.zeros(job.stage.offs[-1], dtype=torch.int32, device=dev)
    want = torch.zeros(job.stage.offs[-1], dtype=torch.int32)
    j2k_t1.decode_codeblocks(staged, lay, out)
    j2k_t1.decode_codeblocks_plain(buf, lay, want)
    if not torch.equal(out.cpu(), want):
        raise RuntimeError("j2k t1 times: kernel != native host decoder")
    # the kernel writes every coefficient of its blocks, so it runs again
    # on the same buffer
    kernel_ms = cuda_ms(lambda i: j2k_t1.decode_codeblocks(staged, lay, out),
                        20)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        j2k_t1.decode_codeblocks_plain(buf, lay, torch.zeros_like(want))
    native_ms = (time.perf_counter() - t0) / reps * 1e3
    in_b = buf.numel()
    out_b = out.numel() * out.element_size()
    bound_ms = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
    img = j2k_core._run_device_stage(job)
    if not torch.equal(img.cpu(), torch.from_numpy(photo)):
        raise RuntimeError("j2k t1 times: the device route is not exact")
    stage_ms = cuda_ms(lambda i: j2k_core._run_device_stage(job), 10)
    phase("times", f"on {card}: J2K Tier-1 kernel on one lossless "
          f"{J2K_HW}x{J2K_HW}x3 stream, {lay.rows} code-blocks (CUDA events) "
          f"{kernel_ms:.4f} ms, bit-exact with the native host decoder on "
          f"the same blocks ({os.cpu_count()} threads: {native_ms:.3f} ms); "
          f"bytes bound {bound_ms:.4f} ms ({in_b} B of table and codestream "
          f"read + {out_b} B of int32 subbands written over 3.35 TB/s); the "
          f"device route's stage (upload, Tier-1, IDWT, RCT, shift) "
          f"{stage_ms:.4f} ms; its host stages (Tier-2, the block table) "
          f"{host_stage_ms:.1f} ms")
    return {"kernel_ms": kernel_ms, "native_ms": native_ms,
            "bound_ms": bound_ms, "stage_ms": stage_ms,
            "host_stage_ms": host_stage_ms}


def mesh_times(jpgs, mdec, card):
    """Informational: Decoder(mesh=dp2 on one card) images/s beside the
    unsharded Decoder on the main corpus, alternated within this call."""
    import torch

    import nvimagecodec_tpu_torch as nic

    un = nic.Decoder(device="cuda",
                     backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])

    def rate(d, reps=3):
        d.decode(jpgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            d.decode(jpgs)
        torch.cuda.synchronize()
        return reps * BATCH / (time.perf_counter() - t0)

    ips = {"unsharded": [], "dp2": []}
    for name, d in (("unsharded", un), ("dp2", mdec), ("dp2", mdec),
                    ("unsharded", un)):
        ips[name].append(rate(d))
    phase("times", f"on {card}: Decoder.decode of the {BATCH} main-path "
          f"streams, images/s, order unsharded, dp{MESH_DP}, dp{MESH_DP}, "
          f"unsharded: unsharded {ips['unsharded'][0]:.1f} / "
          f"{ips['unsharded'][1]:.1f}, Decoder(mesh=dp{MESH_DP} over cuda:0 "
          f"twice) {ips['dp2'][0]:.1f} / {ips['dp2'][1]:.1f}")


def j2k_routes():
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k_core

    return dict(j2k_core.ROUTES)


def j2k_took(before) -> dict:
    now = j2k_routes()
    return {k: now[k] - before[k] for k in before}


@contextlib.contextmanager
def no_host_idwt():
    """While the J2K path is driven on the card: the native 5/3 synthesis,
    the native epilogue's caller and the host 9/7 synthesis belong to the
    host path, and reaching one of them is a failure."""
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k_core

    names = ("idwt53", "_host_idwt2d", "_plane_pool")
    real = {n: getattr(j2k_core, n) for n in names}

    def refuse(name):
        def fn(*args, **kwargs):
            raise RuntimeError(f"the J2K device path reached {name}")
        return fn

    for n in names:
        setattr(j2k_core, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(j2k_core, n, fn)


def j2k_phase(dev):
    """8 lossless 1024x1024 streams through Decoder(device="cuda"): every
    one on the device route, a CUDA uint8 tensor equal to its photo and to
    the CPU decode."""
    import numpy as np
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg2000.core import encode_j2k
    from nvimagecodec_tpu_torch.ops import j2k_t1
    from util import make_photo

    t0 = time.perf_counter()
    photos = [make_photo(J2K_HW, J2K_HW, seed=s) for s in range(J2K_BATCH)]
    with ThreadPoolExecutor(4) as pool:
        streams = list(pool.map(
            lambda im: encode_j2k(im, reversible=True, levels=J2K_LEVELS,
                                  stream_type="j2k"), photos))
    enc_s = time.perf_counter() - t0
    dec = nic.Decoder(device="cuda",
                      backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])
    before = j2k_routes()
    launched = j2k_t1.decode_codeblocks.launches
    with no_host_idwt():
        imgs = dec.decode(streams)
        torch.cuda.synchronize()
    took = j2k_took(before)
    if took != {"device": J2K_BATCH, "device_tiles": 0, "host": 0}:
        raise RuntimeError(f"j2k path: not all on the device route: {took}")
    launched = j2k_t1.decode_codeblocks.launches - launched
    if launched != J2K_BATCH:
        raise RuntimeError(f"j2k path: {launched} Tier-1 launches for "
                           f"{J2K_BATCH} streams")
    for j, (im, photo) in enumerate(zip(imgs, photos)):
        if (im is None or not im.array.is_cuda or im.dtype != np.uint8
                or im.shape != (J2K_HW, J2K_HW, 3)):
            raise RuntimeError(f"j2k path: bad result {j}: {im}")
        if not torch.equal(im.array.cpu(), torch.from_numpy(photo)):
            raise RuntimeError(f"j2k path: image {j} is not its photo")
    cpu = nic.Decoder(device="cpu").decode(streams)
    diff = max_diff(imgs, cpu)
    if diff != 0:
        raise RuntimeError(f"j2k path vs CPU decode: max |diff| {diff}")
    phase("j2k_path", f"{J2K_BATCH}/{J2K_BATCH} lossless {J2K_HW}x{J2K_HW}x3 "
          f"streams ({sum(map(len, streams)) // J2K_BATCH} B mean, encoded "
          f"here in {enc_s:.2f} s) -> CUDA uint8 via the device route {took}; "
          f"each equals its photo and the CPU decode (max |diff| {diff}); "
          f"{launched} Tier-1 launches; no host IDWT ran")
    return {"photos": photos, "streams": streams}


def j2k_frames_phase(photo, dev):
    """The other frames, one stream each: tile grids, 9/7, 16-bit, gray, HT,
    and the committed HTJ2K streams, card against the port's CPU decode."""
    import numpy as np
    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg2000.codestream import (
        parse_main_header,
        unwrap_jp2,
    )
    from nvimagecodec_tpu_torch.codecs.jpeg2000.core import encode_j2k

    any_depth = nic.DecodeParams(allow_any_depth=True)
    dec = nic.Decoder(device="cuda")
    cpu = nic.Decoder(device="cpu")
    u16 = photo[:512, :512].astype(np.uint16) * 257 + 3
    frames = [  # name, image, encode keywords, route, tolerance vs the photo
        ("tiles 256 (16 tiles)", photo, dict(tile_size=256), "device_tiles", 0),
        ("partial grid 1000x900, tiles 256", photo[:900, :1000],
         dict(tile_size=256), "host", 0),
        ("irreversible q85", photo, dict(reversible=False, quality=85),
         "device", None),
        ("uint16 512x512", u16, {}, "device", 0),
        ("gray", photo[:, :, 1], {}, "device", 0),
        ("HT", photo, dict(ht=True), "device", 0),
    ]
    notes = []
    for name, img, kw, route, tol in frames:
        kw = {"reversible": True, "levels": J2K_LEVELS, **kw}
        data = encode_j2k(np.ascontiguousarray(img), **kw)
        before = j2k_routes()
        got = dec.decode(data, any_depth)
        took = {k: v for k, v in j2k_took(before).items() if v}
        if took != {route: 1}:
            raise RuntimeError(f"j2k {name}: route {took}, not {route}")
        if got is None or got.array.is_cuda != (route != "host"):
            raise RuntimeError(f"j2k {name}: result {got} on the wrong side")
        want = cpu.decode(data, any_depth)
        a = got.array.cpu().numpy().astype(np.int64)
        d_cpu = int(np.abs(a - np.asarray(want).astype(np.int64)).max())
        if a.shape != img.shape or d_cpu > (0 if tol == 0 else 1):
            raise RuntimeError(f"j2k {name}: card vs CPU decode {d_cpu}")
        if tol == 0 and not np.array_equal(a, img):
            raise RuntimeError(f"j2k {name}: not lossless")
        note = f"{name}: {route}, card vs CPU {d_cpu}"
        if tol is None:
            note += (", PSNR vs photo "
                     f"{psnr_db(got.array.cpu(), torch.from_numpy(img)):.2f}"
                     " dB")
        notes.append(note)
    # the committed HTJ2K streams, small ones: the stage is asked for by name
    forced = nic.Decoder(device="cuda", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"))
    ht_dir = os.path.join(ROOT, "tests", "_corpus", "htj2k")
    names = sorted(f for f in os.listdir(ht_dir)
                   if f.endswith((".j2k", ".jp2")))
    worst = 0
    on_card = 0
    for f in names:
        with open(os.path.join(ht_dir, f), "rb") as fh:
            data = fh.read()
        _siz, cp, _pos = parse_main_header(unwrap_jp2(data), 0)
        got = forced.decode(data, any_depth)
        want = cpu.decode(data, any_depth)
        if got is None or want is None:
            raise RuntimeError(f"j2k corpus {f}: decode failed")
        on_card += int(got.array.is_cuda)
        d = int(np.abs(got.array.cpu().numpy().astype(np.int64)
                       - np.asarray(want).astype(np.int64)).max())
        if d > (0 if cp.reversible else 1):
            raise RuntimeError(f"j2k corpus {f}: card vs CPU decode {d}")
        worst = max(worst, d)
    torch.cuda.synchronize()
    phase("j2k_frames", "; ".join(notes) + f"; tests/_corpus/htj2k: "
          f"{len(names)} streams, {on_card} through the device stage, card "
          f"vs CPU decode max |diff| {worst} (0 where reversible)")


def j2k_encode_phase(photo, dev):
    """A CUDA tensor through Encoder(device="cuda") to JP2, lossless, and
    back through the card: exact, and the CPU encoder's bytes."""
    import torch

    import nvimagecodec_tpu_torch as nic

    params = nic.EncodeParams(
        jpeg2k=nic.Jpeg2kEncodeParams(reversible=True))
    t = torch.from_numpy(photo).to(dev)
    t0 = time.perf_counter()
    data = nic.Encoder(device="cuda").encode(t, "jp2", params)
    secs = time.perf_counter() - t0
    if data is None or data != nic.Encoder(device="cpu").encode(
            photo, "jp2", params):
        raise RuntimeError("j2k encode: not the CPU encoder's bytes")
    back = nic.Decoder(device="cuda").decode(data)
    if back is None or not back.array.is_cuda or not torch.equal(back.array, t):
        raise RuntimeError("j2k encode: the stream does not decode back "
                           "exactly on the card")
    phase("j2k_encode", f"CUDA uint8 {tuple(t.shape)} -> jp2 (reversible, "
          f"{len(data)} B, {secs * 1e3:.1f} ms on the host) -> decoded on the "
          "card: exact; bytes equal the CPU encoder's")


def j2k_failure_phase(streams):
    """A failing device stage raises out of Decoder.decode, whether it fails
    in the IDWT or in the plugin's narrowing of the decoded CUDA tensor; no
    other decoder answers for it."""
    import numpy as np

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs import jpeg2000 as j2k_plugin
    from nvimagecodec_tpu_torch.codecs import system_codecs
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k_core
    from nvimagecodec_tpu_torch.ops import dwt as dwt_ops
    from util import make_photo

    def broken(*args, **kwargs):
        raise RuntimeError("forced failure of the device stage")

    deep = make_photo(512, 512, seed=11).astype(np.uint16) * 257
    cases = [
        (dwt_ops, "idwt2d", list(streams)),
        (j2k_plugin, "widen_uint16",
         [j2k_core.encode_j2k(deep, reversible=True, levels=5)]),
    ]
    answered = []
    real_opj = system_codecs.OpjJpeg2kDecoder.decode_batch
    system_codecs.OpjJpeg2kDecoder.decode_batch = (
        lambda self, *a: answered.append(a))
    try:
        for module, name, batch in cases:
            real = getattr(module, name)
            setattr(module, name, broken)
            raised = None
            try:
                nic.Decoder(device="cuda").decode(batch)
            except j2k_core.J2kDeviceStageError as e:
                raised = e
            finally:
                setattr(module, name, real)
            if raised is None:
                raise RuntimeError(f"j2k failure: Decoder.decode did not "
                                   f"raise with {name} broken")
    finally:
        system_codecs.OpjJpeg2kDecoder.decode_batch = real_opj
    if answered:
        raise RuntimeError("j2k failure: system_openjpeg_decoder answered")
    phase("j2k_failure", "forced device-stage failures (in idwt2d; in the "
          "uint16 narrowing of the decoded CUDA tensor) each raised "
          "J2kDeviceStageError out of Decoder.decode; "
          "system_openjpeg_decoder was not called")


def j2k_times(j2k, dev, card):
    """The J2K device stage of one 1024x1024x3 lossless stream beside its
    bounds and the host IDWT it replaces, Decoder.decode rates per route
    (alternated), and the crossover over four image sizes."""
    import ctypes

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch import native
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k_core
    from nvimagecodec_tpu_torch.codecs.jpeg2000.t1_bridge import idwt53
    from nvimagecodec_tpu_torch.core import trace
    from util import make_photo

    data, photo = j2k["streams"][0], j2k["photos"][0]
    # the pixel stage alone: a job with its Tier-1 on the host, whose
    # subbands go up whole
    rule = j2k_core.tier1_on_device
    j2k_core.tier1_on_device = lambda *a: False
    try:
        t0 = time.perf_counter()
        job = j2k_core._decode_host_stages(data, 0, dev, 0, None, False)
        host_stage_ms = (time.perf_counter() - t0) * 1e3
    finally:
        j2k_core.tier1_on_device = rule
    flat = job.stage.flat
    out = j2k_core._run_device_stage(job)
    if not torch.equal(out.cpu(), torch.from_numpy(photo)):
        raise RuntimeError("j2k times: the timed stage is not exact")
    stage_ms = cuda_ms(lambda i: j2k_core._run_device_stage(job), 20)
    up_ms = cuda_ms(lambda i: flat.to(dev, non_blocking=True), 20)
    LL, bands = job.stage.upload(dev)

    def pixels(i):
        px = j2k_core.device_pixels(LL, bands, job.tile_shape, True, True, 8,
                                    job.origin)
        return j2k_core._to_samples(px.permute(1, 2, 0), 8)

    px_ms = cuda_ms(pixels, 20)
    # behind a spin the events see the card alone, not the host's launching
    px_held_ms = cuda_ms(pixels, 5, hold_ms=60)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        j2k_core._run_device_stage(job)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    n_launch = sum(e.count for e in ev)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    in_b = flat.numel() * flat.element_size()
    out_b = out.numel() * out.element_size()
    bound_ms = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
    up_bound_ms = in_b / PCIE_BYTES_PER_S * 1e3
    if n_launch == 0:
        raise RuntimeError("j2k times: the profiler saw no device activity")

    # the host IDWT + epilogue the stage replaces, on the same subbands
    leaves = job.stage.leaves
    L = native.lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def host_plane(c):
        bands_c = [tuple(leaves[1 + 3 * k + b][c] for b in range(3))
                   for k in range(J2K_LEVELS)]
        return idwt53(leaves[0][c], bands_c, job.tile_shape, job.origin)

    def host_idwt(pool):
        planes = (list(pool.map(host_plane, range(3))) if pool
                  else [host_plane(c) for c in range(3)])
        u8 = np.empty((J2K_HW, J2K_HW, 3), np.uint8)
        L.tic_j2k_rct_shift_u8(*(p.ctypes.data_as(i32p) for p in planes),
                               J2K_HW * J2K_HW, u8.ctypes.data_as(u8p))
        return u8

    if not np.array_equal(host_idwt(None), photo):
        raise RuntimeError("j2k times: the host IDWT is not exact")
    host_ms = {}
    for label, pool in (("one thread", None),
                        ("plane pool", j2k_core._plane_pool())):
        t0 = time.perf_counter()
        for _ in range(5):
            host_idwt(pool)
        host_ms[label] = (time.perf_counter() - t0) / 5 * 1e3
    phase("times", f"on {card}: J2K device stage of one lossless "
          f"{J2K_HW}x{J2K_HW}x3 stream (upload + IDWT + RCT + shift, CUDA "
          f"events) {stage_ms:.4f} ms = upload {up_ms:.4f} ms "
          f"({in_b / up_ms / 1e6:.2f} GB/s; {in_b} B over the link's "
          f"{PCIE_BYTES_PER_S / 1e9:.0f} GB/s = {up_bound_ms:.4f} ms) + torch "
          f"ops {px_ms:.4f} ms at the host's pace of launching, "
          f"{px_held_ms:.4f} ms behind a spin; {n_launch} device launches "
          f"(kernels and copies, torch.profiler), device busy {busy_ms:.4f} "
          f"ms; bytes bound {bound_ms:.4f} ms ({in_b} B of int32 subbands "
          f"read + {out_b} B of uint8 written over 3.35 TB/s); the host "
          f"stages before it (Tier-2 + Tier-1, one stream alone) "
          f"{host_stage_ms:.1f} ms; the host IDWT + epilogue it replaces "
          f"(tic_idwt53 x3 + tic_j2k_rct_shift_u8) {host_ms['one thread']:.3f}"
          f" ms on one thread, {host_ms['plane pool']:.3f} ms over the plane "
          "pool")

    t1 = j2k_t1_times(data, photo, dev, card)

    # Decoder.decode per route, alternated within this call
    dec_dev = nic.Decoder(device="cuda")
    dec_host = nic.Decoder(device="cuda", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=false"))

    def rate(dec, streams, reps):
        dec.decode(streams)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dec.decode(streams)
        torch.cuda.synchronize()
        return reps * len(streams) / (time.perf_counter() - t0)

    order = [("device", dec_dev), ("host", dec_host), ("host", dec_host),
             ("device", dec_dev)]
    ips = {"device": [], "host": []}
    for name, dec in order:
        ips[name].append(rate(dec, j2k["streams"], 3))
    trace.start_collect()
    dec_dev.decode(j2k["streams"])
    torch.cuda.synchronize()
    got = trace.stop_collect()
    spans = {k.rsplit(".", 1)[1]: v * 1e3 for k, v in got["spans"].items()
             if k.startswith("imgcodec.jpeg2k.")}
    phase("times", f"on {card}: Decoder.decode of {J2K_BATCH} lossless "
          f"{J2K_HW}x{J2K_HW} J2K streams, device stage "
          f"{ips['device'][0]:.2f} / {ips['device'][1]:.2f} images/s, "
          f"device_pixel_stage=false {ips['host'][0]:.2f} / "
          f"{ips['host'][1]:.2f} images/s (order device, host, host, device); "
          "spans of one device-stage batch summed over its "
          f"{J2K_BATCH} worker threads, ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(spans.items()))
          + f"; H2D {got['counters'].get('imgcodec.jpeg2k.h2d_bytes', 0)} B")

    # the crossover: one stream a call, device stage forced against host
    forced = nic.Decoder(device="cuda", options=(
        "cuda_jpeg2k_hybrid_decoder:device_pixel_stage=true"))
    rows = []
    for hw in (128, 256, 512, 1024, 2048):
        im = make_photo(hw, hw, seed=3)
        s = j2k_core.encode_j2k(im, reversible=True, levels=J2K_LEVELS,
                                stream_type="j2k")
        reps = max(3, min(40, (1 << 22) // (hw * hw)))
        r = {"device": [], "host": []}
        for name, dec in (("device", forced), ("host", dec_host),
                          ("host", dec_host), ("device", forced)):
            r[name].append(rate(dec, [s], reps))
        rows.append(f"{hw}x{hw}: device {r['device'][0]:.1f} / "
                    f"{r['device'][1]:.1f}, host {r['host'][0]:.1f} / "
                    f"{r['host'][1]:.1f}")
    phase("times", f"on {card}: J2K crossover, Decoder.decode of one lossless "
          "RGB stream a call, images/s with the device stage forced against "
          f"device_pixel_stage=false (floor today: "
          f"{j2k_core.DEVICE_STAGE_MIN_PIXELS} pixels): " + "; ".join(rows))
    return t1


if __name__ == "__main__":
    sys.exit(main())
