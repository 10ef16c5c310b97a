"""Where the time of the PyTorch + CUDA port's batched JPEG encode goes.

    python3 tools/profile_torch_encode.py [--batch 256] [--reps 5]

Needs one CUDA device. Takes chip_smoke.py's corpus (375x500 q85 4:2:0, 8
make_photo seeds cycled), decodes it on the card and encodes the decoded
images again (q85, 4:2:0, standard Huffman tables), per route:

- device/card: `encode_batch_cuda` with the images as CUDA tensors (the
  transcode case: nothing goes up, int16 coefficients come back);
- device/host: the same with the images as numpy arrays (one pinned upload);
- host/host: `device_stage=False` with numpy arrays (the fused native
  encoder per sample over the thread pool; the card does nothing);
- host/card: `device_stage=False` with CUDA tensors (each image is copied to
  the host first).

For each it prints images/s on the host clock (the routes alternated), the
port's span times and counters per batch (`core/trace.py`), and the device
kernels of one batch under `torch.profiler` with the device's busy time
against the batch's wall time. Then the transcode path (`decode_batches` at
depth 2, resize to 224x224 on the card, `Encoder.encode`) the same way, and
the device route's host stage alone (`_finish_one` per sample, serial and
over thread pools of 1 to 16 workers), with the header, tables and native
arguments shared across the bucket and built per sample, beside the fused
native encoder on the same images.

The card's `nvidia-smi` name and power limit come first, so that every
number can be kept beside them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_encode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch.profiler import ProfilerActivity, profile

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg.batch_encode import (
        encode_batch_cuda,
    )
    from nvimagecodec_tpu_torch.core import trace
    from nvimagecodec_tpu_torch.ops.resize import resize
    from nvimagecodec_tpu_torch.pipeline import decode_batches
    from util import make_photo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; host CPUs: {os.cpu_count()}", flush=True)

    params = nic.EncodeParams(
        quality=85, chroma_subsampling=nic.ChromaSubsampling.CSS_420,
        jpeg=nic.JpegEncodeParams(optimized_huffman=False))
    photos = [make_photo(375, 500, seed=s) for s in range(8)]
    uniq = nic.Encoder(device="cpu").encode(photos, "jpeg", params)
    jpgs = [uniq[i % 8] for i in range(args.batch)]
    hybrid = [nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)]
    dec = nic.Decoder(device="cuda", backends=hybrid)
    enc = nic.Encoder(device="cuda", backends=hybrid)
    on_card = [im.array for im in dec.decode(jpgs)]
    on_host = [t.cpu().numpy() for t in on_card]

    def encode_fn(device_stage, images):
        def fn():
            out = encode_batch_cuda(images, params, "cuda",
                                    device_stage=device_stage)
            if any(not (r.status & nic.ProcessingStatus.SUCCESS)
                   for r in out):
                raise RuntimeError("an encode failed")
        return fn

    quarter = max(1, args.batch // 4)

    def transcode():
        batches = [jpgs[lo:lo + quarter]
                   for lo in range(0, args.batch, quarter)]
        for batch in decode_batches(batches, decoder=dec, depth=2):
            small = resize(torch.stack([im.array for im in batch]), 224, 224,
                           "bilinear")
            enc.encode(list(small), "jpeg", params)

    runs = {"device/card": encode_fn(True, on_card),
            "device/host": encode_fn(True, on_host),
            "host/host": encode_fn(False, on_host),
            "host/card": encode_fn(False, on_card),
            "transcode": transcode}

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        return args.reps * args.batch / (time.perf_counter() - t0)

    # alternate the routes so that drift on a shared host hits each
    order = list(runs) + list(reversed(runs))
    for label in order:
        print(f"{label}: {rate(runs[label]):.1f} images/s", flush=True)

    for label, fn in runs.items():
        trace.start_collect()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        d = trace.stop_collect()
        spans = {k: round(v * 1000 / args.reps, 3)
                 for k, v in d["spans"].items()}
        counters = {k: v / args.reps for k, v in d["counters"].items()}
        print(f"spans, ms per batch ({label}): {json.dumps(spans)}; "
              f"counters per batch: {json.dumps(counters)}", flush=True)

    for label, fn in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1000
        print(f"profiled batch ({label}): wall {wall * 1000:.3f} ms, device "
              f"busy {busy:.3f} ms, idle share {1 - busy / (wall * 1000):.3f}",
              flush=True)
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:16]:
            print(f"  {e.self_device_time_total / 1000:9.3f} ms  "
                  f"x{e.count:4d}  {e.key[:90]}", flush=True)
    host_stage(args.batch, on_card, on_host, params)
    return 0


def host_stage(batch, on_card, on_host, params):
    """The host stage of the device route alone: `_finish_one` on one
    bucket's coefficients, per sample on one thread and the bucket over
    thread pools, the bucket's shared tail given or built per sample (Python
    under the GIL), and the fused native encoder on the same images."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg import batch_encode as be
    from nvimagecodec_tpu_torch.codecs.jpeg import native_encode as ne
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import encode_pixels

    dev = torch.device("cuda")
    frame = be.bucket_frame(tuple(on_card[0].shape), params, 8)
    coefs = be._fetch_coefficients(
        [c.to(torch.int16)
         for c in encode_pixels(torch.stack(on_card), frame, dev)], dev)
    jp = params.jpeg or nic.JpegEncodeParams()
    tail = be._standard_tail(frame)
    dc, ac = be._standard_tables(frame)
    setup = ne.fused_setup(frame, dc, ac)
    fns = {
        "shared tail": lambda j: be._finish_one(
            frame, [c[j] for c in coefs], jp, tail),
        "tail per sample": lambda j: be._finish_one(
            frame, [c[j] for c in coefs], jp),
        "fused native encoder": lambda j: ne.encode_scan_fused(
            on_host[j], frame, None, None, setup=setup),
    }

    def serial(fn, n=32):
        fn(0)
        t0 = time.perf_counter()
        for j in range(n):
            fn(j)
        return (time.perf_counter() - t0) / n * 1e3

    def pooled(fn, workers):
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(fn, range(min(8, batch))))
            t0 = time.perf_counter()
            list(pool.map(fn, range(batch)))
            return (time.perf_counter() - t0) * 1e3

    for label in list(fns) + list(reversed(fns)):
        fn = fns[label]
        pools = {w: round(pooled(fn, w), 1) for w in (1, 2, 4, 8, 16)}
        print(f"host stage, {label}: {serial(fn):.3f} ms a sample on one "
              f"thread; ms a batch of {batch} by pool workers: "
              f"{json.dumps(pools)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
