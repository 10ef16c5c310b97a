"""Where the time of the PyTorch + CUDA port's batched JPEG decode goes.

    python3 tools/profile_torch_decode.py [--batch 256] [--reps 5]

Needs one CUDA device. Decodes chip_smoke.py's corpora (375x500 q85 4:2:0,
standard Huffman tables, 8 make_photo seeds cycled; the same photos with a
restart marker every MCU row and the 8 progressive streams, both committed
in tests/torch_corpus) and prints, for the idx, dri and host routes and for
the progressive route (`decode_progressive`, one stream at a time):

- images/s through `Decoder.decode` and `decode_batch_cuda`, on the host
  clock to `torch.cuda.synchronize()`;
- the port's span times and counters per batch (`core/trace.py`);
- the device kernels of one batch under `torch.profiler`, with the device's
  busy time against the batch's wall time.

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
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch.profiler import ProfilerActivity, profile

    import nvimagecodec_tpu_torch as nic
    import torch_corpus
    from nvimagecodec_tpu_torch.codecs.jpeg import batch as jb
    from nvimagecodec_tpu_torch.core import trace
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
    dri_uniq = torch_corpus.dri_streams()
    dri_jpgs = [dri_uniq[i % 8] for i in range(args.batch)]
    prog = torch_corpus.progressive_streams()
    dec = nic.Decoder(device="cuda",
                      backends=[nic.Backend(nic.BackendKind.HYBRID_CPU_GPU)])
    p = nic.DecodeParams()
    routes = {"idx": (jpgs, True), "dri": (dri_jpgs, True),
              "host": (jpgs, False)}

    def batch_fn(route):
        data, device_entropy = routes[route]
        return lambda: jb.decode_batch_cuda(data, p, "cuda",
                                            device_entropy=device_entropy)

    def prog_fn():
        for d in prog:
            jb.decode_progressive(d, "cuda")

    def rate(fn, n=args.batch):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        return args.reps * n / (time.perf_counter() - t0)

    # alternate the routes so that drift on a shared host hits each
    for label, fn in [("Decoder.decode (idx)", lambda: dec.decode(jpgs)),
                      ("decode_batch_cuda idx", batch_fn("idx")),
                      ("decode_batch_cuda dri", batch_fn("dri")),
                      ("decode_batch_cuda host", batch_fn("host")),
                      ("Decoder.decode (dri)", lambda: dec.decode(dri_jpgs)),
                      ("decode_batch_cuda host", batch_fn("host")),
                      ("decode_batch_cuda dri", batch_fn("dri")),
                      ("decode_batch_cuda idx", batch_fn("idx"))]:
        print(f"{label}: {rate(fn):.1f} images/s", flush=True)
    print(f"decode_progressive (one stream at a time): "
          f"{rate(prog_fn, len(prog)):.1f} images/s", flush=True)

    runs = {r: (batch_fn(r), args.batch) for r in routes}
    runs["prog"] = (prog_fn, len(prog))
    for route, (fn, n) in runs.items():
        trace.start_collect()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        d = trace.stop_collect()
        per = args.reps * (1 if route != "prog" else n)
        spans = {k: round(v * 1000 / per, 3) for k, v in d["spans"].items()}
        counters = {k: v / per for k, v in d["counters"].items()}
        unit = "batch" if route != "prog" else "stream"
        print(f"spans, ms per {unit} ({route}): {json.dumps(spans)}; "
              f"counters per {unit}: {json.dumps(counters)}", flush=True)

    for route, (fn, n) in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1000
        print(f"profiled {'batch' if route != 'prog' else f'{n} streams'} "
              f"({route}): wall {wall * 1000:.3f} ms, device "
              f"busy {busy:.3f} ms, idle share {1 - busy / (wall * 1000):.3f}",
              flush=True)
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:14]:
            print(f"  {e.self_device_time_total / 1000:9.3f} ms  "
                  f"x{e.count:4d}  {e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
