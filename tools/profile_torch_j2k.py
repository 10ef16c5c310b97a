"""Where the time of the PyTorch + CUDA port's JPEG2000 decode goes.

    python3 tools/profile_torch_j2k.py [--batch 8] [--size 1024] [--reps 3]

Needs one CUDA device. Encodes `--batch` lossless RGB photos of
`--size` x `--size` (5 levels, one tile; chip_smoke.py's j2k corpus) with the
port's own encoder and prints:

- images/s through `Decoder.decode` with the device pixel stage and with
  `cuda_jpeg2k_hybrid_decoder:device_pixel_stage=false`, alternated (device,
  host, host, device), for the batch and for one stream alone;
- the port's span times and the H2D counter of one batch per route
  (`core/trace.py`; spans sum over the sample threads);
- the device stage of one stream under `torch.profiler`: launches and device
  time by kernel name, device busy time against the stage's wall time;
- the host stages of one stream alone: Tier-2 and the code-block table of
  the device route (Tier-1 on the card), and Tier-2 + the host Tier-1 (the
  route `core.tier1_on_device` keeps for other streams) against the number
  of Tier-1 threads.

The card's `nvidia-smi` name and power limit come first, so that every
number can be kept beside them.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_j2k: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch.profiler import ProfilerActivity, profile

    import nvimagecodec_tpu_torch as nic
    from nvimagecodec_tpu_torch.codecs.jpeg2000 import core as j2k
    from nvimagecodec_tpu_torch.core import trace
    from util import make_photo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; host CPUs: {os.cpu_count()}", flush=True)
    dev = torch.device("cuda")

    photos = [make_photo(args.size, args.size, seed=s)
              for s in range(args.batch)]
    with ThreadPoolExecutor(4) as pool:
        streams = list(pool.map(
            lambda im: j2k.encode_j2k(im, reversible=True, levels=5,
                                      stream_type="j2k"), photos))
    print(f"corpus: {args.batch} lossless {args.size}x{args.size}x3 streams, "
          f"{sum(map(len, streams)) // args.batch} B mean", flush=True)

    plug = "cuda_jpeg2k_hybrid_decoder:device_pixel_stage="
    decs = {"device": nic.Decoder(device="cuda", options=plug + "true"),
            "host": nic.Decoder(device="cuda", options=plug + "false")}

    def rate(dec, batch):
        dec.decode(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            dec.decode(batch)
        torch.cuda.synchronize()
        return args.reps * len(batch) / (time.perf_counter() - t0)

    for label, batch in ((f"batch of {args.batch}", streams),
                         ("one stream", streams[:1])):
        ips = {"device": [], "host": []}
        for route in ("device", "host", "host", "device"):
            ips[route].append(rate(decs[route], batch))
        print(f"Decoder.decode, {label}, images/s: device stage "
              f"{ips['device'][0]:.2f} / {ips['device'][1]:.2f}, host stage "
              f"{ips['host'][0]:.2f} / {ips['host'][1]:.2f}", flush=True)

    for route, dec in decs.items():
        trace.start_collect()
        t0 = time.perf_counter()
        dec.decode(streams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = trace.stop_collect()
        spans = ", ".join(f"{k.rsplit('.', 1)[1]} {v * 1e3:.2f}"
                          for k, v in sorted(got["spans"].items())
                          if k.startswith("imgcodec.jpeg2k."))
        print(f"one batch, {route} stage: wall {wall * 1e3:.1f} ms; spans "
              f"summed over the sample threads, ms: {spans}; counters "
              f"{got['counters']}", flush=True)

    # the device stage of one stream alone, under the profiler
    job = j2k._decode_host_stages(streams[0], 0, dev, 0, None, False)
    j2k._run_device_stage(job)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        j2k._run_device_stage(job)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"device stage of one stream (profiled): wall {wall * 1e3:.3f} ms, "
          f"{sum(e.count for e in ev)} launches, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}", flush=True)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:4d}  "
              f"{e.key[:90]}", flush=True)

    # the host stages of one stream alone: the device route's, then the
    # host Tier-1's against its thread count
    t0 = time.perf_counter()
    for _ in range(args.reps):
        j2k._decode_host_stages(streams[0], 0, dev, 0, None, False)
    ms = (time.perf_counter() - t0) / args.reps * 1e3
    print(f"host stages (Tier-2 + the code-block table) of one stream: "
          f"{ms:.1f} ms", flush=True)
    rule = j2k.tier1_on_device
    j2k.tier1_on_device = lambda *a: False
    try:
        for nt in (1, 2, 4, 8):
            t0 = time.perf_counter()
            for _ in range(args.reps):
                j2k._decode_host_stages(streams[0], nt, dev, 0, None, False)
            ms = (time.perf_counter() - t0) / args.reps * 1e3
            print(f"host stages (Tier-2 + host Tier-1) of one stream, {nt} "
                  f"Tier-1 thread(s): {ms:.1f} ms", flush=True)
    finally:
        j2k.tier1_on_device = rule
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
