"""fdct_quant_blocks (fDCT + quantisation, csrc/fdct.cu) alone on one NVIDIA
GPU: build, check, time.

    python3 tools/bench_fdct.py [--images 256] [--reps 20]
                                [--variant FILE.cu] ...

Needs one CUDA device and nvcc. It prints the card's name and power limit,
what ptxas says of the kernel (registers, shared memory, spills), then

- checks the kernel against its plain PyTorch version (bar: within 1 on
  fewer than 1% of entries) at the encode path's three shapes (`--images`
  375x500 4:2:0 images: [B, 3072, 64] and twice [B, 768, 64] float32
  centred samples), and at the edges: 1, 127, 128, 129 and one ring of
  tiles plus one block (`FDCT_RING_BLOCKS`), each equal to the slice of a
  larger launch, from a 16-byte aligned source and from one 4 bytes past
  it; and the digest of its coefficients on the seeded blocks that
  tests/test_torch_gpu.py pins (`FDCT_BLOCKS_SHA256`);
- times, with CUDA events behind a spin kernel, over `--reps` launches: the
  kernel; its plain version; `torch.matmul` of fp32 [N, 64] @ [64, 64] (the
  one library call that computes the same product); and a copy-only floor,
  `torch.Tensor.copy_` of the same float32 samples into an int32 buffer
  (the bytes the kernel moves, and no arithmetic);
- prints the two floors: the bytes (samples read, coefficients written,
  the matrix, once each) over 3.35 TB/s, and the 4096 FMAs a block at the
  rate `tools/fp32_peak.py` measures on this card; and the bound that
  chip_smoke.py reports (bytes, or operations over 67 TFLOP/s).

Each `--variant` builds another source of the kernel (the parent commit's,
or an edited copy of csrc/fdct.cu) into its own library and runs the same
checks and times beside the built kernel, in turns. The last line is one JSON object with the numbers. Any
failed check raises.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
SPIN_CYCLES_PER_MS = 2.0e6  # torch.cuda._sleep counts the card's clock
SOURCE = os.path.join(ROOT, "nvimagecodec_tpu_torch", "csrc", "fdct.cu")


def ptxas(nvcc, arch, src) -> str:
    r = subprocess.run([nvcc, "-gencode", arch, "-std=c++17", "-O3",
                        "-Xptxas", "-v", "-c", src, "-o", os.devnull],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{src} does not compile:\n{r.stderr}")
    return r.stderr.strip()


def build_variant(nvcc, arch, build_dir, tag, src):
    so = os.path.join(build_dir, f"libfdct_variant_{tag}.{os.getpid()}.so")
    r = subprocess.run([nvcc, "-gencode", arch, "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", src, "-o", so],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{src} does not build:\n{r.stderr}")
    L = ctypes.CDLL(so)
    os.remove(so)
    vp = ctypes.c_void_p
    L.tic_fdct_quant_blocks.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    L.tic_fdct_quant_blocks.restype = ctypes.c_int
    return L


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_fdct: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np

    from fp32_peak import fma_tflops
    from nvimagecodec_tpu_torch import _build
    from nvimagecodec_tpu_torch.codecs.jpeg.encode import quant_matrix
    from nvimagecodec_tpu_torch.codecs.jpeg.tables import (
        STD_CHROMA_QUANT,
        STD_LUMA_QUANT,
        quality_scaled_quant,
    )
    from nvimagecodec_tpu_torch.ops import kernels
    from test_torch_gpu import (
        FDCT_BLOCKS_SHA256,
        FDCT_RING_BLOCKS,
        fdct_blocks_digest,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    nvcc = _build._nvcc()
    variants = [("built", SOURCE)] + [
        (f"v{i}", os.path.abspath(s)) for i, s in enumerate(args.variant, 1)]
    for name, src in variants:
        print(f"ptxas -v, {name} ({os.path.relpath(src, ROOT)}):\n"
              + ptxas(nvcc, _build._ARCH, src), flush=True)
    secs = _build.build()
    print(f"build: {secs:.2f} s", flush=True)
    os.makedirs(_build._BUILD, exist_ok=True)
    with ThreadPoolExecutor(max(1, len(variants) - 1)) as pool:
        libs = list(pool.map(
            lambda v: build_variant(nvcc, _build._ARCH, _build._BUILD, *v),
            variants[1:]))

    def launcher(L):
        def fdct(x, M):
            out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
            with torch.cuda.device(x.device):
                rc = L.tic_fdct_quant_blocks(
                    x.data_ptr(), M.data_ptr(), out.data_ptr(),
                    x.numel() // 64, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "fdct_quant_blocks variant launch")
            return out
        return fdct

    fns = {"built": kernels.fdct_quant_blocks}
    fns.update((v[0], launcher(L)) for v, L in zip(variants[1:], libs))
    plain = kernels.fdct_quant_blocks_plain

    def check(fn, x, M, what):
        got = fn(x, M)
        d = (got - plain(x, M)).abs()
        err, share = int(d.max()), float((d > 0).double().mean())
        if err > 1 or share >= 0.01:
            raise RuntimeError(f"{what}: max |kernel - plain| {err} on "
                               f"{share:.4%} of entries")
        return got, err, share

    # -- digest and edges -----------------------------------------------------
    rng = np.random.default_rng(0)
    M_luma = quant_matrix(quality_scaled_quant(STD_LUMA_QUANT, 85), dev)
    M_chroma = quant_matrix(quality_scaled_quant(STD_CHROMA_QUANT, 85), dev)
    digests, edge_err = {}, 0
    for name, fn in fns.items():
        digests[name] = fdct_blocks_digest(fn, dev)
        for n in (1, 127, 128, 129, FDCT_RING_BLOCKS):
            x = torch.from_numpy(rng.integers(-128, 128, (n + 1000, 64))
                                 .astype(np.float32)).to(dev)
            whole = fn(x, M_luma)
            buf = torch.empty(n * 64 + 1, dtype=torch.float32, device=dev)
            odd = buf[1:].view(n, 64)  # 4 bytes past a 16-byte boundary
            odd.copy_(x[3:3 + n])
            for part, how in ((x[3:3 + n].contiguous(), "aligned"),
                              (odd, "unaligned")):
                got, err, _ = check(fn, part, M_luma, f"{name}, {n} blocks, "
                                    f"{how}")
                edge_err = max(edge_err, err)
                if not torch.equal(got, whole[3:3 + n]):
                    raise RuntimeError(f"{name}: {n} blocks ({how}) differ "
                                       "from their slice of a larger launch")
        print(f"{name}: blocks digest {digests[name]} (pinned "
              f"{FDCT_BLOCKS_SHA256}); edges 1, 127, 128, 129, "
              f"{FDCT_RING_BLOCKS} blocks, aligned and 4 bytes past "
              "alignment, equal to their slice of a larger launch", flush=True)
    print(f"edges: max |kernel - plain| = {edge_err} (bar 1)", flush=True)

    # -- the encode path's shapes -------------------------------------------
    def cuda_ms(fn, reps, hold_ms=20.0):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    B = args.images
    shapes = [("Y", (B, 3072, 64), M_luma), ("Cb", (B, 768, 64), M_chroma),
              ("Cr", (B, 768, 64), M_chroma)]
    ins = [(name, torch.from_numpy(rng.integers(-128, 128, shape)
                                   .astype(np.float32)).to(dev), M)
           for name, shape, M in shapes]
    path_err, path_share = 0, 0.0
    for name, fn in fns.items():
        for comp, x, M in ins:
            _, err, share = check(fn, x, M, f"{name} {comp}")
            path_err, path_share = max(path_err, err), max(path_share, share)
    print(f"encode path's shapes {[tuple(x.shape) for _, x, _ in ins]}: max "
          f"|kernel - plain| {path_err} on {path_share:.4%} of entries "
          "(bar 1 on < 1%)", flush=True)

    rounds = {name: [] for name in fns}
    for _ in range(2):  # every kernel in turns, twice
        for name, fn in fns.items():
            rounds[name].append(sum(
                cuda_ms(lambda: fn(x, M), args.reps) for _, x, M in ins))
    plain_ms = sum(cuda_ms(lambda: plain(x, M), 5) for _, x, M in ins)
    lib_ms = 0.0
    copy_ms = 0.0
    for _, x, M in ins:
        mt = M.T.contiguous()
        lib_ms += cuda_ms(lambda: torch.matmul(x, mt), args.reps)
        dst = torch.empty(x.shape, dtype=torch.int32, device=dev)
        copy_ms += cuda_ms(lambda: dst.copy_(x), args.reps)
        del dst
    blocks = sum(x.numel() // 64 for _, x, _ in ins)
    nbytes = blocks * 64 * 4 * 2 + len(ins) * 64 * 64 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = blocks * 2 * 64 * 64
    ops_ms = ops / FP32_FLOPS * 1e3
    rate = max(r[2] for r in fma_tflops())
    fma_ms = ops / (rate * 1e12) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    for name in fns:
        print(f"{name}: {blocks} blocks, 3 launches together "
              f"{rounds[name][0]:.4f} ms, again {rounds[name][1]:.4f} ms; "
              f"{bound_ms / min(rounds[name]):.3f} of the bound's rate",
              flush=True)
    print(f"plain {plain_ms:.4f} ms; torch.matmul {lib_ms:.4f}; copy-only "
          f"floor (float32 -> int32 copy_) {copy_ms:.4f}; bytes floor "
          f"{bytes_ms:.4f} ({nbytes} B at 3.35 TB/s); FMA floor {fma_ms:.4f} "
          f"({ops / 1e9:.2f} GFLOP at the measured {rate:.2f} TFLOP/s); "
          f"bound {bound_ms:.4f} (operations at 67 TFLOP/s {ops_ms:.4f})",
          flush=True)
    print(json.dumps({
        "card": card, "images": B, "blocks": blocks,
        "variants": {n: os.path.relpath(s, ROOT) for n, s in variants},
        "ms": rounds, "plain_ms": plain_ms, "library_ms": lib_ms,
        "copy_floor_ms": copy_ms, "bytes_floor_ms": bytes_ms,
        "fma_floor_ms": fma_ms, "fma_tflops": rate, "bound_ms": bound_ms,
        "edge_max_abs_err": edge_err, "max_abs_err": path_err,
        "max_share_differing": path_share, "blocks_digest": digests,
        "digest_ok": {n: d == FDCT_BLOCKS_SHA256
                      for n, d in digests.items()}}), flush=True)
    if digests["built"] != FDCT_BLOCKS_SHA256:
        raise RuntimeError("the built kernel's coefficients differ from the "
                           "pinned digest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
