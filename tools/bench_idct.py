"""K1 (dequant + IDCT, csrc/idct.cu) alone on one NVIDIA GPU: build, check,
time.

    python3 tools/bench_idct.py [--images 256] [--reps 20]

Needs one CUDA device and nvcc. It prints the card's name and power limit,
what ptxas says of the kernel (registers, shared memory, spills), then

- checks the kernel against its plain PyTorch version (bar: within 1) on
  random coefficients at the main path's three shapes (`--images` 375x500
  4:2:0 images: [B, 48, 64, 64] and twice [B, 24, 32, 64], zigzag order),
  that natural and zigzag input of the same blocks give identical samples,
  and the edges: a zigzag prefix (K = 10, 33), a block count that is no
  multiple of the tile, 12-bit precision, and a source pointer that is not
  16-byte aligned;
- times, with CUDA events over `--reps` launches, the kernel, its plain
  version and the one library call that computes the same product
  (`torch.matmul` of fp32 [N, 64] @ [64, 64]), beside the bound: the larger
  of bytes / 3.35 TB/s and fp32 operations / 67 TFLOP/s.

The last line is one JSON object with the numbers. Any failed check raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores


def k1_bound_ms(nblocks: int, K: int):
    """(bound_ms, bound_by) of K1 on nblocks blocks of K coefficients: each
    input byte read once, each output byte written once, against 2*K*64
    fp32 operations a block."""
    by_bytes = (nblocks * (2 * K + 256) + 64 * 64 * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = nblocks * 2 * K * 64 / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_idct: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from nvimagecodec_tpu_torch import _build
    from nvimagecodec_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    src = os.path.join(ROOT, "nvimagecodec_tpu_torch", "csrc", "idct.cu")
    r = subprocess.run(
        [_build._nvcc(), "-gencode", _build._ARCH, "-std=c++17", "-O3",
         "-Xptxas", "-v", "-c", src, "-o", os.devnull],
        capture_output=True, text=True)
    print(r.stderr.strip(), flush=True)
    if r.returncode != 0:
        raise RuntimeError("idct.cu does not compile")
    secs = _build.build()
    print(f"build: {secs:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    quant = rng.integers(1, 64, 64).astype(np.int32)
    M = kernels.idct_matrix(quant, dev)
    zz = torch.from_numpy(kernels.ZIGZAG_NAT.astype(np.int64)).to(dev)

    def coefs(shape, amp=64):
        """Sparse, JPEG-like: about one entry in four nonzero."""
        x = rng.integers(-amp, amp + 1, shape)
        x[rng.random(shape) > 0.25] = 0
        return torch.from_numpy(x.astype(np.int16)).to(dev)

    def diff(a, b) -> int:
        return int((a - b).abs().max())

    # -- edges ------------------------------------------------------------
    edge_err = 0
    for shape, zigzag, precision in [
            ((1, 3, 5, 64), False, 8), ((1, 3, 5, 64), True, 8),
            ((3, 7, 19, 10), True, 8), ((2, 5, 13, 33), True, 8),
            ((1, 1, 1, 64), True, 8), ((2, 9, 15, 64), True, 12)]:
        x = coefs(shape, 2000 if precision == 12 else 64)
        got = kernels.dequant_idct_blocks(x, M, precision, zigzag)
        want = kernels.dequant_idct_blocks_plain(x, M, precision, zigzag)
        edge_err = max(edge_err, diff(got, want))
    flat = coefs((1, 1, 301, 64))
    odd = torch.empty(301 * 64 + 3, dtype=torch.int16, device=dev)
    view = odd[3:].view(1, 1, 301, 64)  # 6 bytes off a 16-byte boundary
    view.copy_(flat)
    if not torch.equal(kernels.dequant_idct_blocks(view, M, 8, True),
                       kernels.dequant_idct_blocks(flat, M, 8, True)):
        raise RuntimeError("K1: unaligned source differs from aligned")
    torch.cuda.synchronize()
    if edge_err > 1:
        raise RuntimeError(f"K1 edges vs plain: max |diff| {edge_err} > 1")
    print(f"edges: max |kernel - plain| = {edge_err} (bar 1); unaligned "
          "source equals aligned", flush=True)

    # -- the main path's shapes ---------------------------------------------
    def cuda_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    B = args.images
    rows = []
    for name, shape in [("Y", (B, 48, 64, 64)), ("Cb", (B, 24, 32, 64)),
                        ("Cr", (B, 24, 32, 64))]:
        x = coefs(shape)  # zigzag order
        got = kernels.dequant_idct_blocks(x, M, 8, True)
        want = kernels.dequant_idct_blocks_plain(x, M, 8, True)
        err = diff(got, want)
        nat = torch.empty_like(x)
        nat[..., zz] = x  # natural position ZIGZAG_NAT[k] holds zigzag k
        same = torch.equal(kernels.dequant_idct_blocks(nat, M, 8, False), got)
        del want, nat
        if err > 1 or not same:
            raise RuntimeError(f"K1 {name}: max |diff| {err}, natural equals "
                               f"zigzag: {same}")
        n = x.numel() // 64
        a32 = x.reshape(n, 64).to(torch.float32)
        mt = M.T.contiguous()
        ms = cuda_ms(lambda: kernels.dequant_idct_blocks(x, M, 8, True),
                     args.reps)
        plain = cuda_ms(
            lambda: kernels.dequant_idct_blocks_plain(x, M, 8, True), 5)
        lib = cuda_ms(lambda: torch.matmul(a32, mt), args.reps)
        ms2 = cuda_ms(lambda: kernels.dequant_idct_blocks(x, M, 8, True),
                      args.reps)
        bound, by = k1_bound_ms(n, 64)
        rows.append({"name": name, "blocks": n, "max_abs_err": err,
                     "ms": ms, "ms_again": ms2, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bound, "bound_by": by})
        print(f"{name}: {n} blocks, max |kernel - plain| {err}, natural == "
              f"zigzag; kernel {ms:.4f} ms (again {ms2:.4f}), plain "
              f"{plain:.4f}, matmul {lib:.4f}, bound {bound:.4f} ({by})",
              flush=True)
        del x, a32, got
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "ms_again", "plain_ms", "library_ms", "bound_ms")}
    print(f"three launches together: kernel {total['ms']:.4f} ms (again "
          f"{total['ms_again']:.4f}), plain {total['plain_ms']:.4f}, matmul "
          f"{total['library_ms']:.4f}, bound {total['bound_ms']:.4f}; "
          f"{total['bound_ms'] / total['ms']:.3f} of the bound's rate",
          flush=True)
    print(json.dumps({"card": card, "images": B, "edge_max_abs_err": edge_err,
                      "components": rows, "total": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
