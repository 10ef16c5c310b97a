"""The fp32 FMA rate one NVIDIA GPU sustains from registers alone.

    python3 tools/fp32_peak.py

Needs one CUDA device and nvcc. Compiles a kernel in which every thread
keeps an 8 x 8 tile of accumulators in registers and does nothing but
`fmaf` on them (no loads, no stores until the end), runs it at 1, 2, 3, 4
and 8 CTAs of 128 threads an SM, and prints the rate beside the card's name,
power limit and clock. It is the ceiling that a kernel of fp32 FMAs such as
K1 (csrc/idct.cu) can be held against, beside the data sheet's peak.
`fma_tflops()` is the same measurement for other scripts
(tools/bench_fdct.py, chip_smoke.py): the FMA floor of fdct_quant_blocks.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
extern "C" __global__ void __launch_bounds__(128)
fma_only(float* out, int iters, float s) {
  float acc[64], a[8], b[8];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = threadIdx.x * 0.001f + i;
#pragma unroll
  for (int i = 0; i < 8; ++i) { a[i] = s + i; b[i] = s - i; }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += 1e-9f;
  }
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) t += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int run_fma_only(float* out, int ctas, int iters, void* stream) {
  fma_only<<<ctas, 128, 0, (cudaStream_t)stream>>>(out, iters, 1.0f);
  return (int)cudaGetLastError();
}
"""


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fma_tflops(per_sm=(1, 2, 3, 4, 8), iters: int = 20000):
    """[(CTAs an SM, ms, TFLOP/s)] of the register-only FMA kernel on the
    current CUDA device, one timed launch each after a warm-up. Builds the
    kernel into nvimagecodec_tpu_torch/build/."""
    import torch

    from nvimagecodec_tpu_torch import _build

    os.makedirs(_build._BUILD, exist_ok=True)
    src = os.path.join(_build._BUILD, "fma_only.cu")
    so = os.path.join(_build._BUILD, f"libfma_only.{os.getpid()}.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", _build._ARCH, "-O3",
                    "-shared", "-Xcompiler", "-fPIC", src, "-o", so],
                   check=True)
    L = ctypes.CDLL(so)
    os.remove(so)
    L.run_fma_only.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
    L.run_fma_only.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    out = torch.empty(sms * max(per_sm) * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(ctas):
        rc = L.run_fma_only(out.data_ptr(), ctas, iters, stream)
        if rc != 0:
            raise RuntimeError(f"fma_only launch: CUDA error {rc}")

    rows = []
    for k in per_sm:
        ctas = sms * k
        launch(ctas)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(ctas)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        rows.append((k, ms, ctas * 128 * iters * 64 * 2 / ms / 1e9))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp32_peak: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    print(smi("name,power.limit"), flush=True)
    for per_sm, ms, tflops in fma_tflops():
        print(f"{per_sm} CTAs/SM: {ms:.4f} ms, {tflops:.2f} TFLOP/s fp32 "
              f"(clocks.sm, power.draw: {smi('clocks.sm,power.draw')})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
