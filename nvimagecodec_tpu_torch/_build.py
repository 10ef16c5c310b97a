"""Builds the hand-written CUDA kernels of csrc/ into one shared library.

At first use, `nvcc` compiles every `csrc/*.cu` for sm_90a, one process per
source, all at once, and links the objects into `build/libtic_cuda.so`
beside this file; the library is rebuilt when a source or a shared header
(`csrc/*.cuh`) is newer than it. The build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
library.
The C entry points take raw pointers and the CUDA stream as `void*`, launch
on that stream without synchronising, and return `cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(_DIR, "build")
_SO = os.path.join(_BUILD, "libtic_cuda.so")
_ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_m = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > so_m for s in sources() + headers())


def build() -> float:
    """Compile csrc/*.cu into the shared library; returns seconds taken."""
    os.makedirs(_BUILD, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = f"{_SO}.{tag}.tmp"
    nvcc = _nvcc()
    srcs = sources()
    objs = [os.path.join(_BUILD, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]

    def compile_one(src_obj):
        src, obj = src_obj
        return subprocess.run(
            [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-c", src, "-o", obj], capture_output=True, text=True)

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            runs = list(pool.map(compile_one, zip(srcs, objs)))
        failed = [f"{s}:\n{r.stderr}" for s, r in zip(srcs, runs)
                  if r.returncode != 0]
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        r = subprocess.run([nvcc, "-gencode", _ARCH, "-shared", "-o", tmp,
                            *objs], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed:\n{r.stderr}")
        os.replace(tmp, _SO)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            if _needs_build():
                build()
            L = ctypes.CDLL(_SO)
            _declare(L)
            _lib = L
        return _lib


def _declare(L: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    L.tic_idct_blocks.argtypes = [vp, i32, i32, vp, vp, i64, ctypes.c_float,
                                  i32, vp]
    L.tic_idct_blocks.restype = i32
    L.tic_fdct_quant_blocks.argtypes = [vp, vp, vp, i64, vp]
    L.tic_fdct_quant_blocks.restype = i32
    i32p = ctypes.POINTER(ctypes.c_int32)
    vpp = ctypes.POINTER(vp)
    L.tic_huffman_decode_into.argtypes = [
        vp, i32, i64, vp, vp, i32, i32, vp, i32, i32p, i32, i32, i32, i64,
        i32, vpp, vp, i32, i32, vp]
    L.tic_huffman_decode_into.restype = i32
    L.tic_prog_huffman_decode_into.argtypes = [
        i32, vp, i32, i64, vp, vp, i32, i32, vp, i32, i32, i32p, i32p, vpp,
        i32, i64, i32, i32, i32, i32, vp, i32, vp]
    L.tic_prog_huffman_decode_into.restype = i32
    L.tic_j2k_t1_decode_blocks.argtypes = [vp, i32, vp, vp, i32, i32, vp]
    L.tic_j2k_t1_decode_blocks.restype = i32


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches`. Wrappers run on several
    threads at once (`pipeline.decode_batches`), and `+=` on an attribute is
    a read and a write."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
