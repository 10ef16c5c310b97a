// fdct_quant_blocks: forward 8x8 DCT + quantisation in one fixed order.
//
// Replaces the fDCT+quant product of the JPEG encode stage, which the JAX
// package leaves to XLA as a float32 matmul (nvimagecodec_tpu/codecs/jpeg/
// encode.py:187; no Pallas kernel). Per 8x8 block of centred samples x:
//   c[k]   = sum_{p = 0..63} x[p] * M[k][p]      (fmaf, p ascending)
//   out[k] = sign(c[k]) * floor(|c[k]| + 0.5)      (int32)
// where M is the quant-folded DCT matrix [64 coefficients][64 pixels]
// (ops/dct.py quant_dct_matrix). Every output is one chain of 64 fp32 FMAs
// in that order, whatever the number of blocks or the grid: a block's
// coefficients are a function of that block alone, so an image encodes to
// the same bytes alone and inside any batch (a library product picks another
// kernel, and another reduction order, for another shape).
//
// Bound on an H100: the product [N, 64] x [64, 64] is 8192 fp32 operations a
// block against 256 bytes in and 256 bytes out, so the memory rate bounds it
// (by a little over the FMA rate). Design, the transposed use of K1's tiling
// (csrc/idct.cu):
// - a CTA of 128 threads takes tiles of 128 blocks in a grid-stride loop,
//   three CTAs an SM, M transposed into shared memory once per CTA;
// - a tile's float32 rows come in by 16-byte cp.async straight into their
//   padded shared-memory rows (68 floats apart, so the micro-tile loads do
//   not conflict on banks); the other CTAs of the SM hide the copy;
// - each thread owns 8 blocks x 8 coefficients in 64 registers, so a 16-byte
//   shared-memory load feeds 16 or 32 FMAs;
// - results leave as 16-byte stores, eight lanes on 128 contiguous bytes.
// PERF.md holds its time beside the bound and beside torch.matmul.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;  // blocks a CTA multiplies at a time
constexpr int kThreads = 128;   // 4 warps x (32 blocks x 64 coefficients)
constexpr int kAStride = 68;    // floats between staged rows: 64 + 4
constexpr int kMStride = 68;    // floats between rows of M transposed
constexpr int kCtasPerSm = 3;
constexpr int kSmemBytes = kTileRows * kAStride * 4  // staged samples
                           + 64 * kMStride * 4;      // M transposed

// Start the copy of `rows` blocks of 64 floats into their staged rows:
// 16-byte cp.async where the source is 16-byte aligned (vec), plain loads
// otherwise. Completes at the next cp.async wait + __syncthreads().
__device__ __forceinline__ void load_tile(float* As, const float* src,
                                          int rows, int vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * 16; i += kThreads) {
      const int r = i >> 4, c = i & 15;
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(As + r * kAStride + 4 * c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(__cvta_generic_to_global(src + 64 * r + 4 * c))
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < rows * 64; i += kThreads)
      As[(i >> 6) * kAStride + (i & 63)] = src[i];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// round half away from zero, as the plain version's
// sign(c) * floor(|c| + 0.5)
__device__ __forceinline__ int quantise(float c) {
  const int v = (int)floorf(fabsf(c) + 0.5f);
  return c < 0.f ? -v : v;
}

__device__ __forceinline__ int4 finish(const float* acc) {
  return make_int4(quantise(acc[0]), quantise(acc[1]), quantise(acc[2]),
                   quantise(acc[3]));
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
fdct_quant_kernel(const float* __restrict__ x, const float* __restrict__ M,
                  int32_t* __restrict__ out, long long nblocks, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [kTileRows][kAStride]
  float* Ms = As + kTileRows * kAStride;       // [64 p][kMStride] = M[k][p]

  const int tid = threadIdx.x;
  const long long ntiles = (nblocks + kTileRows - 1) / kTileRows;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;

  for (int i = tid; i < 64 * 64; i += kThreads)
    Ms[(i & 63) * kMStride + (i >> 6)] = M[i];

  // rows warp*32 + rg + 4i, coefficients 4pg..4pg+3 and 32 + those
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pg = lane & 7;
  const int rg = lane >> 3;
  const float* a_base = As + (warp * 32 + rg) * kAStride;
  const float* b_base = Ms + 4 * pg;

  for (; tile < ntiles; tile += gridDim.x) {
    const long long left = nblocks - tile * kTileRows;
    const int rows = (int)(left < kTileRows ? left : kTileRows);
    __syncthreads();  // the previous tile's As is no longer read
    load_tile(As, x + tile * kTileRows * 64, rows, vec);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // As (and Ms) complete

    // rows past the last block hold stale samples: they are multiplied and
    // never stored
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_base + 4 * i * kAStride +
                                                4 * c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = b_base + (4 * c + kk) * kMStride;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], kk);
          acc[i][0] = fmaf(av, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av, b1.w, acc[i][7]);
        }
      }
    }

    int32_t* o = out + (tile * kTileRows + warp * 32 + rg) * 64 + 4 * pg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (warp * 32 + rg + 4 * i < rows) {
        *reinterpret_cast<int4*>(o + 4 * i * 64) = finish(&acc[i][0]);
        *reinterpret_cast<int4*>(o + 4 * i * 64 + 32) = finish(&acc[i][4]);
      }
    }
  }
}

}  // namespace

extern "C" int tic_fdct_quant_blocks(const void* x, const void* M, void* out,
                                     long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fdct_quant_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fdct_quant_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  long long ctas = (nblocks + kTileRows - 1) / kTileRows;
  const long long cap = (long long)sms * kCtasPerSm;
  if (ctas > cap) ctas = cap;
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fdct_quant_kernel<<<(unsigned)ctas, kThreads, kSmemBytes,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const float*)M, (int32_t*)out, nblocks, vec);
  return (int)cudaGetLastError();
}
