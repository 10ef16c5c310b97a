// fdct_quant_blocks: forward 8x8 DCT + quantisation in one fixed order.
//
// Replaces the fDCT+quant product of the JPEG encode stage, which the JAX
// package leaves to XLA as a float32 matmul (nvimagecodec_tpu/codecs/jpeg/
// encode.py:187; no Pallas kernel). Per 8x8 block of centred samples x:
//   c[k]   = sum_{p = 0..63} x[p] * M[k][p]      (fmaf, p ascending)
//   out[k] = sign(c[k]) * floor(|c[k]| + 0.5)      (int32)
// where M is the quant-folded DCT matrix [64 coefficients][64 pixels]
// (ops/dct.py quant_dct_matrix). Every output is one chain of 64 fp32 FMAs
// in that order, whatever the number of blocks, the grid or the design of
// this kernel: a block's coefficients are a function of that block alone,
// so an image encodes to the same bytes alone and inside any batch (a
// library product picks another kernel, and another reduction order, for
// another shape).
//
// Two floors on an H100, nearly equal, so the copy and the arithmetic must
// overlap: 256 bytes in and 256 out a block (the memory rate), and 4096 fp32
// FMAs a block (the FMA rate; the card sustains about 49 of its 67 TFLOP/s
// from registers, tools/fp32_peak.py). Design:
// - persistent CTAs, one an SM, each walking the tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... of 128 blocks (32 KB of contiguous float32);
//   M transposed stays in shared memory for the whole launch;
// - one producer warp keeps a ring of kStages tile stages full: per stage a
//   `full` mbarrier (the producer's expected bytes, completed by the copies)
//   and an `empty` one (one arrival per consumer thread). A tile comes in as
//   four TMA bulk copies, one of each 32-row chunk (8 KB), the chunks
//   kChunkPad floats apart in shared memory; a source that is not 16-byte
//   aligned, which bulk copies refuse, is loaded by the producer warp with
//   plain loads into the same ring instead. (One 256-byte bulk copy a row,
//   into rows padded one by one, took x1.6 the time of one copy a tile on
//   the H100: small bulk copies cost per copy, not per byte);
// - kGroups consumer warpgroups take the CTA's tiles in turn (tile j of the
//   CTA goes to group j % kGroups and stage j % kStages; kStages is a
//   multiple of kGroups, so each stage serves one group and its barrier
//   phases are waited on in order): while the groups multiply their tiles,
//   the copies of the following tiles are in flight;
// - each consumer thread owns 8 blocks x 8 coefficients in 64 registers, so
//   a 16-byte shared-memory load feeds 16 or 32 FMAs; the loop over the 64
//   samples is unrolled four deep (unrolled whole, K1's thrashed the
//   instruction cache); the four rows a warp loads at once lie in the four
//   chunks, which the padding puts on separate banks;
// - a stage goes back to the producer as soon as its samples are read,
//   before the results leave as 16-byte stores, eight lanes on 128
//   contiguous bytes.
// PERF.md holds the kernel's time beside both floors, a copy-only floor and
// torch.matmul, and the readings of the other geometries that were tried.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;       // blocks in a tile
constexpr int kGroupThreads = 128;   // 4 warps x (32 blocks x 64 coefficients)
constexpr int kGroups = 2;           // consumer warpgroups a CTA
constexpr int kStages = 4;           // tiles in the ring
constexpr int kChunkRows = 32;       // rows a bulk copy brings
constexpr int kChunkPad = 4;         // floats after each chunk
constexpr int kChunkFloats = kChunkRows * 64 + kChunkPad;
constexpr int kMStride = 68;         // floats between rows of M transposed
constexpr int kConsumers = kGroups * kGroupThreads;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kStageFloats = kTileRows / kChunkRows * kChunkFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4  // the ring
                           + 64 * kMStride * 4         // M transposed
                           + 2 * kStages * 8;          // full, empty

static_assert(kStages >= 3 && kStages % kGroups == 0,
              "a ring of 3 or more stages, each serving one group");
static_assert(kChunkPad % 4 == 0, "16-byte aligned chunks");
static_assert(kSmemBytes <= 232448, "the H100's shared memory a block");

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

__device__ __forceinline__ int rows_of(long long tile, long long nblocks) {
  const long long left = nblocks - tile * kTileRows;
  return (int)(left < kTileRows ? left : kTileRows);
}

// The producer warp: tile j of this CTA into stage j % kStages once the
// stage's previous tile is read. Bulk copies where the source is 16-byte
// aligned (vec), plain loads by the warp's lanes otherwise; row r of a tile
// lands at (r / 32) * kChunkFloats + (r % 32) * 64.
__device__ __forceinline__ void produce(float* ring, uint64_t* full,
                                        uint64_t* empty, const float* x,
                                        long long nblocks, long long ntiles,
                                        int vec) {
  const int lane = threadIdx.x & 31;
  long long j = 0;
  for (long long tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, ++j) {
    const int s = (int)(j % kStages);
    const unsigned round = (unsigned)(j / kStages);
    mbar_wait(smem(empty + s), (round & 1) ^ 1);  // round 0 passes at once
    const int rows = rows_of(tile, nblocks);
    float* dst = ring + s * kStageFloats;
    const float* src = x + tile * kTileRows * 64;
    const unsigned bar = smem(full + s);
    if (vec) {
      if (lane == 0) mbar_arrive_expect_tx(bar, rows * 64 * 4);
      __syncwarp();
      const int k = lane * kChunkRows;  // lanes 0-3: a chunk each
      if (k < rows)
        bulk_copy(dst + lane * kChunkFloats, src + k * 64,
                  min(kChunkRows, rows - k) * 64 * 4, bar);
    } else {
      for (int i = lane; i < rows * 64; i += 32)
        dst[i / (kChunkRows * 64) * kChunkFloats + i % (kChunkRows * 64)] =
            src[i];
      __syncwarp();  // orders the lanes' stores before lane 0's release
      if (lane == 0) mbar_arrive(bar);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fdct_quant_kernel(const float* __restrict__ x, const float* __restrict__ M,
                  int32_t* __restrict__ out, long long nblocks, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stage][chunk][row][64]
  float* Ms = ring + kStages * kStageFloats;  // [64 p][kMStride] = M[k][p]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ms + 64 * kMStride);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long ntiles = (nblocks + kTileRows - 1) / kTileRows;
  if (blockIdx.x >= ntiles) return;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem(full + s), 1);
      mbar_init(smem(empty + s), kGroupThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    produce(ring, full, empty, x, nblocks, ntiles, vec);
    return;
  }

  // the first tiles fly while the consumers transpose M
  for (int i = tid; i < 64 * 64; i += kConsumers)
    Ms[(i & 63) * kMStride + (i >> 6)] = M[i];
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // group g, warp wq of it, lane (rg, pg): rows rg*32 + wq*8 + i,
  // coefficients 4pg..4pg+3 and 32 + those
  const int g = warp >> 2;
  const int lane = tid & 31;
  const int pg = lane & 7;
  const int rg = lane >> 3;
  const int row0 = rg * kChunkRows + (warp & 3) * 8;
  const float* b_base = Ms + 4 * pg;

  long long j = g;
  for (long long tile = blockIdx.x + (long long)g * gridDim.x; tile < ntiles;
       tile += (long long)kGroups * gridDim.x, j += kGroups) {
    const int s = (int)(j % kStages);
    mbar_wait(smem(full + s), (unsigned)(j / kStages) & 1);
    const float* a_base =
        ring + s * kStageFloats + rg * kChunkFloats + (warp & 3) * 8 * 64;

    // rows past the last block hold stale samples: they are multiplied and
    // never stored
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;

#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_base + i * 64 + 4 * c);
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
    mbar_arrive(smem(empty + s));  // the stage's samples are read

    const int rows = rows_of(tile, nblocks);
    int32_t* o = out + (tile * kTileRows + row0) * 64 + 4 * pg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row0 + i < rows) {
        *reinterpret_cast<int4*>(o + i * 64) = finish(&acc[i][0]);
        *reinterpret_cast<int4*>(o + i * 64 + 32) = finish(&acc[i][4]);
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
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (nblocks + kTileRows - 1) / kTileRows;
  const long long ctas = ntiles < sms ? ntiles : sms;
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fdct_quant_kernel<<<(unsigned)ctas, kThreads, kSmemBytes,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const float*)M, (int32_t*)out, nblocks, vec);
  return (int)cudaGetLastError();
}
