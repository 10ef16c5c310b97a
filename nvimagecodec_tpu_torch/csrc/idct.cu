// K1: fused dequantization + 8x8 inverse DCT + level shift + round + clip.
//
// Replaces the Pallas kernel nvimagecodec_tpu/ops/pallas_kernels.py
// (_build_idct_blocks_fn / dequant_idct_blocks). Per 8x8 block:
//   out[p] = clip(rint(sum_n coef_nat[n] * M[p][n] + center), 0, maxval)
// where M is the dequant-folded IDCT matrix [64 pixels][64 natural
// coefficients] (ops/dct.py dequant_idct_matrix), fp32 FMA only: no TF32,
// no tensor cores, so the result stays within 1 of the float32 matmul the
// reference runs.
//
// Coefficients arrive as int16 [nblocks, K], either in natural order (K = 64)
// or as a zigzag prefix (K <= 64). They are staged in shared memory as fp32
// in natural order (zeros past K), and every output sums over natural index
// n = 0..63 in that order, so a block gives bit-identical pixels whichever
// order it came in.
//
// Bound on an H100: the batch is the product [N, 64] x [64, 64], 8192 fp32
// operations a block against 2K + 256 bytes, so the FMA rate and the memory
// rate bound it about equally (operations by a little). Design:
// - a CTA of 128 threads takes tiles of 128 blocks in a grid-stride loop,
//   three CTAs an SM, M transposed in shared memory once per CTA;
// - the tile's int16 coefficients come in by 16-byte cp.async; once they are
//   converted, the next tile's copy is issued and flies while this tile is
//   multiplied;
// - whole blocks (K = 64) are converted eight coefficients a thread from one
//   16-byte shared-memory load and scattered to their natural positions;
// - each thread owns a micro-tile of 8 blocks x 8 pixels in 64 registers, so
//   a 16-byte shared-memory load feeds 16 (coefficients) or 32 (matrix) FMAs
//   instead of one: 16 loads for 256 FMAs. The loop over the 64 coefficients
//   is unrolled four deep only (16 coefficients a pass): unrolled whole it is
//   70 KB of instructions, and the warps of three CTAs at different places
//   in it miss the instruction cache, which costs more than the loop's
//   branches save;
// - rows are staged 68 floats apart and a warp's four row groups take
//   neighbouring rows, so the micro-tile loads do not conflict on banks;
// - results leave as 16-byte stores, eight lanes on 128 contiguous bytes.
// PERF.md holds its time beside the bound, beside the FMA rate the card
// sustains from registers (tools/fp32_peak.py) and beside torch.matmul.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;  // blocks a CTA multiplies at a time
constexpr int kThreads = 128;   // 4 warps x (32 blocks x 64 pixels)
constexpr int kAStride = 68;    // floats between staged rows: 64 + 4
constexpr int kMStride = 68;    // floats between rows of M transposed
constexpr int kCtasPerSm = 3;
constexpr int kSmemBytes = kTileRows * kAStride * 4  // staged coefficients
                           + 64 * kMStride * 4       // M transposed
                           + kTileRows * 64 * 2;     // raw int16 tile

// zigzag index -> natural position (T.81 figure A.6)
__constant__ int8_t kNatOfZz[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

// natural position n -> zigzag index (inverse of T.81 figure A.6)
__constant__ int8_t kZzOfNat[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
};

// Start the copy of n_elems int16 from global to shared memory: 16-byte
// cp.async where the source is 16-byte aligned (vec), plain 2-byte copies for
// the rest. Completes at the next cp.async wait + __syncthreads().
__device__ __forceinline__ void load_tile(int16_t* raw, const int16_t* src,
                                          int n_elems, int vec) {
  const int nvec = vec ? (n_elems >> 3) : 0;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(raw + 8 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(__cvta_generic_to_global(src + 8 * i))
                 : "memory");
  }
  for (int i = 8 * nvec + threadIdx.x; i < n_elems; i += kThreads)
    raw[i] = src[i];
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ int4 finish(const float* acc, float center,
                                       unsigned maxval) {
  // round half to even, like torch.round; the conversion to unsigned clips
  // below at 0
  int4 r;
  r.x = (int)min(__float2uint_rn(acc[0] + center), maxval);
  r.y = (int)min(__float2uint_rn(acc[1] + center), maxval);
  r.z = (int)min(__float2uint_rn(acc[2] + center), maxval);
  r.w = (int)min(__float2uint_rn(acc[3] + center), maxval);
  return r;
}

// One raw 32-bit word -> its two int16 halves as floats.
__device__ __forceinline__ float lo16(int w) { return (float)(short)w; }
__device__ __forceinline__ float hi16(int w) { return (float)(w >> 16); }

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
idct_blocks_kernel(const int16_t* __restrict__ coef, int K, int zigzag,
                   const float* __restrict__ M, int32_t* __restrict__ out,
                   long long nblocks, float center, unsigned maxval,
                   int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [kTileRows][kAStride]
  float* Ms = As + kTileRows * kAStride;       // [64 n][kMStride] = M[p][n]
  int16_t* raw = reinterpret_cast<int16_t*>(Ms + 64 * kMStride);

  const int tid = threadIdx.x;
  const long long ntiles = (nblocks + kTileRows - 1) / kTileRows;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;

  auto rows_of = [&](long long t) {
    const long long left = nblocks - t * kTileRows;
    return (int)(left < kTileRows ? left : kTileRows);
  };

  // the first tile flies while M is transposed into shared memory
  load_tile(raw, coef + tile * kTileRows * K, rows_of(tile) * K, vec);
  for (int i = tid; i < 64 * 64; i += kThreads)
    Ms[(i & 63) * kMStride + (i >> 6)] = M[i];

  // staging role, whole blocks (K = 64): this thread converts the eight
  // coefficients 8j..8j+7 of every sixteenth row and scatters them to their
  // natural positions
  const int j = tid & 7;
  float* stage[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    stage[e] = As + (tid >> 3) * kAStride +
               (zigzag ? (int)kNatOfZz[8 * j + e] : 8 * j + e);
  // staging role, a zigzag prefix (K < 64): natural coefficient n of every
  // second row, zero past the prefix
  const int n = tid & 63;
  const int src = zigzag ? kZzOfNat[n] : n;
  const bool have = src < K;
  // multiply role: rows warp*32 + rg + 4i, pixels 4pg..4pg+3 and 32 + those
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pg = lane & 7;
  const int rg = lane >> 3;
  const float* a_base = As + (warp * 32 + rg) * kAStride;
  const float* b_base = Ms + 4 * pg;

  for (; tile < ntiles; tile += gridDim.x) {
    const int rows = rows_of(tile);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // raw (and Ms) complete; As no longer read

    // rows past the last block hold stale coefficients: they are multiplied
    // and never stored
    if (K == 64) {
      const int4* chunk = reinterpret_cast<const int4*>(raw) + tid;
#pragma unroll
      for (int i = 0; i < kTileRows / 16; ++i) {
        const int4 w = chunk[i * kThreads];
        const int o = i * 16 * kAStride;
        stage[0][o] = lo16(w.x);
        stage[1][o] = hi16(w.x);
        stage[2][o] = lo16(w.y);
        stage[3][o] = hi16(w.y);
        stage[4][o] = lo16(w.z);
        stage[5][o] = hi16(w.z);
        stage[6][o] = lo16(w.w);
        stage[7][o] = hi16(w.w);
      }
    } else {
      for (int r = tid >> 6; r < kTileRows; r += kThreads / 64)
        As[r * kAStride + n] = have ? (float)raw[r * K + src] : 0.f;
    }
    __syncthreads();  // As complete; raw free

    const long long next = tile + gridDim.x;
    if (next < ntiles)
      load_tile(raw, coef + next * kTileRows * K, rows_of(next) * K, vec);

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
        *reinterpret_cast<int4*>(o + 4 * i * 64) =
            finish(&acc[i][0], center, maxval);
        *reinterpret_cast<int4*>(o + 4 * i * 64 + 32) =
            finish(&acc[i][4], center, maxval);
      }
    }
  }
}

}  // namespace

extern "C" int tic_idct_blocks(const void* coef, int K, int zigzag,
                               const void* M, void* out, long long nblocks,
                               float center, int maxval, void* stream) {
  if (nblocks <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(idct_blocks_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(idct_blocks_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  long long ctas = (nblocks + kTileRows - 1) / kTileRows;
  const long long cap = (long long)sms * kCtasPerSm;
  if (ctas > cap) ctas = cap;
  const int vec = (reinterpret_cast<uintptr_t>(coef) & 15) == 0;
  idct_blocks_kernel<<<(unsigned)ctas, kThreads, kSmemBytes,
                       (cudaStream_t)stream>>>(
      (const int16_t*)coef, K, zigzag, (const float*)M, (int32_t*)out,
      nblocks, center, (unsigned)maxval, vec);
  return (int)cudaGetLastError();
}
