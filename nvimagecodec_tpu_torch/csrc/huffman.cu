// K2: baseline sequential JPEG Huffman decode, one thread per segment.
//
// Replaces the Pallas kernel nvimagecodec_tpu/ops/pallas_entropy.py
// (_build_kernel / decode_segments_device) and keeps its contract bit for bit:
//   words [W, S] uint32   column s = segment s's destuffed bits, MSB first,
//                         starting at bit side[1, s] of word 0; bits past
//                         row W read as 0
//   side  [6, S] int32    0: MCUs in the segment (0 = padding lane),
//                         1: start bit, 2..5: DC predictor seed per component
//   tabs  [ncomp, 2, 34 + nv] int32   per component, DC then AC:
//                         maxcode[17], base[17] (sym index = code + base[len]),
//                         values[nv] zero padded; an index outside [0, nv)
//                         reads 0
//   out   [R * bpm, 64, S] int16      zigzag coefficients, block mcu*bpm+b;
//                         blocks at MCU index >= side[0, s] are all zero
//   err   [S] int32       1 when a lane met a missing code, a DC size > 15
//                         or an AC index past 63; the lane then goes on
//                         decoding from where it stopped, as the TPU kernel
//                         does, so even its garbage matches
//
// The TPU kernel broadcast words through a per-lane FIFO and ran a 16-step
// compare chain because its vector lanes cannot gather. A CUDA thread reads
// its own column (neighbouring lanes read neighbouring addresses) and walks
// the canonical code lengths against tables in shared memory. Tables are
// runtime inputs, so one build serves every bucket.
//
// Bound on an H100: latency. The walk is serial within a lane and lanes
// diverge, so the kernel lives on how many lanes are in flight (B * nsegs;
// 6144 for a bucket of 256 images of 375x500 4:2:0).

#include <cstdint>
#include <cuda_runtime.h>

#include "huffman_common.cuh"

namespace {

using tic::BitReader;
using tic::CompMap;
using tic::decode_symbol;
using tic::extend;
using tic::kMaxBpm;
using tic::kTabHeader;

constexpr int kThreads = 32;

__device__ void decode_lane(const uint32_t* words, int W, long long S,
                            const int32_t* side, const int32_t* tabs, int nv,
                            const CompMap& cmap, int bpm, int R, int16_t* out,
                            int32_t* err, long long s) {
  const int nmcu = side[s];
  int pred[4] = {side[2 * S + s], side[3 * S + s], side[4 * S + s],
                 side[5 * S + s]};
  const int tstride = kTabHeader + nv;
  BitReader br{words + s, W, S, 0, 0, 0};
  br.init(side[S + s]);
  bool bad = false;

  for (int mcu = 0; mcu < R; ++mcu) {
    for (int b = 0; b < bpm; ++b) {
      int16_t* ob = out + (long long)(mcu * bpm + b) * 64 * S + s;
      if (mcu >= nmcu) {
        for (int z = 0; z < 64; ++z) ob[z * S] = 0;
        continue;
      }
      const int ci = cmap.c[b];
      const int32_t* dct = tabs + (2 * ci) * tstride;
      const int32_t* act = tabs + (2 * ci + 1) * tstride;
      int len = 0, sym = 0;

      // DC: on a bad code nothing is consumed and the coefficient stays 0
      br.refill();
      int dc = 0;
      if (decode_symbol(dct, nv, br.peek16(), &len, &sym) && sym <= 15) {
        br.skip(len);
        int diff = extend(br.get(sym), sym);
        pred[ci] = (int)((unsigned)pred[ci] + (unsigned)diff);
        dc = pred[ci];
      } else {
        bad = true;
      }
      ob[0] = (int16_t)dc;

      // AC: run/size symbols until EOB or position 63; slots skipped by a
      // run are written as zeros in passing, so every slot is stored once
      int k = 1, kw = 1;
      for (;;) {
        br.refill();
        if (!decode_symbol(act, nv, br.peek16(), &len, &sym)) {
          bad = true;
          break;
        }
        br.skip(len);
        const int run = sym >> 4, size = sym & 15;
        if (size == 0) {
          if (run != 15) break;  // EOB
          k += 16;               // ZRL
          if (k > 63) break;
          continue;
        }
        const int kk = k + run;
        if (kk > 63) {
          bad = true;
          break;
        }
        const int val = extend(br.get(size), size);
        for (; kw < kk; ++kw) ob[kw * S] = 0;
        ob[kk * S] = (int16_t)val;
        kw = kk + 1;
        k = kk + 1;
        if (k > 63) break;
      }
      for (; kw < 64; ++kw) ob[kw * S] = 0;
    }
  }
  err[s] = bad ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
huffman_kernel(const uint32_t* __restrict__ words, int W, long long S,
               const int32_t* __restrict__ side,
               const int32_t* __restrict__ tables, int ntab, int nv,
               CompMap cmap, int bpm, int R, int16_t* __restrict__ out,
               int32_t* __restrict__ err) {
  extern __shared__ int32_t s_tab[];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = tables[i];
  __syncthreads();
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  decode_lane(words, W, S, side, s_tab, nv, cmap, bpm, R, out, err, s);
}

}  // namespace

extern "C" int tic_huffman_decode(const void* words, int W, long long S,
                                  const void* side, const void* tables,
                                  int ncomp, int nv, const int32_t* comp_map,
                                  int bpm, int R, void* out, void* err,
                                  void* stream) {
  if (bpm < 1 || bpm > kMaxBpm || ncomp < 1 || ncomp > 4)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  CompMap cmap = {};
  for (int b = 0; b < bpm; ++b) cmap.c[b] = (int8_t)comp_map[b];
  const int ntab = ncomp * 2 * (kTabHeader + nv);
  const size_t smem = (size_t)ntab * sizeof(int32_t);
  const unsigned grid = (unsigned)((S + kThreads - 1) / kThreads);
  huffman_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, W, S, (const int32_t*)side,
      (const int32_t*)tables, ntab, nv, cmap, bpm, R, (int16_t*)out,
      (int32_t*)err);
  return (int)cudaGetLastError();
}
