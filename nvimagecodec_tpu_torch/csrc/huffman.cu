// K2: baseline sequential JPEG Huffman decode, one segment per lane, stored
// where the pixel stage reads it.
//
// Replaces the Pallas kernel nvimagecodec_tpu/ops/pallas_entropy.py
// (_build_kernel / decode_segments_device) together with the reassembly
// that followed it (reassemble_components). Inputs as the TPU kernel's:
//   words [W, S] uint32   column s = segment s's destuffed bits, MSB first,
//                         starting at bit side[1, s] of word 0; bits past
//                         row W read as 0
//   side  [6, S] int32    0: MCUs in the segment (0 = padding lane),
//                         1: start bit, 2..5: DC predictor seed per component
//   tabs  [ncomp, 2, 34 + nv] int32   per component, DC then AC (see
//                         huffman_common.cuh)
//   look  [ncomp * 2, 1 << L] int16   their lookahead rows
// Outputs:
//   stack[c] [B, bh_c, bw_c, 64] int16   component c's zigzag blocks, a
//                         block = 128 contiguous bytes, bh_c = mcus_y * v_c,
//                         bw_c = mcus_x * h_c. Lane s is segment s % nsegs
//                         of image s / nsegs; block b of its MCU m lies in
//                         MCU row seg * rows_per_seg + m / mcus_x, MCU column
//                         m % mcus_x. Blocks at MCU index >= side[0, s] are
//                         all zero; rows past bh_c (a short last segment)
//                         are not stored.
//   err   [S] int32       1 when a lane met a missing code, a DC size > 15
//                         or an AC index past 63; the lane then goes on
//                         decoding from where it stopped, as the TPU kernel
//                         does, so even its garbage matches
//
// The TPU kernel stored lane-major ([R * bpm, 64, S]) because its vector
// lanes cannot scatter, and a second pass permuted that into blocks. Here a
// lane stages one block in shared memory (zeroed with 16-byte stores, the
// nonzero coefficients scattered into it) and its lane group writes the 128
// bytes to their place with 16-byte stores, so the output is written once
// and read by the IDCT kernel as it lies.
//
// Bound on an H100: latency of the serial bit walk. A symbol is one
// shared-memory load (lookahead table) on a 32-bit window of the stream, the
// bit reader has its next two words in registers before they are needed,
// and a warp serves only `lpw` lanes so that a bucket's few thousand lanes
// spread over many warps.
//
// Lane groups: a warp serves `lpw` lanes (segments), G = 32 / lpw threads
// each. The group's first thread (the leader) walks the bits; all G threads
// move the lane's staged block between shared and device memory. Fewer
// lanes a warp means more warps for the same lanes (the card has 528 warp
// schedulers and a bucket a few thousand lanes) and fewer lanes waiting at
// a block's end for the warp's slowest.

#include <cstdint>
#include <cuda_runtime.h>

#include "huffman_common.cuh"

namespace {

using tic::decode_fast;
using tic::extend;
using tic::extend_nz;
using tic::HuffTab;
using tic::kMaxBpm;
using tic::kTabHeader;
using tic::McuMap;
using tic::window_bits;

// int16 a staged block: 64 coefficients and 8 of padding, so that the
// 16-byte accesses of neighbouring lanes fall on different banks
constexpr int kBlkStride = 72;

struct Geom {
  int16_t* stack[4];
  int h[4], v[4];
  int bh[4], bw[4];
  McuMap map;
  int bpm, R, mcus_x, rows_per_seg, nsegs;
  long long lanes;  // B * nsegs
};

// One block of lane `br`: DC then AC into the zeroed staged block.
// Returns true on an error.
using BitReader = tic::BitReader<false>;

__device__ __forceinline__ bool decode_block(BitReader& br, const HuffTab& dct,
                                             const HuffTab& act, int nv, int L,
                                             int* pred, int16_t* blk) {
  bool bad = false;

  // DC: on a bad code nothing is consumed and the coefficient stays 0
  uint32_t win = br.peek();
  int e = decode_fast(dct, nv, L, win);
  int len = e >> 8, sym = e & 0xff;
  if (e != 0 && sym <= 15) {
    const int diff = extend(window_bits(win, len, sym), sym);
    br.consume(len + sym);
    *pred = (int)((unsigned)*pred + (unsigned)diff);
    blk[0] = (int16_t)*pred;
  } else {
    bad = true;
  }

  // AC: run/size symbols until EOB or position 63
  int k = 1;
  for (;;) {
    win = br.peek();
    e = decode_fast(act, nv, L, win);
    if (e == 0) return true;
    len = e >> 8;
    const int run = (e >> 4) & 15, size = e & 15;
    if (size == 0) {
      br.consume(len);
      if (run != 15) break;  // EOB
      k += 16;               // ZRL
      if (k > 63) break;
      continue;
    }
    k += run;
    if (k > 63) {  // the code is used up, its value bits are not
      br.consume(len);
      return true;
    }
    blk[k] = (int16_t)extend_nz(window_bits(win, len, size), size);
    br.consume(len + size);
    if (++k > 63) break;
  }
  return bad;
}

__global__ void huffman_into_kernel(const uint32_t* __restrict__ words, int W,
                                    long long S,
                                    const int32_t* __restrict__ side,
                                    const int32_t* __restrict__ tables,
                                    int ntab, int nv,
                                    const int16_t* __restrict__ look,
                                    int nlook, int L, Geom g,
                                    int32_t* __restrict__ err, int lpw) {
  extern __shared__ uint4 s_mem[];
  const int warps = blockDim.x >> 5;
  int16_t* s_blk = reinterpret_cast<int16_t*>(s_mem);
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_blk + warps * lpw * kBlkStride);
  int16_t* s_look = reinterpret_cast<int16_t*>(s_tab + ntab);
  tic::load_tables(s_tab, tables, ntab, s_look, look, nlook);
  __syncthreads();

  const int G = 32 / lpw;  // threads a lane
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int li = t / G, sub = t - li * G;
  const long long warp0 = ((long long)blockIdx.x * warps + w) * lpw;
  const long long s = warp0 + li;
  const bool leader = sub == 0;
  if (leader && s < S && s >= g.lanes) err[s] = 0;  // padding lanes
  if (warp0 >= g.lanes) return;                     // the whole warp
  const bool real = s < g.lanes;

  int16_t* blk = s_blk + (w * lpw + li) * kBlkStride;
  uint4* blk4 = reinterpret_cast<uint4*>(blk);
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int i = sub; i < 8; i += G) blk4[i] = zero4;
  __syncwarp();

  const long long img = real ? s / g.nsegs : 0;
  const int seg = real ? (int)(s - img * g.nsegs) : 0;
  const int nmcu = real ? side[s] : 0;
  int p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  BitReader br{words + s, W, S, nullptr, 0, 0, 0, 0, 0, 0, 0};
  if (leader && nmcu > 0) {
    p0 = side[2 * S + s];
    p1 = side[3 * S + s];
    p2 = side[4 * S + s];
    p3 = side[5 * S + s];
    br.init(side[S + s]);
  }
  const int tstride = kTabHeader + nv;
  bool bad = false;
  int mrow = seg * g.rows_per_seg, mcol = 0;

  for (int mcu = 0; mcu < g.R; ++mcu) {
    for (int b = 0; b < g.bpm; ++b) {
      const int ci = g.map.comp[b];
      if (leader && mcu < nmcu) {
        const HuffTab dct{s_tab + (2 * ci) * tstride,
                          s_look + ((2 * ci) << L)};
        const HuffTab act{s_tab + (2 * ci + 1) * tstride,
                          s_look + ((2 * ci + 1) << L)};
        int pred = ci == 0 ? p0 : ci == 1 ? p1 : ci == 2 ? p2 : p3;
        bad |= decode_block(br, dct, act, nv, L, &pred, blk);
        if (ci == 0) p0 = pred;
        else if (ci == 1) p1 = pred;
        else if (ci == 2) p2 = pred;
        else p3 = pred;
      }
      __syncwarp();
      const int row = mrow * g.v[ci] + g.map.by[b];
      if (real && row < g.bh[ci]) {
        const int col = mcol * g.h[ci] + g.map.bx[b];
        uint4* dst = reinterpret_cast<uint4*>(
            g.stack[ci] + ((img * g.bh[ci] + row) * g.bw[ci] + col) * 64);
        for (int i = sub; i < 8; i += G) dst[i] = blk4[i];
      }
      for (int i = sub; i < 8; i += G) blk4[i] = zero4;
      __syncwarp();
    }
    if (++mcol == g.mcus_x) {
      mcol = 0;
      ++mrow;
    }
  }
  if (leader && real) err[s] = bad ? 1 : 0;
}

}  // namespace

// comp_hv: (h, v) per component; stacks: one pointer per component.
extern "C" int tic_huffman_decode_into(
    const void* words, int W, long long S, const void* side,
    const void* tables, int ncomp, int nv, const void* look, int L,
    const int32_t* comp_hv, int mcus_x, int mcus_y, int R, long long B,
    int nsegs, void* const* stacks, void* err, int lpw, int warps,
    void* stream) {
  if (ncomp < 1 || ncomp > 4 || nv < 1 || W < 2 || L < 1 ||
      L > tic::kMaxLook || mcus_x < 1 || mcus_y < 1 || R < 1 ||
      R % mcus_x != 0 || nsegs < 1 || B < 0 || B * nsegs > S ||
      (long long)nsegs * (R / mcus_x) < mcus_y ||
      lpw < 1 || lpw > 32 || (lpw & (lpw - 1)) != 0 || warps < 1 ||
      warps > 32)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  Geom g = {};
  int bpm = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
    if (h < 1 || h > 4 || v < 1 || v > 4 || bpm + h * v > kMaxBpm)
      return (int)cudaErrorInvalidValue;
    g.stack[c] = (int16_t*)stacks[c];
    g.h[c] = h;
    g.v[c] = v;
    g.bh[c] = mcus_y * v;
    g.bw[c] = mcus_x * h;
    for (int by = 0; by < v; ++by)
      for (int bx = 0; bx < h; ++bx, ++bpm) {
        g.map.comp[bpm] = (int8_t)c;
        g.map.by[bpm] = (int8_t)by;
        g.map.bx[bpm] = (int8_t)bx;
      }
  }
  g.bpm = bpm;
  g.R = R;
  g.mcus_x = mcus_x;
  g.rows_per_seg = R / mcus_x;
  g.nsegs = nsegs;
  g.lanes = B * nsegs;
  const int ntab = ncomp * 2 * (kTabHeader + nv);
  const int nlook = (ncomp * 2) << L;
  // staged blocks first (16-byte aligned), then the tables
  const size_t smem = (size_t)warps * lpw * kBlkStride * sizeof(int16_t) +
                      (size_t)ntab * sizeof(int32_t) +
                      (size_t)nlook * sizeof(int16_t);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        huffman_into_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long per_cta = (long long)warps * lpw;
  const unsigned grid = (unsigned)((S + per_cta - 1) / per_cta);
  huffman_into_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, W, S, (const int32_t*)side,
      (const int32_t*)tables, ntab, nv, (const int16_t*)look, nlook, L, g,
      (int32_t*)err, lpw);
  return (int)cudaGetLastError();
}
