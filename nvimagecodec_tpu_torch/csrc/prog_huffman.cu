// K3: progressive JPEG Huffman decode of one scan, one thread per restart
// segment.
//
// Replaces the Pallas kernel nvimagecodec_tpu/ops/pallas_entropy.py
// (_build_prog_kernel / decode_prog_scan_device) and keeps its contract bit
// for bit:
//   words   [W, S] uint32  column s = segment s's destuffed bits, MSB first,
//                          from bit side[1, s]; bits past row W read as 0
//   side    [6, S] int32   0: units (MCUs for DC scans, blocks for AC
//                          scans) in the segment (0 = padding lane),
//                          1: start bit, 2..5: DC predictor seeds
//   tables  [ntab, 34 + nv] int32  one row per component for "dc", one row
//                          for "ac"/"acref" (see huffman_common.cuh)
//   band_in [R, 64, S] int16  "acref" only: the band's current zigzag
//                          coefficients
//   out     [NBLK, OUTK, S] int16  "dc"/"dcref": NBLK = R * bpm, OUTK = 1;
//                          "ac"/"acref": NBLK = R, OUTK = 64
//   err     [S] int32      1 when the lane met a missing code, a DC size
//                          > 15, an AC index past se, or a refinement value
//                          with no slot left
//
// Kinds: "dc" decodes DC differences (value pred << Al, predictors carried
// across the lane's blocks); "dcref" reads one raw bit per block (bit << Al,
// for the caller to OR in); "ac" decodes a band ss..se with EOB runs carried
// across blocks; "acref" refines the band (T.81 G.1.2.3): correction bits on
// nonzero history, newly significant values placed after `run` zero-history
// positions, EOB runs that still read correction bits. Each unit starts
// from zeroed coefficients, except "acref", which starts from band_in (for
// every lane, so padding lanes return band_in as it was). Every error path
// of the TPU kernel is kept, so even a corrupt lane's output matches.
//
// The TPU kernel stepped all lanes in lockstep, one symbol or one position
// per iteration, behind a word conveyor. Here each thread walks its own
// segment: it reads its column of `words` straight from global memory
// (neighbouring lanes read neighbouring addresses) and keeps its bit
// position, DC predictors, EOB run and error count in registers across its
// NBLK units. Tables are runtime inputs in shared memory, so one build
// serves every scan.
//
// Bound on an H100: latency. A scan has few lanes (S = 128-256 at 375x500,
// one or two CTAs), so the kernel is as long as its longest serial lane
// plus the launch.

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

constexpr int kThreads = 128;
enum Kind { kDc = 0, kDcRef = 1, kAc = 2, kAcRef = 3 };

__device__ __forceinline__ int shl(int v, int al) {
  return (int)((unsigned)v << al);
}

// First AC band scan, one block. Returns 1 on an error.
__device__ int ac_block(BitReader& br, const int32_t* tab, int nv, int ss,
                        int se, int al, int* regs, int* eob) {
  int k = ss;
  for (;;) {
    br.refill();
    int len = 0, sym = 0;
    if (!decode_symbol(tab, nv, br.peek16(), &len, &sym)) return 1;
    br.skip(len);
    const int run = sym >> 4, size = sym & 15;
    if (size == 0) {
      if (run != 15) {  // EOBn: this block and 2^run - 1 + bits more
        *eob = (1 << run) - 1 + br.get(run);
        return 0;
      }
      k += 16;  // ZRL
    } else {
      const int kk = k + run;
      if (kk > se) return 1;
      regs[kk < 63 ? kk : 63] = shl(extend(br.get(size), size), al);
      k = kk + 1;
    }
    if (k > se) return 0;
  }
}

// AC refinement scan, one block. Each iteration either decodes one symbol
// (no run left and no value pending) or steps one position. Returns 1 on
// an error.
__device__ int acref_block(BitReader& br, const int32_t* tab, int nv, int ss,
                           int se, int al, int* regs, int* eob) {
  const int p1 = 1 << al;
  bool ineob = *eob > 0;
  int k = ss, rrem = 0, sval = 0, errs = 0;
  for (;;) {
    br.refill();
    if (!ineob && rrem == 0 && sval == 0) {
      int len = 0, sym = 0;
      if (!decode_symbol(tab, nv, br.peek16(), &len, &sym)) {
        errs = 1;
        break;
      }
      br.skip(len);
      const int run = sym >> 4, size = sym & 15;
      if (size != 0) {
        sval = br.get(1) ? p1 : -p1;
        rrem = run;
      } else if (run != 15) {  // EOBn, counting this block
        *eob = (1 << run) + br.get(run);
        ineob = true;
      } else {
        rrem = 16;  // ZRL
      }
    } else if (k <= se) {
      const int kw = k < 63 ? k : 63;
      int c = regs[kw];
      if (c != 0) {
        if (br.get(1) && (c & p1) == 0) c += c >= 0 ? p1 : -p1;
      } else if (!ineob) {
        if (rrem > 0) {
          --rrem;
        } else if (sval != 0) {
          c = sval;
          sval = 0;
        }
      }
      regs[kw] = c;
      ++k;
      if (k > se && sval != 0) {  // no zero-history slot left for it
        errs = 1;
        sval = 0;
      }
    }
    if (k > se) break;
  }
  if (ineob) --*eob;
  return errs;
}

__device__ void decode_lane(int kind, const uint32_t* words, int W,
                            long long S, const int32_t* side,
                            const int32_t* tabs, int nv, const CompMap& cmap,
                            int bpm, int R, int ss, int se, int al,
                            const int16_t* band_in, int16_t* out,
                            int32_t* err, long long s) {
  const int nunits = side[s];
  int pred[4] = {side[2 * S + s], side[3 * S + s], side[4 * S + s],
                 side[5 * S + s]};
  const int tstride = kTabHeader + nv;
  BitReader br{words + s, W, S, 0, 0, 0};
  br.init(side[S + s]);
  int eob = 0, errs = 0;

  if (kind == kDc || kind == kDcRef) {
    for (int j = 0; j < R * bpm; ++j) {
      int v = 0;
      if (j / bpm < nunits) {
        br.refill();
        if (kind == kDcRef) {
          v = shl(br.get(1), al);
        } else {
          // a bad code consumes nothing and leaves the value 0
          const int ci = cmap.c[j % bpm];
          int len = 0, t = 0;
          if (decode_symbol(tabs + ci * tstride, nv, br.peek16(), &len, &t) &&
              t <= 15) {
            br.skip(len);
            const int diff = extend(br.get(t), t);
            pred[ci] = (int)((unsigned)pred[ci] + (unsigned)diff);
            v = shl(pred[ci], al);
          } else {
            ++errs;
          }
        }
      }
      out[(long long)j * S + s] = (int16_t)v;
    }
  } else {
    int regs[64];
    for (int j = 0; j < R; ++j) {
      if (kind == kAc) {
        for (int z = 0; z < 64; ++z) regs[z] = 0;
      } else {
        const int16_t* ib = band_in + (long long)j * 64 * S + s;
        for (int z = 0; z < 64; ++z) regs[z] = ib[z * S];
      }
      if (j < nunits) {
        if (kind == kAcRef) {
          errs += acref_block(br, tabs, nv, ss, se, al, regs, &eob);
        } else if (eob > 0) {
          --eob;  // inside an EOB run: the block stays zero
        } else {
          errs += ac_block(br, tabs, nv, ss, se, al, regs, &eob);
        }
      }
      int16_t* ob = out + (long long)j * 64 * S + s;
      for (int z = 0; z < 64; ++z) ob[z * S] = (int16_t)regs[z];
    }
  }
  err[s] = errs > 0 ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
prog_huffman_kernel(int kind, const uint32_t* __restrict__ words, int W,
                    long long S, const int32_t* __restrict__ side,
                    const int32_t* __restrict__ tables, int ntab, int nv,
                    CompMap cmap, int bpm, int R, int ss, int se, int al,
                    const int16_t* __restrict__ band_in,
                    int16_t* __restrict__ out, int32_t* __restrict__ err) {
  extern __shared__ int32_t s_tab[];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = tables[i];
  __syncthreads();
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  decode_lane(kind, words, W, S, side, s_tab, nv, cmap, bpm, R, ss, se, al,
              band_in, out, err, s);
}

}  // namespace

extern "C" int tic_prog_huffman_decode(int kind, const void* words, int W,
                                       long long S, const void* side,
                                       const void* tables, int ntab_rows,
                                       int nv, const int32_t* comp_map,
                                       int bpm, int R, int ss, int se, int al,
                                       const void* band_in, void* out,
                                       void* err, void* stream) {
  if (kind < kDc || kind > kAcRef || bpm < 1 || bpm > kMaxBpm ||
      ntab_rows < 1 || ntab_rows > 4 || nv < 1 || W < 2 || R < 1 ||
      al < 0 || al > 15 || (kind == kAcRef) != (band_in != nullptr))
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  CompMap cmap = {};
  for (int b = 0; b < bpm; ++b) {
    // "dc" indexes its tables and predictors by component
    if (kind == kDc && (comp_map[b] < 0 || comp_map[b] >= ntab_rows))
      return (int)cudaErrorInvalidValue;
    cmap.c[b] = (int8_t)comp_map[b];
  }
  const int ntab = ntab_rows * (kTabHeader + nv);
  const size_t smem = (size_t)ntab * sizeof(int32_t);
  const unsigned grid = (unsigned)((S + kThreads - 1) / kThreads);
  prog_huffman_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      kind, (const uint32_t*)words, W, S, (const int32_t*)side,
      (const int32_t*)tables, ntab, nv, cmap, bpm, R, ss, se, al,
      (const int16_t*)band_in, (int16_t*)out, (int32_t*)err);
  return (int)cudaGetLastError();
}
