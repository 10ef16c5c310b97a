// K3: progressive JPEG Huffman decode of one scan, one restart segment per
// lane, in place on the stream's coefficient planes.
//
// Replaces the Pallas kernel nvimagecodec_tpu/ops/pallas_entropy.py
// (_build_prog_kernel / decode_prog_scan_device) together with the gather
// of the band before it and the scatter of its output after it. Inputs:
//   words   [W, S] uint32  column s = segment s's destuffed bits, MSB first,
//                          from bit side[1, s]; bits past row W read as 0
//   side    [6, S] int32   0: units (MCUs for DC scans, blocks for AC
//                          scans) in the segment (0 = padding lane),
//                          1: start bit, 2..5: DC predictor seeds
//   tables  [ntab, 34 + nv] int32  one row per component for "dc", one row
//                          for "ac"/"acref" (see huffman_common.cuh)
//   look    [ntab, 1 << L] int16   their lookahead rows
//   plane[c] [rows_c, cols_c, 64] int16  component c's zigzag blocks, a
//                          block = 128 contiguous bytes; read and written
//                          in place
//   err     [S] int32      1 when the lane met a missing code, a DC size
//                          > 15, an AC index past se, or a refinement value
//                          with no slot left
//
// Unit j of lane s is unit g = s * R + j of the scan. DC scans ("dc",
// "dcref"): g is an MCU of the interleaved grid (mcus_x wide), and its
// block b lies at row (g / mcus_x) * v + by, column (g % mcus_x) * h + bx
// of its component's plane. AC scans ("ac", "acref"): g is a block of one
// component's true block grid (cbw wide): row g / cbw, column g % cbw.
// Units at or past `units` do not exist and nothing is stored for them.
//
// Kinds: "dc" decodes DC differences (coefficient 0 := pred << Al,
// predictors carried across the lane's blocks); "dcref" reads one raw bit
// per block (coefficient 0 |= bit << Al); "ac" decodes a band ss..se with
// EOB runs carried across blocks (positions ss..se := the decoded values);
// "acref" refines the band (T.81 G.1.2.3): correction bits on nonzero
// history, newly significant values placed after `run` zero-history
// positions, EOB runs that still read correction bits. A unit the lane does
// not decode (j >= side[0, s]) gets what the TPU kernel's output gave it:
// zeros for "dc" and "ac", nothing for the refinements. Every error path of
// the TPU kernel is kept, so even a corrupt lane's values match.
//
// The TPU kernel returned lane-major [R, 64, S] arrays, 64 positions a unit
// whatever the band, which the caller gathered from and scattered into the
// planes with a dozen small launches a scan. Here one warp serves one lane,
// and all its 32 threads run the same bit walk on the same bits (a warp
// issues an instruction once for 32 threads or for one), so nothing is
// handed from a walking thread to the others: thread t owns positions
// ss + t and ss + t + 32 of the block (or every 32nd block of a DC scan),
// keeps what the walk decodes for them in registers, and loads and stores
// only those. The lane's first 32 words are staged in shared memory.
// "acref" never steps position by position: a ballot over the loaded band
// gives the 64-bit mask of positions with nonzero history, the walk finds
// the n-th zero-history position with bit operations, and the correction
// bits of all nonzero positions passed on the way are taken from one
// window, each thread picking its own by the rank of its position. "dcref"
// has no serial dependence at all (block n's bit is bit start + n) and runs
// one block per thread.
//
// Bound on an H100: latency of the serial bit walk, and the launch. A scan
// has 50-200 lanes, one warp each, so it spreads over as many SMs as it
// has segments.

#include <cstdint>
#include <cuda_runtime.h>

#include "huffman_common.cuh"

namespace {

using BitReader = tic::BitReader<true>;
using tic::decode_fast;
using tic::extend;
using tic::extend_nz;
using tic::HuffTab;
using tic::kFullMask;
using tic::kMaxBpm;
using tic::kTabHeader;
using tic::McuMap;
using tic::window_bits;

enum Kind { kDc = 0, kDcRef = 1, kAc = 2, kAcRef = 3 };
constexpr int kNear = 32;  // words of a lane staged in shared memory

struct Geom {
  int16_t* plane[4];
  int cols[4];      // blocks a plane row
  int h[4], v[4];   // DC scans
  McuMap map;       // DC scans
  int bpm, R;
  int width;        // units a row: mcus_x (DC scans) or cbw (AC scans)
  long long units;  // units of the scan
};

__device__ __forceinline__ int shl(int v, int al) {
  return (int)((unsigned)v << al);
}

// What a thread owns of the block being decoded: positions z1 and z2
// (z2 = z1 + 32; in1 / in2 say whether they lie in the band) and the
// values decoded for them.
struct Mine {
  int z1, z2;
  bool in1, in2;
  int v1, v2;
  __device__ void set(int z, int v) {
    if (z == z1) v1 = v;
    if (z == z2) v2 = v;
  }
};

// First AC band scan, one block (its values zeroed). Returns 1 on an error.
__device__ __forceinline__ int ac_block(BitReader& br, const HuffTab& tab,
                                        int nv, int L, int ss, int se, int al,
                                        Mine& me, int* eob) {
  int k = ss;
  for (;;) {
    const uint32_t win = br.peek();
    const int e = decode_fast(tab, nv, L, win);
    if (e == 0) return 1;
    const int len = e >> 8, run = (e >> 4) & 15, size = e & 15;
    if (size == 0) {
      if (run != 15) {  // EOBn: this block and 2^run - 1 + bits more
        *eob = (1 << run) - 1 + window_bits(win, len, run);
        br.consume(len + run);
        return 0;
      }
      br.consume(len);
      k += 16;  // ZRL
    } else {
      k += run;
      if (k > se) {  // the code is used up, its value bits are not
        br.consume(len);
        return 1;
      }
      me.set(k, shl(extend_nz(window_bits(win, len, size), size), al));
      br.consume(len + size);
      ++k;
    }
    if (k > se) return 0;
  }
}

// One correction bit for each position of `m`, lowest first, read from the
// stream a half of the band (<= 32 bits) at a time. c1 / c2 become true
// where the bit of the thread's own position is 1.
__device__ __forceinline__ void corrections(BitReader& br, uint64_t m,
                                            const Mine& me, bool* c1,
                                            bool* c2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t mh = half == 0 ? (uint32_t)m : (uint32_t)(m >> 32);
    if (mh == 0) continue;
    const int c = __popc(mh);
    const uint32_t bits = br.peek() >> (32 - c);  // first position's on top
    br.consume(c);
    const int i1 = me.z1 & 31, i2 = me.z2 & 31;
    if (me.in1 && (me.z1 >> 5) == half && ((mh >> i1) & 1) &&
        ((bits >> (c - 1 - __popc(mh & ((1u << i1) - 1)))) & 1))
      *c1 = true;
    if (me.in2 && (me.z2 >> 5) == half && ((mh >> i2) & 1) &&
        ((bits >> (c - 1 - __popc(mh & ((1u << i2) - 1)))) & 1))
      *c2 = true;
  }
}

// AC refinement scan, one block. `nz` has bit z set where position z of the
// band has nonzero history. A symbol asks for n zero-history positions to be
// passed (run + 1, the last of which takes the new value, or 16 for ZRL);
// every nonzero position passed on the way reads a correction bit. Newly
// significant values go to their owner (`me`, zeroed), correction bits that
// are 1 to c1 / c2. Returns 1 on an error.
__device__ __forceinline__ int acref_block(BitReader& br, const HuffTab& tab,
                                           int nv, int L, int ss, int se,
                                           int al, uint64_t nz, Mine& me,
                                           int* eob, bool* c1, bool* c2) {
  const int p1 = 1 << al;
  const uint64_t upto = ~0ull >> (63 - se);  // positions 0..se
  int k = ss;
  if (*eob == 0) {
    for (;;) {  // k <= se, no run left, no value pending
      const uint32_t win = br.peek();
      const int e = decode_fast(tab, nv, L, win);
      if (e == 0) return 1;
      const int len = e >> 8, run = (e >> 4) & 15, size = e & 15;
      int n = 16, sval = 0;  // ZRL
      if (size != 0) {
        sval = window_bits(win, len, 1) ? p1 : -p1;
        br.consume(len + 1);
        n = run + 1;
      } else if (run != 15) {  // EOBn, counting this block
        *eob = (1 << run) + window_bits(win, len, run);
        br.consume(len + run);
        break;
      } else {
        br.consume(len);
      }
      const uint64_t from = (~0ull << k) & upto;  // positions k..se
      uint64_t zeros = ~nz & from;
      if (__popcll(zeros) < n) {
        // the band ends first; a value with no zero-history slot left is
        // an error
        corrections(br, nz & from, me, c1, c2);
        return size != 0;
      }
      for (int i = 1; i < n; ++i) zeros &= zeros - 1;
      const int t = __ffsll((long long)zeros) - 1;  // the n-th such position
      corrections(br, nz & from & ((1ull << t) - 1), me, c1, c2);
      if (size != 0) me.set(t, sval);
      k = t + 1;
      if (k > se) return 0;
    }
  }
  // inside an EOB run: correction bits only
  corrections(br, nz & (~0ull << k) & upto, me, c1, c2);
  --*eob;
  return 0;
}

// Where block b of MCU u of a DC scan keeps its coefficient 0.
__device__ __forceinline__ int16_t* dc_slot(const Geom& g, long long u,
                                            int b) {
  const int ci = g.map.comp[b];
  const long long row = (u / g.width) * g.v[ci] + g.map.by[b];
  const long long col = (u % g.width) * g.h[ci] + g.map.bx[b];
  return g.plane[ci] + (row * g.cols[ci] + col) * 64;
}

__global__ void prog_into_kernel(int kind, const uint32_t* __restrict__ words,
                                 int W, long long S,
                                 const int32_t* __restrict__ side,
                                 const int32_t* __restrict__ tables, int ntab,
                                 int nv, const int16_t* __restrict__ look,
                                 int nlook, int L, Geom g, int ss, int se,
                                 int al, int32_t* __restrict__ err) {
  extern __shared__ uint4 s_mem[];
  const int warps = blockDim.x >> 5;
  uint32_t* s_near = reinterpret_cast<uint32_t*>(s_mem);
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_near + warps * kNear);
  int16_t* s_look = reinterpret_cast<int16_t*>(s_tab + ntab);
  tic::load_tables(s_tab, tables, ntab, s_look, look, nlook);
  __syncthreads();

  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * warps + w;  // the warp's lane
  if (s >= S) return;
  const int nunits = side[s];
  // units of this lane that exist in the scan
  const long long left = g.units - s * g.R;
  const int nexist = left <= 0 ? 0 : left < g.R ? (int)left : g.R;
  if (nexist == 0 && nunits == 0) {
    if (t == 0) err[s] = 0;
    return;
  }
  const long long g0 = s * g.R;
  const int tstride = kTabHeader + nv;
  const int start = nunits > 0 ? side[S + s] : 0;
  int errs = 0;

  if (kind == kDcRef) {
    // bit start + n is block n's, whatever the other blocks hold
    const uint32_t* col = words + s;
    const int nblk = (nunits < nexist ? nunits : nexist) * g.bpm;
    for (int n = t; n < nblk; n += 32) {
      const int pos = start + n, wi = pos >> 5;
      const uint32_t word = wi < W ? __ldg(col + (long long)wi * S) : 0u;
      if ((word >> (31 - (pos & 31))) & 1) {
        int16_t* at = dc_slot(g, g0 + n / g.bpm, n % g.bpm);
        *at = (int16_t)(*at | shl(1, al));
      }
    }
    if (t == 0) err[s] = 0;
    return;
  }

  // the lane's first words, one load a thread, before the serial walk that
  // every thread of the warp then runs alike
  uint32_t* near = s_near + w * kNear;
  near[t] = t < W ? __ldg(words + s + (long long)t * S) : 0u;
  __syncwarp();
  BitReader br{words + s, W, S, near, kNear, 0, 0, 0, 0, 0, 0};
  if (nunits > 0) br.init(start);
  const int ndec = nunits < g.R ? nunits : g.R;
  // a unit that does not exist is still decoded (as the TPU kernel did), on
  // values of zero, so that the lane's flags agree
  const int nloop = ndec > nexist ? ndec : nexist;

  if (kind == kDc) {
    int p0 = 0, p1 = 0, p2 = 0, p3 = 0;
    if (nunits > 0) {
      p0 = side[2 * S + s];
      p1 = side[3 * S + s];
      p2 = side[4 * S + s];
      p3 = side[5 * S + s];
    }
    // thread t keeps every 32nd block's value and stores it when the warp
    // has decoded 32 blocks (or the last)
    const int nblk = nloop * g.bpm;
    int n = 0, mine = 0;
    for (int j = 0; j < nloop; ++j) {
      for (int b = 0; b < g.bpm; ++b, ++n) {
        int v = 0;
        if (j < ndec) {
          // a bad code consumes nothing and leaves the value 0
          const int ci = g.map.comp[b];
          const HuffTab tab{s_tab + ci * tstride, s_look + (ci << L)};
          const uint32_t win = br.peek();
          const int e = decode_fast(tab, nv, L, win);
          const int len = e >> 8, sz = e & 0xff;
          if (e != 0 && sz <= 15) {
            const int diff = extend(window_bits(win, len, sz), sz);
            br.consume(len + sz);
            int pred = ci == 0 ? p0 : ci == 1 ? p1 : ci == 2 ? p2 : p3;
            pred = (int)((unsigned)pred + (unsigned)diff);
            if (ci == 0) p0 = pred;
            else if (ci == 1) p1 = pred;
            else if (ci == 2) p2 = pred;
            else p3 = pred;
            v = shl(pred, al);
          } else {
            ++errs;
          }
        }
        if ((n & 31) == t) mine = v;
        if ((n & 31) == 31 || n == nblk - 1) {
          const int my_n = (n & ~31) + t;  // the block whose value I hold
          const int my_j = my_n / g.bpm;
          if (my_n <= n && my_j < nexist)
            *dc_slot(g, g0 + my_j, my_n - my_j * g.bpm) = (int16_t)mine;
        }
      }
    }
    if (t == 0) err[s] = errs > 0 ? 1 : 0;
    return;
  }

  // "ac" / "acref": thread t owns positions ss + t and ss + t + 32
  const HuffTab tab{s_tab, s_look};
  Mine me{ss + t, ss + t + 32, ss + t <= se, ss + t + 32 <= se, 0, 0};
  const int p1 = 1 << al;
  long long brow = g0 / g.width;
  int bcol = (int)(g0 - brow * g.width);
  int eob = 0;
  // the history of my positions ("acref"), loaded one block ahead of the
  // walk that needs it
  const int nhist = kind == kAcRef ? (ndec < nexist ? ndec : nexist) : 0;
  int16_t* next = g.plane[0] + (brow * g.cols[0] + bcol) * 64;
  int h1n = 0, h2n = 0;
  if (0 < nhist) {
    if (me.in1) h1n = next[me.z1];
    if (me.in2) h2n = next[me.z2];
  }
  for (int j = 0; j < nloop; ++j) {
    const bool exists = j < nexist, dec = j < ndec;
    int16_t* at = next;
    if (++bcol == g.width) {
      bcol = 0;
      ++brow;
    }
    next = g.plane[0] + (brow * g.cols[0] + bcol) * 64;
    const int h1 = h1n, h2 = h2n;
    h1n = h2n = 0;
    if (j + 1 < nhist) {
      if (me.in1) h1n = next[me.z1];
      if (me.in2) h2n = next[me.z2];
    }
    me.v1 = me.v2 = 0;
    if (kind == kAcRef) {
      const uint32_t m1 = __ballot_sync(kFullMask, h1 != 0);
      const uint32_t m2 = __ballot_sync(kFullMask, h2 != 0);
      if (dec) {
        uint64_t nz = (uint64_t)m1 << ss;
        if (m2 != 0) nz |= (uint64_t)m2 << (ss + 32);
        bool c1 = false, c2 = false;
        errs += acref_block(br, tab, nv, L, ss, se, al, nz, me, &eob, &c1,
                            &c2);
        if (exists) {
          // a nonzero history takes its correction, a zero one its new value
          if (h1 != 0 && c1 && (h1 & p1) == 0)
            at[me.z1] = (int16_t)(h1 + (h1 >= 0 ? p1 : -p1));
          else if (h1 == 0 && me.v1 != 0)
            at[me.z1] = (int16_t)me.v1;
          if (h2 != 0 && c2 && (h2 & p1) == 0)
            at[me.z2] = (int16_t)(h2 + (h2 >= 0 ? p1 : -p1));
          else if (h2 == 0 && me.v2 != 0)
            at[me.z2] = (int16_t)me.v2;
        }
      }
    } else {
      if (dec) {
        if (eob > 0) --eob;  // inside an EOB run: the block stays zero
        else errs += ac_block(br, tab, nv, L, ss, se, al, me, &eob);
      }
      if (exists) {
        if (me.in1) at[me.z1] = (int16_t)me.v1;
        if (me.in2) at[me.z2] = (int16_t)me.v2;
      }
    }
  }
  if (t == 0) err[s] = errs > 0 ? 1 : 0;
}

}  // namespace

// kind 0..3 = dc, dcref, ac, acref. DC scans: `planes` holds one pointer
// per component, comp_hv its (h, v) pairs, width = mcus_x. AC scans:
// ncomp = 1, `planes` holds the scan's component, width = cbw. cols[c] =
// blocks in a row of plane c.
extern "C" int tic_prog_huffman_decode_into(
    int kind, const void* words, int W, long long S, const void* side,
    const void* tables, int ntab_rows, int nv, const void* look, int L,
    int ncomp, const int32_t* comp_hv, const int32_t* cols,
    void* const* planes, int width, long long units, int R, int ss, int se,
    int al, void* err, int warps, void* stream) {
  const bool dc = kind == kDc || kind == kDcRef;
  if (kind < kDc || kind > kAcRef || ntab_rows < 1 || ntab_rows > 4 ||
      nv < 1 || W < 2 || L < 1 || L > tic::kMaxLook || R < 1 || al < 0 ||
      al > 15 || ss < 0 || ss > se || se > 63 || dc != (ss == 0) ||
      width < 1 || units < 0 || ncomp < 1 || ncomp > 4 ||
      (!dc && ncomp != 1) || (kind == kDc && ntab_rows < ncomp) ||
      warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  Geom g = {};
  int bpm = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int h = dc ? comp_hv[2 * c] : 1, v = dc ? comp_hv[2 * c + 1] : 1;
    if (h < 1 || h > 4 || v < 1 || v > 4 || bpm + h * v > kMaxBpm)
      return (int)cudaErrorInvalidValue;
    g.plane[c] = (int16_t*)planes[c];
    g.cols[c] = cols[c];
    g.h[c] = h;
    g.v[c] = v;
    for (int by = 0; by < v; ++by)
      for (int bx = 0; bx < h; ++bx, ++bpm) {
        g.map.comp[bpm] = (int8_t)c;
        g.map.by[bpm] = (int8_t)by;
        g.map.bx[bpm] = (int8_t)bx;
      }
  }
  g.bpm = bpm;
  g.R = R;
  g.width = width;
  g.units = units;
  const int ntab = ntab_rows * (kTabHeader + nv);
  const int nlook = ntab_rows << L;
  // a warp's staged words, then the tables
  const size_t smem = (size_t)warps * kNear * sizeof(uint32_t) +
                      (size_t)ntab * sizeof(int32_t) +
                      (size_t)nlook * sizeof(int16_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((S + warps - 1) / warps);
  prog_into_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      kind, (const uint32_t*)words, W, S, (const int32_t*)side,
      (const int32_t*)tables, ntab, nv, (const int16_t*)look, nlook, L, g,
      ss, se, al, (int32_t*)err);
  return (int)cudaGetLastError();
}
