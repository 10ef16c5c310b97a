// Batched J2K/HTJ2K code-block decode: one call decodes every code-block
// of a tile, fanned over internal worker threads with an atomic
// work-stealing index.
//
// Rationale: a 1024x1024 5-level image has ~780 code-blocks; driving each
// through its own ctypes call + Python thread-pool future costs far more
// than the block decode itself.
// The reference hands whole tiles to nvjpeg2k which does exactly this
// kind of internal batching on GPU (extensions/nvjpeg2k/
// cuda_decoder.cpp:601-640); this is the host-side analog.

#include <atomic>
#include <cstring>
#include <cstdint>
#include <ctime>
#include <thread>
#include <vector>

namespace {

// Runs `worker` on the calling thread and on nthreads - 1 threads of its
// own (at most n - 1: one a job). Where cpu_ns is given, adds those
// threads' CPU time (CLOCK_THREAD_CPUTIME_ID, read once as each ends) to
// *cpu_ns; the calling thread's share is its caller's to count. The
// decode entries take cpu_ns from a caller that is collecting spans, and
// null otherwise.
template <class F>
void fan_out(int32_t n, int32_t nthreads, F& worker,
             int64_t* cpu_ns = nullptr) {
    int nt = nthreads < 1 ? 1 : (nthreads > n ? n : nthreads);
    if (nt <= 1) {
        worker();
        return;
    }
    std::atomic<int64_t> spent(0);
    std::vector<std::thread> ts;
    ts.reserve(nt - 1);
    for (int t = 0; t < nt - 1; t++)
        ts.emplace_back([&]() {
            worker();
            if (cpu_ns) {
                timespec ts_cpu;
                clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts_cpu);
                spent.fetch_add(int64_t(ts_cpu.tv_sec) * 1000000000 +
                                    ts_cpu.tv_nsec,
                                std::memory_order_relaxed);
            }
        });
    worker();
    for (auto& t : ts) t.join();
    if (cpu_ns) *cpu_ns += spent.load();
}

}  // namespace

extern "C" {

int tic_j2k_t1_decode_strided_style(const uint8_t* data, int len, int w,
                                    int h, int64_t stride, int band,
                                    int num_bps, int num_passes,
                                    int32_t* out, int style);

// Direct-to-band batch decode: each block is written straight into its
// subband array at (dests[i], strides[i]) — no intermediate coefficient
// blob and no per-block Python consume loop. meta, a block's int32 row:
//   T1: 7 [seg_off, seg_len, w, h, band | style << 8, num_bps, num_passes]
//   HT: 9 [cup_off, cup_len, ref_off, ref_len, num_passes, w, h, B, Ucap]
// rcs: per-block return codes. cpu_ns (nullable): the CPU time of the
// workers this call starts is added to it (fan_out). Returns the first
// nonzero rc (0 if all blocks decoded).
int tic_t1_decode_batch_into(int32_t n, const uint8_t* blob,
                             const int32_t* meta, int32_t* const* dests,
                             const int64_t* strides, int32_t* rcs,
                             int32_t nthreads, int64_t* cpu_ns) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int32_t* m = meta + 7 * i;
            // m[4]: band type byte 0, code-block style bits 8+
            int rc = tic_j2k_t1_decode_strided_style(
                blob + m[0], m[1], m[2], m[3], strides[i], m[4] & 0xFF,
                m[5], m[6], dests[i], m[4] >> 8);
            rcs[i] = rc;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker, cpu_ns);
    return bad.load();
}

int tic_ht_decode_block_strided(const uint8_t* cup, int32_t lcup,
                                const uint8_t* ref, int32_t lref,
                                int32_t num_passes, int32_t w, int32_t h,
                                int32_t B, int32_t Ucap, int32_t* out,
                                int64_t stride);

int tic_ht_decode_batch_into(int32_t n, const uint8_t* blob,
                             const int32_t* meta, int32_t* const* dests,
                             const int64_t* strides, int32_t* rcs,
                             int32_t nthreads, int64_t* cpu_ns) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int32_t* m = meta + 9 * i;
            const uint8_t* ref = m[3] ? blob + m[2] : nullptr;
            int rc = tic_ht_decode_block_strided(blob + m[0], m[1], ref,
                                                 m[3], m[4], m[5], m[6],
                                                 m[7], m[8], dests[i],
                                                 strides[i]);
            rcs[i] = rc;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker, cpu_ns);
    return bad.load();
}

int tic_j2k_t1_encode(const int32_t* coefs, int w, int h, int band,
                      uint8_t* out, int cap, int* outlen, int* nbps,
                      int* npasses, int min_bps, int style);

int tic_j2k_t1_encode_seg(const int32_t* coefs, int w, int h, int band,
                          uint8_t* out, int cap, int* outlen, int* nbps,
                          int* npasses, int min_bps, int style,
                          int* seg_ends, int* nsegs_out);

int tic_ht_encode_block(const int32_t* coefs, int32_t w, int32_t h,
                        int32_t num_passes, uint8_t* out, int32_t cap,
                        int32_t* lcup, int32_t* lref, int32_t* B,
                        int32_t* umax);

// Batched EBCOT T1 encode. meta: 4 int64 per block —
//   [coef_off (int32 elements), w, h, band]
// outs: per-block regions [out_off (int64), out_cap (int64)] into `out`.
// res: 3 int32 per block — [outlen, nbps, npasses].
// Segment-aware variant for TERMALL/BYPASS (style bits 0x05): segres is
// 113 int32 per block — [nsegs, seg_end_0, ..., seg_end_{nsegs-1}, ...]
// where seg_end_i is the cumulative byte offset ending segment i.
int tic_t1_encode_batch_seg(int32_t n, const int32_t* coefs,
                            const int64_t* meta, uint8_t* out,
                            const int64_t* outs, int32_t* res,
                            int32_t* segres, int32_t nthreads) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int64_t* m = meta + 4 * i;
            int outlen = 0, nbps = 0, npasses = 0, nsegs = 0;
            int rc = tic_j2k_t1_encode_seg(
                coefs + m[0], (int)m[1], (int)m[2], (int)(m[3] & 0xFF),
                out + outs[2 * i], (int)outs[2 * i + 1], &outlen, &nbps,
                &npasses, (int)((m[3] >> 8) & 0xFF), (int)(m[3] >> 16),
                segres ? segres + 113 * i + 1 : nullptr,
                segres ? segres + 113 * i : &nsegs);
            res[3 * i] = rc ? -1 : outlen;
            res[3 * i + 1] = nbps;
            res[3 * i + 2] = npasses;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker);
    return bad.load();
}

int tic_t1_encode_batch(int32_t n, const int32_t* coefs,
                        const int64_t* meta, uint8_t* out,
                        const int64_t* outs, int32_t* res,
                        int32_t nthreads) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int64_t* m = meta + 4 * i;
            int outlen = 0, nbps = 0, npasses = 0;
            // m[3]: band type byte 0, forced min bitplanes byte 1,
            // code-block style byte 2
            int rc = tic_j2k_t1_encode(coefs + m[0], (int)m[1], (int)m[2],
                                       (int)(m[3] & 0xFF),
                                       out + outs[2 * i],
                                       (int)outs[2 * i + 1], &outlen, &nbps,
                                       &npasses, (int)((m[3] >> 8) & 0xFF),
                                       (int)(m[3] >> 16));
            res[3 * i] = rc ? -1 : outlen;
            res[3 * i + 1] = nbps;
            res[3 * i + 2] = npasses;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker);
    return bad.load();
}

// Batched HT (T.814) encode. meta: 4 int64 per block —
//   [coef_off, w, h, num_passes]
// res: 4 int32 per block — [lcup, lref, B, umax]; lcup = -1 on error.
int tic_ht_encode_batch(int32_t n, const int32_t* coefs,
                        const int64_t* meta, uint8_t* out,
                        const int64_t* outs, int32_t* res,
                        int32_t nthreads) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int64_t* m = meta + 4 * i;
            int32_t lcup = 0, lref = 0, B = 0, umax = 0;
            int rc = tic_ht_encode_block(coefs + m[0], (int32_t)m[1],
                                         (int32_t)m[2], (int32_t)m[3],
                                         out + outs[2 * i],
                                         (int32_t)outs[2 * i + 1], &lcup,
                                         &lref, &B, &umax);
            res[4 * i] = rc ? -1 : lcup;
            res[4 * i + 1] = lref;
            res[4 * i + 2] = B;
            res[4 * i + 3] = umax;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker);
    return bad.load();
}

// Address-based batch encode: blocks are read DIRECTLY from the band
// arrays (srcs[i] + per-row sstrides[i]) into a thread-local contiguous
// scratch at memcpy speed — no Python-side slicing/copy/concatenate per
// block. meta: 4 int64 per block:
//   T1: [w, h, band|min_bps<<8|style<<16, unused]
//   HT: [w, h, num_passes, unused]
int tic_t1_encode_batch_addr(int32_t n, const int32_t* const* srcs,
                             const int64_t* sstrides, const int64_t* meta,
                             uint8_t* out, const int64_t* outs,
                             int32_t* res, int32_t* segres,
                             int32_t nthreads) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        static thread_local std::vector<int32_t> buf;
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int64_t* m = meta + 4 * i;
            int w = (int)m[0], h = (int)m[1];
            buf.resize((size_t)w * h);
            const int32_t* src = srcs[i];
            const int64_t st = sstrides[i];
            for (int y = 0; y < h; y++)
                std::memcpy(buf.data() + (size_t)y * w, src + (int64_t)y * st,
                            sizeof(int32_t) * w);
            int outlen = 0, nbps = 0, npasses = 0, nsegs = 0;
            int rc = tic_j2k_t1_encode_seg(
                buf.data(), w, h, (int)(m[2] & 0xFF), out + outs[2 * i],
                (int)outs[2 * i + 1], &outlen, &nbps, &npasses,
                (int)((m[2] >> 8) & 0xFF), (int)(m[2] >> 16),
                segres ? segres + 113 * i + 1 : nullptr,
                segres ? segres + 113 * i : &nsegs);
            res[3 * i] = rc ? -1 : outlen;
            res[3 * i + 1] = nbps;
            res[3 * i + 2] = npasses;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker);
    return bad.load();
}

int tic_ht_encode_batch_addr(int32_t n, const int32_t* const* srcs,
                             const int64_t* sstrides, const int64_t* meta,
                             uint8_t* out, const int64_t* outs,
                             int32_t* res, int32_t nthreads) {
    std::atomic<int32_t> next(0);
    std::atomic<int32_t> bad(0);
    auto worker = [&]() {
        static thread_local std::vector<int32_t> buf;
        for (;;) {
            int32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n) break;
            const int64_t* m = meta + 4 * i;
            int w = (int)m[0], h = (int)m[1];
            buf.resize((size_t)w * h);
            const int32_t* src = srcs[i];
            const int64_t st = sstrides[i];
            for (int y = 0; y < h; y++)
                std::memcpy(buf.data() + (size_t)y * w, src + (int64_t)y * st,
                            sizeof(int32_t) * w);
            int32_t lcup = 0, lref = 0, B = 0, umax = 0;
            int rc = tic_ht_encode_block(buf.data(), w, h, (int32_t)m[2],
                                         out + outs[2 * i],
                                         (int32_t)outs[2 * i + 1], &lcup,
                                         &lref, &B, &umax);
            res[4 * i] = rc ? -1 : lcup;
            res[4 * i + 1] = lref;
            res[4 * i + 2] = B;
            res[4 * i + 3] = umax;
            if (rc) bad.store(rc, std::memory_order_relaxed);
        }
    };
    fan_out(n, nthreads, worker);
    return bad.load();
}

}  // extern "C"
