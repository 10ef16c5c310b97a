// JPEG marker walk — the native half of the port's header parse
// (codecs/jpeg/headers.py builds the frames from what this writes).
//
// One call walks a batch of streams, one after another on the calling
// thread; ctypes releases the interpreter lock for it. Per stream it finds
// every marker segment and every scan's end, and writes a compact int64
// record of what the frame needs. The segments of tables (DQT, DHT) are
// given as byte ranges; the Python side reads them.
//
// The walk makes the decisions of the JAX package's Python walk
// (nvimagecodec_tpu/codecs/jpeg/headers.py), which the tests hold it to:
// SOI, then 0xFF fill bytes skipped, RSTn skipped, EOI stops the walk; a
// segment cut off by the stream's end is read as far as it goes; a scan's
// entropy data ends at the first 0xFF not followed by 0x00, 0xFF or D0-D7,
// or at the stream's end, and the walk resumes there. A stream fails where
// the Python walk raises.

#include <cstdint>
#include <cstring>

namespace {

// record items, each [kind, ...]
enum : int32_t {
  kSof = 1,    // marker, precision, height, width, ncomp, (id, h, v, tq) each
  kDqt = 2,    // segment start, segment end (byte offsets)
  kDht = 3,    // segment start, segment end
  kDri = 4,    // restart interval
  kAdobe = 5,  // APP14 "Adobe" transform byte
  kSos = 6,    // ns, (component index, td, ta) each, ss, se, ah, al,
               // data_start, data_end
};

// stream status (Python raises a ValueError for each non-zero code)
enum : int32_t {
  kOk = 0,
  kNotJpeg = 1,
  kSosBeforeSof = 2,
  kNoFrame = 3,
  kBadSof = 4,       // SOF segment shorter than its components
  kBadDqt = 5,       // a table runs past its segment
  kBadDri = 6,       // DRI segment shorter than 2 bytes
  kBadSos = 7,       // SOS segment shorter than its fields
  kSosComponent = 8, // SOS names a component the frame lacks
  kCapacity = -2,    // the record did not fit: used[i] holds its length
};

struct Record {
  int64_t* out;
  int64_t cap;
  int64_t n = 0;
  inline void put(int64_t v) {
    if (n < cap) out[n] = v;
    n++;
  }
};

inline bool is_sof(uint8_t m) {
  return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// End of the entropy data that starts at `from`: the first q in
// [from, n - 2] with d[q] == 0xFF and d[q + 1] neither 0x00, 0xFF nor RSTn;
// n when there is none.
int64_t scan_end(const uint8_t* d, int64_t n, int64_t from) {
  int64_t q = from;
  while (q < n - 1) {
    const void* hit = memchr(d + q, 0xFF, (size_t)(n - 1 - q));
    if (!hit) break;
    q = (const uint8_t*)hit - d;
    uint8_t m = d[q + 1];
    if (m != 0x00 && m != 0xFF && !(m >= 0xD0 && m <= 0xD7)) return q;
    q++;
  }
  return n;
}

int32_t walk(const uint8_t* d, int64_t n, Record& r) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
  int64_t pos = 2;
  bool have_frame = false;
  int ncomp = 0;
  uint8_t ids[256];
  while (pos + 2 <= n) {
    if (d[pos] != 0xFF) {
      const void* hit = memchr(d + pos, 0xFF, (size_t)(n - pos));
      pos = hit ? (const uint8_t*)hit - d : n;
      continue;
    }
    uint8_t m = d[pos + 1];
    if (m == 0xFF) {
      pos++;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (m == 0xD9) break;  // EOI
    if (pos + 4 > n) break;
    int seglen = be16(d + pos + 2);
    int64_t s0 = pos + 4;
    int64_t s1 = pos + 2 + seglen < n ? pos + 2 + seglen : n;
    int64_t len = s1 > s0 ? s1 - s0 : 0;  // the bytes the segment has
    const uint8_t* seg = d + s0;
    if (is_sof(m)) {
      if (len < 6) return kBadSof;
      int nc = seg[5];
      if (len < 6 + 3 * nc) return kBadSof;
      r.put(kSof);
      r.put(m);
      r.put(seg[0]);
      r.put(be16(seg + 1));
      r.put(be16(seg + 3));
      r.put(nc);
      for (int c = 0; c < nc; c++) {
        const uint8_t* e = seg + 6 + 3 * c;
        ids[c] = e[0];
        r.put(e[0]);
        r.put(e[1] >> 4);
        r.put(e[1] & 15);
        r.put(e[2]);
      }
      ncomp = nc;
      have_frame = true;
    } else if (m == 0xDB) {  // DQT
      int64_t p = 0;
      while (p < len) {
        p += 1 + ((seg[p] >> 4) ? 128 : 64);
        if (p > len) return kBadDqt;
      }
      r.put(kDqt);
      r.put(s0);
      r.put(s0 + len);
    } else if (m == 0xC4) {  // DHT
      r.put(kDht);
      r.put(s0);
      r.put(s0 + len);
    } else if (m == 0xDD) {  // DRI
      if (len < 2) return kBadDri;
      r.put(kDri);
      r.put(be16(seg));
    } else if (m == 0xEE) {  // APP14
      if (len >= 12 && memcmp(seg, "Adobe", 5) == 0) {
        r.put(kAdobe);
        r.put(seg[11]);
      }
    } else if (m == 0xDA) {  // SOS
      if (!have_frame) return kSosBeforeSof;
      if (len < 1) return kBadSos;
      int ns = seg[0];
      r.put(kSos);
      r.put(ns);
      for (int j = 0; j < ns; j++) {
        if (len < 3 + 2 * j) return kBadSos;
        int cs = seg[1 + 2 * j], tt = seg[2 + 2 * j];
        int idx = -1;
        for (int c = 0; c < ncomp && idx < 0; c++)
          if (ids[c] == cs) idx = c;
        if (idx < 0) return kSosComponent;
        r.put(idx);
        r.put(tt >> 4);
        r.put(tt & 15);
      }
      if (len < 4 + 2 * ns) return kBadSos;
      r.put(seg[1 + 2 * ns]);
      r.put(seg[2 + 2 * ns]);
      r.put(seg[3 + 2 * ns] >> 4);
      r.put(seg[3 + 2 * ns] & 15);
      int64_t data_start = pos + 2 + seglen;
      int64_t data_end = scan_end(d, n, data_start);
      r.put(data_start);
      r.put(data_end);
      pos = data_end;
      continue;
    }
    pos += 2 + seglen;
  }
  return have_frame ? kOk : kNoFrame;
}

}  // namespace

extern "C" {

// Walks n streams on the calling thread. Stream i's record goes to
// rec[offs[i] .. offs[i + 1]); status[i] is its status and used[i] the
// words its record takes. When the record does not fit, status[i] is -2
// and the caller walks the stream again with used[i] words. Returns 0.
int tic_jpeg_parse_batch(int32_t n, const uint8_t* const* datas,
                         const int64_t* lens, int64_t* rec,
                         const int64_t* offs, int64_t* status,
                         int64_t* used) {
  for (int32_t i = 0; i < n; i++) {
    Record r{rec + offs[i], offs[i + 1] - offs[i]};
    int64_t st = walk(datas[i], lens[i], r);
    if (st == kOk && r.n > r.cap) st = kCapacity;
    status[i] = st;
    used[i] = r.n;
  }
  return 0;
}

}  // extern "C"
