// J2K reconstruction epilogue — fused inverse RCT + DC level shift + clamp
// + interleave, replacing the per-tile numpy full-array passes with
// one native sweep (the role the reference's nvjpeg2k device output stage
// plays, extensions/nvjpeg2k/cuda_decoder.cpp:601-640, for the host path).
// From-scratch implementation; no reference code used.

#include <cstdint>

extern "C" {

// Reversible path, u8 output: planes are the int32 IDWT outputs (Y, Cb, Cr
// of T.800 G.2's inverse RCT), out is interleaved [h*w, 3] u8.
int tic_j2k_rct_shift_u8(const int32_t* y, const int32_t* cb,
                         const int32_t* cr, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int32_t g = y[i] - ((cb[i] + cr[i]) >> 2);
    int32_t r = cr[i] + g + 128;
    int32_t b = cb[i] + g + 128;
    int32_t gg = g + 128;
    r = r < 0 ? 0 : (r > 255 ? 255 : r);
    gg = gg < 0 ? 0 : (gg > 255 ? 255 : gg);
    b = b < 0 ? 0 : (b > 255 ? 255 : b);
    out[3 * i] = (uint8_t)r;
    out[3 * i + 1] = (uint8_t)gg;
    out[3 * i + 2] = (uint8_t)b;
  }
  return 0;
}

// No-MCT variant: shift+clamp one plane into a strided (interleaved)
// channel of the u8 output. ncomp = pixel stride, out points at channel 0
// of the target channel.
int tic_j2k_shift_u8(const int32_t* p, int64_t n, int32_t ncomp,
                     uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int32_t v = p[i] + 128;
    v = v < 0 ? 0 : (v > 255 ? 255 : v);
    out[i * ncomp] = (uint8_t)v;
  }
  return 0;
}

}  // extern "C"
