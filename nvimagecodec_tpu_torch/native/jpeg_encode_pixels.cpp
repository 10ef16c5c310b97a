// JPEG encode pixel stage — native host path.
//
// Color convert + chroma downsample + fDCT + quantization for the hybrid
// encoder's host mode (the role nvjpeg's GPU stage plays in the reference,
// extensions/nvjpeg/cuda_encoder.cpp:284-436, when the accelerator's
// readback path is not worth the round trip). Semantics match the
// framework's array ops: libjpeg jccolor.c fixed-point color (ops/color.py),
// libjpeg bias-exact h2v2/h2v1/h1v2 downsampling (ops/resample.py), and the
// separable orthonormal fDCT with the quant reciprocal folded in
// (ops/dct.py quant_dct_matrix) with round-half-away-from-zero.
//
// From-scratch implementation; no reference code used.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// fixed-point color constants, round(x * 2^16) (libjpeg SCALEBITS=16)
const int32_t FIX_0_29900 = 19595;
const int32_t FIX_0_58700 = 38470;
const int32_t FIX_0_11400 = 7471;
const int32_t FIX_0_16874 = 11059;
const int32_t FIX_0_33126 = 21709;
const int32_t FIX_0_50000 = 32768;
const int32_t FIX_0_41869 = 27439;
const int32_t FIX_0_08131 = 5329;
const int32_t ONE_HALF = 1 << 15;
const int32_t CBCR_OFF = (128 << 16) + ONE_HALF - 1;

struct DctBasis {
  float c[8][8];
  DctBasis() {
    for (int k = 0; k < 8; k++) {
      double ck = k == 0 ? 1.0 / std::sqrt(2.0) : 1.0;
      for (int x = 0; x < 8; x++)
        c[k][x] = (float)(0.5 * ck * std::cos((2 * x + 1) * k * M_PI / 16.0));
    }
  }
};
const DctBasis kDct;

inline int16_t* plane_alloc(int64_t n) {
  return (int16_t*)malloc(n * sizeof(int16_t));
}

// forward 8x8 DCT of a centered f32 block, quantized with qinv[64]
inline void fdct_quant(const float in[64], const float* qinv, int16_t* out) {
  float tmp[64];
  // rows of S' = C @ P  (tmp[u][y] = sum_x C[u][x] * P[x][y])
  for (int u = 0; u < 8; u++) {
    for (int y = 0; y < 8; y++) {
      float s = 0.f;
      for (int x = 0; x < 8; x++) s += kDct.c[u][x] * in[x * 8 + y];
      tmp[u * 8 + y] = s;
    }
  }
  // S = S' @ C^T  (out[u][v] = sum_y tmp[u][y] * C[v][y])
  for (int u = 0; u < 8; u++) {
    for (int v = 0; v < 8; v++) {
      float s = 0.f;
      for (int y = 0; y < 8; y++) s += tmp[u * 8 + y] * kDct.c[v][y];
      float q = s * qinv[u * 8 + v];
      // round half away from zero (symmetric quantizer)
      out[u * 8 + v] = (int16_t)(q >= 0 ? (int)(q + 0.5f) : -(int)(-q + 0.5f));
    }
  }
}

}  // namespace

extern "C" {

// img: uint8 interleaved [H, W, nchan] (nchan 1 or 3).
// ncomp components with sampling factors hfac/vfac; per-component
// qinv[ncomp*64] natural-order reciprocal quant scale (1/q * DCT fold is
// applied HERE as plain 1/q since the basis is orthonormal).
// out[c]: caller-allocated int16 [bh, bw, 64] natural-order blocks.
// Returns 0, or a negative code for unsupported layouts (caller falls back).
int tic_jpeg_encode_pixels(const uint8_t* img, int64_t H, int64_t W,
                           int32_t nchan, int32_t ncomp, const int32_t* hfac,
                           const int32_t* vfac, const float* qinv,
                           int16_t** out, const int32_t* obw,
                           const int32_t* obh) {
  if (nchan != 1 && nchan != 3) return -1;
  if (ncomp != 1 && ncomp != 3) return -1;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; c++) {
    if (hfac[c] < 1 || vfac[c] < 1) return -1;
    if (hfac[c] > hmax) hmax = hfac[c];
    if (vfac[c] > vmax) vmax = vfac[c];
  }

  // --- color convert to full-res component planes ------------------------
  int16_t* full[3] = {nullptr, nullptr, nullptr};
  for (int c = 0; c < ncomp; c++) {
    full[c] = plane_alloc(H * W);
    if (!full[c]) {
      for (int k = 0; k < c; k++) free(full[k]);
      return -2;
    }
  }
  for (int64_t y = 0; y < H; y++) {
    const uint8_t* row = img + y * W * nchan;
    if (ncomp == 3) {  // RGB -> YCbCr (nchan == 3 enforced below)
      if (nchan != 3) {
        for (int c = 0; c < 3; c++) free(full[c]);
        return -1;
      }
      int16_t* py = full[0] + y * W;
      int16_t* pcb = full[1] + y * W;
      int16_t* pcr = full[2] + y * W;
      for (int64_t x = 0; x < W; x++) {
        int r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
        py[x] = (int16_t)((FIX_0_29900 * r + FIX_0_58700 * g +
                           FIX_0_11400 * b + ONE_HALF) >> 16);
        pcb[x] = (int16_t)((-FIX_0_16874 * r - FIX_0_33126 * g +
                            FIX_0_50000 * b + CBCR_OFF) >> 16);
        pcr[x] = (int16_t)((FIX_0_50000 * r - FIX_0_41869 * g -
                            FIX_0_08131 * b + CBCR_OFF) >> 16);
      }
    } else {  // single component: gray passthrough or RGB -> luma
      int16_t* py = full[0] + y * W;
      if (nchan == 1) {
        for (int64_t x = 0; x < W; x++) py[x] = row[x];
      } else {
        for (int64_t x = 0; x < W; x++) {
          int r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
          py[x] = (int16_t)((FIX_0_29900 * r + FIX_0_58700 * g +
                             FIX_0_11400 * b + ONE_HALF) >> 16);
        }
      }
    }
  }

  // --- per component: downsample (clamped-edge), blockify, fDCT+quant ----
  int rc = 0;
  for (int c = 0; c < ncomp && rc == 0; c++) {
    int hf = hmax / hfac[c], vf = vmax / vfac[c];
    if (hf * hfac[c] != hmax || vf * vfac[c] != vmax ||
        (hf != 1 && hf != 2) || (vf != 1 && vf != 2)) {
      rc = -3;  // exotic sampling: caller falls back to the array path
      break;
    }
    int64_t cw = (W * hfac[c] + hmax - 1) / hmax;
    int64_t ch = (H * vfac[c] + vmax - 1) / vmax;
    int16_t* plane;
    int16_t* down = nullptr;
    if (hf == 1 && vf == 1) {
      plane = full[c];
    } else {
      down = plane_alloc(cw * ch);
      if (!down) { rc = -2; break; }
      for (int64_t y = 0; y < ch; y++) {
        int64_t y0 = y * vf;
        int64_t y1 = vf == 2 ? (y0 + 1 < H ? y0 + 1 : H - 1) : y0;
        const int16_t* r0 = full[c] + y0 * W;
        const int16_t* r1 = full[c] + y1 * W;
        int16_t* d = down + y * cw;
        if (hf == 2 && vf == 2) {
          for (int64_t x = 0; x < cw; x++) {
            int64_t x0 = 2 * x, x1 = x0 + 1 < W ? x0 + 1 : W - 1;
            int bias = 1 + (int)(x & 1);  // 1,2,1,2 (libjpeg h2v2)
            d[x] = (int16_t)((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
          }
        } else if (hf == 2) {
          for (int64_t x = 0; x < cw; x++) {
            int64_t x0 = 2 * x, x1 = x0 + 1 < W ? x0 + 1 : W - 1;
            int bias = (int)(x & 1);  // 0,1 (libjpeg h2v1)
            d[x] = (int16_t)((r0[x0] + r0[x1] + bias) >> 1);
          }
        } else {  // vf == 2 (h1v2)
          for (int64_t x = 0; x < cw; x++) {
            int bias = (int)(x & 1);
            d[x] = (int16_t)((r0[x] + r1[x] + bias) >> 1);
          }
        }
      }
      plane = down;
    }

    const int64_t bw = obw[c], bh = obh[c];
    const float* qi = qinv + c * 64;
    int16_t* dst = out[c];
    float blk[64];
    for (int64_t by = 0; by < bh; by++) {
      for (int64_t bx = 0; bx < bw; bx++) {
        for (int yy = 0; yy < 8; yy++) {
          int64_t sy = by * 8 + yy;
          if (sy >= ch) sy = ch - 1;  // edge-replicate pad
          const int16_t* src = plane + sy * cw;
          for (int xx = 0; xx < 8; xx++) {
            int64_t sx = bx * 8 + xx;
            if (sx >= cw) sx = cw - 1;
            blk[yy * 8 + xx] = (float)src[sx] - 128.0f;
          }
        }
        fdct_quant(blk, qi, dst + (by * bw + bx) * 64);
      }
    }
    free(down);
  }
  for (int c = 0; c < ncomp; c++) free(full[c]);
  return rc;
}

}  // extern "C"
