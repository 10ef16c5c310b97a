// Optional system-openjpeg decode shim (HTJ2K + exotic JPEG2000 variants).
//
// The framework analog of the reference's opencv fallback extension
// (extensions/opencv/opencv_decoder.cpp): our native J2K implementation
// handles the common envelope; streams it rejects (HT block coding,
// per-component coding overrides, precinct partitions, subsampled
// components) fall through to the system libopenjp2 at LOW priority.
//
// libopenjp2 ships no headers here, so the minimal public API is declared
// locally; the struct layouts are validated at runtime by the Python side
// (decode a known stream, check dims/pixels) before the plugin registers.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---- minimal OpenJPEG 2.x public API (matches libopenjp2.so.2.5) ----
typedef int OPJ_BOOL;
typedef size_t OPJ_SIZE_T;
typedef int64_t OPJ_OFF_T;

typedef struct opj_image_comp {
  uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
  int32_t* data;
  uint16_t alpha;
} opj_image_comp_t;

typedef struct opj_image {
  uint32_t x0, y0, x1, y1;
  uint32_t numcomps;
  int32_t color_space;
  opj_image_comp_t* comps;
  uint8_t* icc_profile_buf;
  uint32_t icc_profile_len;
} opj_image_t;

void* opj_create_decompress(int format);  // 0 = J2K, 2 = JP2
void opj_set_default_decoder_parameters(void* params);
OPJ_BOOL opj_setup_decoder(void* codec, void* params);
OPJ_BOOL opj_codec_set_threads(void* codec, int n);
void* opj_stream_create(OPJ_SIZE_T buf_size, OPJ_BOOL is_input);
void opj_stream_set_read_function(void* stream, OPJ_SIZE_T (*fn)(void*, OPJ_SIZE_T, void*));
void opj_stream_set_skip_function(void* stream, OPJ_OFF_T (*fn)(OPJ_OFF_T, void*));
void opj_stream_set_seek_function(void* stream, OPJ_BOOL (*fn)(OPJ_OFF_T, void*));
void opj_stream_set_user_data(void* stream, void* data, void (*free_fn)(void*));
void opj_stream_set_user_data_length(void* stream, uint64_t len);
OPJ_BOOL opj_read_header(void* stream, void* codec, opj_image_t** image);
OPJ_BOOL opj_decode(void* codec, void* stream, opj_image_t* image);
OPJ_BOOL opj_end_decompress(void* codec, void* stream);
void opj_destroy_codec(void* codec);
void opj_stream_destroy(void* stream);
void opj_image_destroy(opj_image_t* image);

// ---- in-memory stream ----
struct MemStream {
  const uint8_t* data;
  uint64_t len;
  uint64_t pos;
};

static OPJ_SIZE_T mem_read(void* out, OPJ_SIZE_T n, void* user) {
  MemStream* m = (MemStream*)user;
  if (m->pos >= m->len) return (OPJ_SIZE_T)-1;
  uint64_t take = m->len - m->pos;
  if (n < take) take = n;
  memcpy(out, m->data + m->pos, take);
  m->pos += take;
  return (OPJ_SIZE_T)take;
}

static OPJ_OFF_T mem_skip(OPJ_OFF_T n, void* user) {
  MemStream* m = (MemStream*)user;
  if (m->pos + n > m->len) {
    OPJ_OFF_T avail = (OPJ_OFF_T)(m->len - m->pos);
    m->pos = m->len;
    return avail > 0 ? avail : (OPJ_OFF_T)-1;
  }
  m->pos += n;
  return n;
}

static OPJ_BOOL mem_seek(OPJ_OFF_T n, void* user) {
  MemStream* m = (MemStream*)user;
  if (n < 0 || (uint64_t)n > m->len) return 0;
  m->pos = (uint64_t)n;
  return 1;
}

// Decode J2K/JP2 bytes → interleaved int32 samples.
// out buffer: caller-allocated, cap samples. Returns 0 ok.
int tic_opj_decode(const uint8_t* data, uint64_t len, int is_jp2,
                   int32_t* out, int64_t cap, int32_t* ow, int32_t* oh,
                   int32_t* oncomp, int32_t* oprec, int32_t* osgnd) {
  void* codec = opj_create_decompress(is_jp2 ? 2 : 0);
  if (!codec) return 1;
  // generous zeroed parameter block; defaults filled by the library
  void* params = calloc(1, 1 << 16);  // opj_dparameters_t embeds two 4 KB paths
  opj_set_default_decoder_parameters(params);
  if (!opj_setup_decoder(codec, params)) {
    free(params);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  // Oracle/baseline thread count. Default 1 so perf comparisons against
  // "openjpeg single-thread" are what they claim; TIC_OPJ_THREADS raises it
  // for parallel-baseline experiments.
  int nthr = 1;
  if (const char* e = getenv("TIC_OPJ_THREADS")) {
    nthr = atoi(e);
    if (nthr < 1) nthr = 1;
  }
  if (nthr > 1) opj_codec_set_threads(codec, nthr);

  MemStream ms{data, len, 0};
  void* stream = opj_stream_create(1 << 20, 1);
  opj_stream_set_read_function(stream, mem_read);
  opj_stream_set_skip_function(stream, mem_skip);
  opj_stream_set_seek_function(stream, mem_seek);
  opj_stream_set_user_data(stream, &ms, nullptr);
  opj_stream_set_user_data_length(stream, len);

  opj_image_t* image = nullptr;
  int rc = 0;
  if (!opj_read_header(stream, codec, &image)) {
    rc = 3;
  } else if (!opj_decode(codec, stream, image) ||
             !opj_end_decompress(codec, stream)) {
    rc = 4;
  } else {
    uint32_t nc = image->numcomps;
    if (nc < 1 || nc > 8 || !image->comps) {
      rc = 5;
    } else {
      uint32_t w = image->comps[0].w, h = image->comps[0].h;
      for (uint32_t c = 1; c < nc; c++)
        if (image->comps[c].w != w || image->comps[c].h != h) rc = 6;
      if (!rc) {
        if ((int64_t)w * h * nc > cap) {
          rc = 7;
        } else {
          for (uint32_t c = 0; c < nc; c++) {
            const int32_t* src = image->comps[c].data;
            if (!src) { rc = 8; break; }
            for (uint64_t i = 0; i < (uint64_t)w * h; i++)
              out[i * nc + c] = src[i];
          }
          *ow = (int32_t)w;
          *oh = (int32_t)h;
          *oncomp = (int32_t)nc;
          *oprec = (int32_t)image->comps[0].prec;
          *osgnd = (int32_t)image->comps[0].sgnd;
        }
      }
    }
  }
  if (image) opj_image_destroy(image);
  opj_stream_destroy(stream);
  opj_destroy_codec(codec);
  return rc;
}

}  // extern "C"

extern "C" {

typedef struct opj_image_cmptparm {
  uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd;
} opj_image_cmptparm_t;

void* opj_create_compress(int format);
void opj_set_default_encoder_parameters(void* params);
OPJ_BOOL opj_setup_encoder(void* codec, void* params, opj_image_t* image);
OPJ_BOOL opj_start_compress(void* codec, opj_image_t* image, void* stream);
OPJ_BOOL opj_encode(void* codec, void* stream);
OPJ_BOOL opj_end_compress(void* codec, void* stream);
opj_image_t* opj_image_create(uint32_t numcmpts, opj_image_cmptparm_t* cmptparms,
                              int32_t clrspc);

struct GrowBuf {
  uint8_t* data;
  uint64_t len, cap, pos;
};

static OPJ_SIZE_T gb_write(void* src, OPJ_SIZE_T n, void* user) {
  GrowBuf* g = (GrowBuf*)user;
  if (g->pos + n > g->cap) {
    uint64_t cap = g->cap ? g->cap * 2 : 65536;
    while (cap < g->pos + n) cap *= 2;
    g->data = (uint8_t*)realloc(g->data, cap);
    g->cap = cap;
  }
  memcpy(g->data + g->pos, src, n);
  g->pos += n;
  if (g->pos > g->len) g->len = g->pos;
  return n;
}

static OPJ_OFF_T gb_skip(OPJ_OFF_T n, void* user) {
  GrowBuf* g = (GrowBuf*)user;
  g->pos += n;
  return n;
}

static OPJ_BOOL gb_seek(OPJ_OFF_T n, void* user) {
  GrowBuf* g = (GrowBuf*)user;
  g->pos = (uint64_t)n;
  return 1;
}

void opj_stream_set_write_function(void* stream, OPJ_SIZE_T (*fn)(void*, OPJ_SIZE_T, void*));

// Lossless-encode interleaved samples with openjpeg (conformance oracle).
// prec <= 8: pix is u8; prec 9..16: pix is u16 (native endian).
// Caller frees *out with free().
int tic_opj_encode_lossless(const uint8_t* pix, int w, int h, int ncomp,
                            int is_jp2, int prec, uint8_t** out,
                            uint64_t* outlen) {
  opj_image_cmptparm_t parms[4];
  memset(parms, 0, sizeof(parms));
  for (int c = 0; c < ncomp; c++) {
    parms[c].dx = parms[c].dy = 1;
    parms[c].w = (uint32_t)w;
    parms[c].h = (uint32_t)h;
    parms[c].prec = (uint32_t)prec;
    parms[c].sgnd = 0;
  }
  // color space: 1 = sRGB, 2 = gray
  opj_image_t* image = opj_image_create((uint32_t)ncomp, parms,
                                        ncomp >= 3 ? 1 : 2);
  if (!image) return 1;
  image->x0 = 0;
  image->y0 = 0;
  image->x1 = (uint32_t)w;
  image->y1 = (uint32_t)h;
  if (prec <= 8) {
    for (int c = 0; c < ncomp; c++)
      for (int64_t i = 0; i < (int64_t)w * h; i++)
        image->comps[c].data[i] = pix[i * ncomp + c];
  } else {
    const uint16_t* p16 = (const uint16_t*)pix;
    for (int c = 0; c < ncomp; c++)
      for (int64_t i = 0; i < (int64_t)w * h; i++)
        image->comps[c].data[i] = p16[i * ncomp + c];
  }

  void* codec = opj_create_compress(is_jp2 ? 2 : 0);
  void* params = calloc(1, 1 << 16);
  opj_set_default_encoder_parameters(params);
  if (!opj_setup_encoder(codec, params, image)) {
    free(params);
    opj_image_destroy(image);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);

  GrowBuf gb{nullptr, 0, 0, 0};
  void* stream = opj_stream_create(1 << 20, 0);
  opj_stream_set_write_function(stream, gb_write);
  opj_stream_set_skip_function(stream, gb_skip);
  opj_stream_set_seek_function(stream, gb_seek);
  opj_stream_set_user_data(stream, &gb, nullptr);

  int rc = 0;
  if (!opj_start_compress(codec, image, stream) || !opj_encode(codec, stream) ||
      !opj_end_compress(codec, stream))
    rc = 3;
  opj_stream_destroy(stream);
  opj_destroy_codec(codec);
  opj_image_destroy(image);
  if (rc) {
    free(gb.data);
    return rc;
  }
  *out = gb.data;
  *outlen = gb.len;
  return 0;
}


// Decode ONE component's plane (subsampled streams have per-component
// dims; the interleaved tic_opj_decode rejects those). Returns 0 ok.
int tic_opj_decode_comp(const uint8_t* data, uint64_t len, int is_jp2,
                        int comp, int32_t* out, int64_t cap, int32_t* ow,
                        int32_t* oh, int32_t* oprec, int32_t* osgnd,
                        int32_t* odx, int32_t* ody, int32_t* oncomp) {
  void* codec = opj_create_decompress(is_jp2 ? 2 : 0);
  if (!codec) return 1;
  void* params = calloc(1, 1 << 16);
  opj_set_default_decoder_parameters(params);
  if (!opj_setup_decoder(codec, params)) {
    free(params);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  MemStream ms{data, len, 0};
  void* stream = opj_stream_create(1 << 20, 1);
  opj_stream_set_read_function(stream, mem_read);
  opj_stream_set_skip_function(stream, mem_skip);
  opj_stream_set_seek_function(stream, mem_seek);
  opj_stream_set_user_data(stream, &ms, nullptr);
  opj_stream_set_user_data_length(stream, len);
  opj_image_t* image = nullptr;
  int rc = 0;
  if (!opj_read_header(stream, codec, &image)) {
    rc = 3;
  } else if (!opj_decode(codec, stream, image) ||
             !opj_end_decompress(codec, stream)) {
    rc = 4;
  } else if (comp < 0 || (uint32_t)comp >= image->numcomps) {
    rc = 5;
  } else {
    opj_image_comp_t* cc = &image->comps[comp];
    if ((int64_t)cc->w * cc->h > cap) {
      rc = 7;
    } else {
      memcpy(out, cc->data, (uint64_t)cc->w * cc->h * 4);
      *ow = (int32_t)cc->w;
      *oh = (int32_t)cc->h;
      *oprec = (int32_t)cc->prec;
      *osgnd = (int32_t)cc->sgnd;
      *odx = (int32_t)cc->dx;
      *ody = (int32_t)cc->dy;
      *oncomp = (int32_t)image->numcomps;
    }
  }
  if (image) opj_image_destroy(image);
  opj_stream_destroy(stream);
  opj_destroy_codec(codec);
  return rc;
}

// Lossless-encode PLANAR int32 components with per-component subsampling
// and signedness (oracle generator for subsampled / signed conformance
// streams). planes: ncomp pointers, each ceil(w/dx)*ceil(h/dy) samples.
// clrspc: OPJ_CLRSPC value for the image (1=SRGB, 2=GRAY, 3=SYCC — drives
// the JP2 colr box enumCS), or -1 for the ncomp-derived default.
int tic_opj_encode_planes(const int32_t* const* planes, int w, int h,
                          int ncomp, const int32_t* dx, const int32_t* dy,
                          int prec, int sgnd, int is_jp2, int clrspc,
                          uint8_t** out, uint64_t* outlen) {
  opj_image_cmptparm_t parms[4];
  memset(parms, 0, sizeof(parms));
  for (int c = 0; c < ncomp; c++) {
    parms[c].dx = (uint32_t)dx[c];
    parms[c].dy = (uint32_t)dy[c];
    parms[c].w = (uint32_t)((w + dx[c] - 1) / dx[c]);
    parms[c].h = (uint32_t)((h + dy[c] - 1) / dy[c]);
    parms[c].prec = (uint32_t)prec;
    parms[c].sgnd = (uint32_t)sgnd;
  }
  opj_image_t* image = opj_image_create(
      (uint32_t)ncomp, parms, clrspc > 0 ? clrspc : (ncomp >= 3 ? 1 : 2));
  if (!image) return 1;
  image->x0 = 0;
  image->y0 = 0;
  image->x1 = (uint32_t)w;
  image->y1 = (uint32_t)h;
  for (int c = 0; c < ncomp; c++) {
    int64_t n = (int64_t)parms[c].w * parms[c].h;
    memcpy(image->comps[c].data, planes[c], (uint64_t)n * 4);
  }
  void* codec = opj_create_compress(is_jp2 ? 2 : 0);
  void* params = calloc(1, 1 << 16);
  opj_set_default_encoder_parameters(params);
  if (!opj_setup_encoder(codec, params, image)) {
    free(params);
    opj_image_destroy(image);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  GrowBuf gb{nullptr, 0, 0, 0};
  void* stream = opj_stream_create(1 << 20, 0);
  opj_stream_set_write_function(stream, gb_write);
  opj_stream_set_skip_function(stream, gb_skip);
  opj_stream_set_seek_function(stream, gb_seek);
  opj_stream_set_user_data(stream, &gb, nullptr);
  int rc = 0;
  if (!opj_start_compress(codec, image, stream) ||
      !opj_encode(codec, stream) || !opj_end_compress(codec, stream))
    rc = 3;
  opj_stream_destroy(stream);
  opj_image_destroy(image);
  opj_destroy_codec(codec);
  if (rc) {
    free(gb.data);
    return rc;
  }
  *out = gb.data;
  *outlen = gb.len;
  return 0;
}

// Lossless encode with a part-1 code-block style (T.800 A.6.1 SPcod mode
// switches: BYPASS/RESET/TERMALL/CAUSAL/SEGSYM) — oracle streams for our
// TERMALL/BYPASS decoder. No opj header ships with the shim, so the
// `mode` field of opj_cparameters_t is located EMPIRICALLY: after
// opj_set_default_encoder_parameters the struct contains the unique
// int32 run [numresolution=6, cblockw_init=64, cblockh_init=64, mode=0];
// `mode` is the int following the first such run. The produced stream's
// COD SPcod style byte is verified to equal the requested mode (return 4
// on any layout drift).
int tic_opj_encode_mode(const uint8_t* pix, int w, int h, int ncomp,
                        int prec, int mode, int nlayers, uint8_t** out,
                        uint64_t* outlen) {
  opj_image_cmptparm_t parms[4];
  memset(parms, 0, sizeof(parms));
  for (int c = 0; c < ncomp; c++) {
    parms[c].dx = parms[c].dy = 1;
    parms[c].w = (uint32_t)w;
    parms[c].h = (uint32_t)h;
    parms[c].prec = (uint32_t)prec;
    parms[c].sgnd = 0;
  }
  opj_image_t* image = opj_image_create((uint32_t)ncomp, parms,
                                        ncomp >= 3 ? 1 : 2);
  if (!image) return 1;
  image->x0 = 0;
  image->y0 = 0;
  image->x1 = (uint32_t)w;
  image->y1 = (uint32_t)h;
  if (prec <= 8) {
    for (int c = 0; c < ncomp; c++)
      for (int64_t i = 0; i < (int64_t)w * h; i++)
        image->comps[c].data[i] = pix[i * ncomp + c];
  } else {
    const uint16_t* p16 = (const uint16_t*)pix;
    for (int c = 0; c < ncomp; c++)
      for (int64_t i = 0; i < (int64_t)w * h; i++)
        image->comps[c].data[i] = p16[i * ncomp + c];
  }
  void* codec = opj_create_compress(0);
  void* params = calloc(1, 1 << 16);
  opj_set_default_encoder_parameters(params);
  {
    int32_t* p = (int32_t*)params;
    int found = -1;
    for (int i = 12; i < (1 << 14) - 4; i++) {
      if (p[i] == 6 && p[i + 1] == 64 && p[i + 2] == 64 && p[i + 3] == 0) {
        found = i + 3;
        break;
      }
    }
    if (found < 0) {
      free(params);
      opj_image_destroy(image);
      opj_destroy_codec(codec);
      return 4;
    }
    p[found] = mode;
    {
      // opj rejects images smaller than the resolution pyramid; clamp
      // numresolution (int preceding cblockw_init) like opj_compress does
      int mind = w < h ? w : h;
      int nres = 1;
      while (nres < 6 && (1 << nres) <= mind) nres++;
      p[found - 3] = nres;
    }
    if (nlayers > 1) {
      // layout preceding numresolution (= found-3):
      // int tcp_numlayers; float tcp_rates[100]; float tcp_distoratio[100]
      int nres = found - 3;
      int nlay = nres - 201;
      if (nlay < 5 || (p[nlay] != 0 && p[nlay] != 1)) {
        free(params);
        opj_image_destroy(image);
        opj_destroy_codec(codec);
        return 4;
      }
      p[nlay] = nlayers;
      p[5] = 1;  // cp_disto_alloc (rate-driven layer allocation)
      float* rates = (float*)(p + nlay + 1);
      for (int l = 0; l < nlayers; l++)
        rates[l] = (float)(1 << (2 * (nlayers - 1 - l)));  // 16,4,1...
    }
  }
  if (!opj_setup_encoder(codec, params, image)) {
    free(params);
    opj_image_destroy(image);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  GrowBuf gb{nullptr, 0, 0, 0};
  void* stream = opj_stream_create(1 << 20, 0);
  opj_stream_set_write_function(stream, gb_write);
  opj_stream_set_skip_function(stream, gb_skip);
  opj_stream_set_seek_function(stream, gb_seek);
  opj_stream_set_user_data(stream, &gb, nullptr);
  int rc = 0;
  if (!opj_start_compress(codec, image, stream) ||
      !opj_encode(codec, stream) || !opj_end_compress(codec, stream))
    rc = 3;
  opj_stream_destroy(stream);
  opj_destroy_codec(codec);
  opj_image_destroy(image);
  if (rc) {
    free(gb.data);
    return rc;
  }
  // verify the COD SPcod style byte actually carries `mode` and SGcod
  // the layer count (guards the empirical offset poking above)
  {
    bool ok = false;
    for (uint64_t i = 0; i + 14 <= gb.len; i++) {
      if (gb.data[i] == 0xFF && gb.data[i + 1] == 0x52) {
        // COD: Lcod(2) Scod(1) SGcod: prog(1) layers(2 BE) mct(1)
        //      SPcod: levels cbw cbh STYLE
        ok = gb.data[i + 4 + 1 + 4 + 3] == (uint8_t)mode;
        int lay = (gb.data[i + 6] << 8) | gb.data[i + 7];
        ok = ok && lay == (nlayers > 1 ? nlayers : 1);
        break;
      }
    }
    if (!ok) {
      free(gb.data);
      return 4;
    }
  }
  *out = gb.data;
  *outlen = gb.len;
  return 0;
}

// Lossless encode with progression-order changes (T.800 A.6.6 POC) —
// oracle for our POC packet-order iterator. Field offsets inside
// opj_cparameters_t are derived from the same empirically-located
// [numresolution=6, cblockw_init=64, cblockh_init=64, mode=0] anchor as
// tic_opj_encode_mode: tcp_numlayers = numresolution - 201 ints back,
// numpocs immediately precedes it, and POC[32] spans ints [14, numpocs)
// (stride self-computed and sanity-checked; return 4 on layout drift).
// Each poc entry: {resno0, compno0, layno1, resno1, compno1, prg}.
int tic_opj_encode_poc(const uint8_t* pix, int w, int h, int ncomp,
                       int nlayers, const int32_t* pocs, int npocs,
                       int levels, uint8_t** out, uint64_t* outlen) {
  opj_image_cmptparm_t parms[4];
  memset(parms, 0, sizeof(parms));
  for (int c = 0; c < ncomp; c++) {
    parms[c].dx = parms[c].dy = 1;
    parms[c].w = (uint32_t)w;
    parms[c].h = (uint32_t)h;
    parms[c].prec = 8;
    parms[c].sgnd = 0;
  }
  opj_image_t* image = opj_image_create((uint32_t)ncomp, parms,
                                        ncomp >= 3 ? 1 : 2);
  if (!image) return 1;
  image->x0 = 0;
  image->y0 = 0;
  image->x1 = (uint32_t)w;
  image->y1 = (uint32_t)h;
  for (int c = 0; c < ncomp; c++)
    for (int64_t i = 0; i < (int64_t)w * h; i++)
      image->comps[c].data[i] = pix[i * ncomp + c];
  void* codec = opj_create_compress(0);
  void* params = calloc(1, 1 << 16);
  opj_set_default_encoder_parameters(params);
  {
    int32_t* p = (int32_t*)params;
    int found = -1;
    for (int i = 12; i < (1 << 14) - 4; i++) {
      if (p[i] == 6 && p[i + 1] == 64 && p[i + 2] == 64 && p[i + 3] == 0) {
        found = i + 3;
        break;
      }
    }
    if (found < 0) goto layout_fail;
    {
      int nres_idx = found - 3;
      int nlay_idx = nres_idx - 201;
      int npocs_idx = nlay_idx - 1;
      int stride = (npocs_idx - 14) / 32;
      if (nlay_idx < 16 || (npocs_idx - 14) % 32 != 0 || stride < 30 ||
          stride > 48 || p[npocs_idx] != 0 ||
          (p[nlay_idx] != 0 && p[nlay_idx] != 1))
        goto layout_fail;
      p[nres_idx] = levels + 1;
      p[nlay_idx] = nlayers;
      if (nlayers > 1) {
        p[5] = 1;  // cp_disto_alloc
        float* rates = (float*)(p + nlay_idx + 1);
        for (int l = 0; l < nlayers; l++)
          rates[l] = (float)(1 << (2 * (nlayers - 1 - l)));
      }
      p[npocs_idx] = npocs;
      for (int k = 0; k < npocs && k < 32; k++) {
        int32_t* e = p + 14 + k * stride;
        e[0] = pocs[k * 6 + 0];   // resno0
        e[1] = pocs[k * 6 + 1];   // compno0
        e[2] = pocs[k * 6 + 2];   // layno1
        e[3] = pocs[k * 6 + 3];   // resno1
        e[4] = pocs[k * 6 + 4];   // compno1
        e[8] = pocs[k * 6 + 5];   // prg1
        e[9] = pocs[k * 6 + 5];   // prg (the one the encoder pi uses)
        e[12] = 1;                // tile, 1-based (0 = entry ignored)
      }
    }
  }
  if (!opj_setup_encoder(codec, params, image)) {
    free(params);
    opj_image_destroy(image);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  {
    GrowBuf gb{nullptr, 0, 0, 0};
    void* stream = opj_stream_create(1 << 20, 0);
    opj_stream_set_write_function(stream, gb_write);
    opj_stream_set_skip_function(stream, gb_skip);
    opj_stream_set_seek_function(stream, gb_seek);
    opj_stream_set_user_data(stream, &gb, nullptr);
    int rc = 0;
    if (!opj_start_compress(codec, image, stream) ||
        !opj_encode(codec, stream) || !opj_end_compress(codec, stream))
      rc = 3;
    opj_stream_destroy(stream);
    opj_destroy_codec(codec);
    opj_image_destroy(image);
    if (rc) {
      free(gb.data);
      return rc;
    }
    // guard: the stream must actually carry a POC marker segment
    bool has_poc = false;
    for (uint64_t i = 0; i + 2 <= gb.len; i++)
      if (gb.data[i] == 0xFF && gb.data[i + 1] == 0x5F) {
        has_poc = true;
        break;
      }
    if (!has_poc) {
      free(gb.data);
      return 4;
    }
    *out = gb.data;
    *outlen = gb.len;
    return 0;
  }
layout_fail:
  free(params);
  opj_image_destroy(image);
  opj_destroy_codec(codec);
  return 4;
}

// Lossless encode with explicit reference-grid offsets — oracle for the
// odd image/tile-origin decode path (T.800 B.3/B.4 arbitrary XOsiz/YOsiz/
// XTOsiz/YTOsiz). Pixels live on grid [ox, ox+w) x [oy, oy+h); tiles are
// tdx x tdy anchored at (tx0, ty0) (0 = untiled). Tile fields are the
// leading five ints of opj_cparameters_t (stable layout across 2.x:
// tile_size_on, cp_tx0, cp_ty0, cp_tdx, cp_tdy).
int tic_opj_encode_offsets(const int32_t* pix, int w, int h, int ncomp,
                           int ox, int oy, int tx0, int ty0, int tdx,
                           int tdy, int prec, int is_jp2, uint8_t** out,
                           uint64_t* outlen) {
  opj_image_cmptparm_t parms[4];
  memset(parms, 0, sizeof(parms));
  for (int c = 0; c < ncomp; c++) {
    parms[c].dx = 1;
    parms[c].dy = 1;
    parms[c].w = (uint32_t)w;
    parms[c].h = (uint32_t)h;
    parms[c].x0 = (uint32_t)ox;
    parms[c].y0 = (uint32_t)oy;
    parms[c].prec = (uint32_t)prec;
    parms[c].sgnd = 0;
  }
  opj_image_t* image = opj_image_create((uint32_t)ncomp, parms,
                                        ncomp >= 3 ? 1 : 2);
  if (!image) return 1;
  image->x0 = (uint32_t)ox;
  image->y0 = (uint32_t)oy;
  image->x1 = (uint32_t)(ox + w);
  image->y1 = (uint32_t)(oy + h);
  for (int c = 0; c < ncomp; c++)
    for (int64_t i = 0; i < (int64_t)w * h; i++)
      image->comps[c].data[i] = pix[i * ncomp + c];
  void* codec = opj_create_compress(is_jp2 ? 2 : 0);
  void* params = calloc(1, 1 << 16);
  opj_set_default_encoder_parameters(params);
  if (tdx > 0) {
    int32_t* p = (int32_t*)params;
    p[0] = 1;  // tile_size_on
    p[1] = tx0;
    p[2] = ty0;
    p[3] = tdx;
    p[4] = tdy;
  }
  if (!opj_setup_encoder(codec, params, image)) {
    free(params);
    opj_image_destroy(image);
    opj_destroy_codec(codec);
    return 2;
  }
  free(params);
  GrowBuf gb{nullptr, 0, 0, 0};
  void* stream = opj_stream_create(1 << 20, 0);
  opj_stream_set_write_function(stream, gb_write);
  opj_stream_set_skip_function(stream, gb_skip);
  opj_stream_set_seek_function(stream, gb_seek);
  opj_stream_set_user_data(stream, &gb, nullptr);
  int rc = 0;
  if (!opj_start_compress(codec, image, stream) ||
      !opj_encode(codec, stream) || !opj_end_compress(codec, stream))
    rc = 3;
  opj_stream_destroy(stream);
  opj_image_destroy(image);
  opj_destroy_codec(codec);
  if (rc) {
    free(gb.data);
    return rc;
  }
  // Sanity-decode the SIZ of the produced stream: the tile fields above
  // are poked by int32 offset into opj_cparameters_t, so verify the
  // requested geometry actually landed (guards against any 2.x layout
  // drift; ADVICE r3). Scan for SOC+SIZ (FF4F FF51 — works for raw and
  // jp2c-wrapped streams alike).
  {
    auto rd32 = [](const uint8_t* p) {
      return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
             ((uint32_t)p[2] << 8) | (uint32_t)p[3];
    };
    const uint8_t* siz = nullptr;
    for (uint64_t i = 0; i + 42 <= gb.len; i++) {
      if (gb.data[i] == 0xFF && gb.data[i + 1] == 0x4F &&
          gb.data[i + 2] == 0xFF && gb.data[i + 3] == 0x51) {
        siz = gb.data + i + 4;  // points at Lsiz
        break;
      }
    }
    bool ok = siz != nullptr;
    if (ok) {
      // siz -> Lsiz(2) Rsiz(2) Xsiz(4) Ysiz(4) XOsiz YOsiz XTsiz YTsiz
      //        XTOsiz YTOsiz
      uint32_t xo = rd32(siz + 12), yo = rd32(siz + 16);
      uint32_t xt = rd32(siz + 20), yt = rd32(siz + 24);
      uint32_t xto = rd32(siz + 28), yto = rd32(siz + 32);
      ok = xo == (uint32_t)ox && yo == (uint32_t)oy;
      if (ok && tdx > 0)
        ok = xt == (uint32_t)tdx && yt == (uint32_t)tdy &&
             xto == (uint32_t)tx0 && yto == (uint32_t)ty0;
    }
    if (!ok) {
      free(gb.data);
      return 4;
    }
  }
  *out = gb.data;
  *outlen = gb.len;
  return 0;
}

}  // extern "C"
