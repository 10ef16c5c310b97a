// Last-resort system-codec shim: thin C wrappers over the system libjpeg
// and libpng so the fallback ladder has a bottom rung for JPEG and PNG,
// matching the reference's opencv universal fallback registration
// (reference: extensions/opencv/opencv_ext.cpp:38-44, LOW priority).
//
// Built lazily (see system_codecs.py) and only used for streams the native
// decoders reject; absent libraries degrade gracefully. libjpeg's
// longjmp-based error handling cannot be driven from ctypes, hence C.
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

extern "C" {

void tic_sys_free(void* p) { free(p); }

namespace {
struct JErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

void jerr_silent(j_common_ptr, int) {}
}  // namespace

// Decode to packed 8-bit pixels. *ch on return: 1 (gray), 3 (RGB) or
// 4 (CMYK); *adobe = saw_Adobe_marker (Adobe CMYK stores inverted values,
// the caller branches on it). Returns 0 on success. Tolerates
// truncated/partial streams the way libjpeg does (warnings suppressed,
// error only on hard failure).
int tic_sys_jpeg_decode(const uint8_t* data, size_t len, uint8_t** out,
                        int* w, int* h, int* ch, int* adobe) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_silent;
  *out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(*out);
    *out = nullptr;
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_GRAYSCALE)
    cinfo.out_color_space = JCS_GRAYSCALE;
  else if (cinfo.jpeg_color_space == JCS_CMYK ||
           cinfo.jpeg_color_space == JCS_YCCK)
    cinfo.out_color_space = JCS_CMYK;
  else
    cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int W = (int)cinfo.output_width, H = (int)cinfo.output_height;
  int C = cinfo.output_components;
  size_t stride = (size_t)W * C;
  uint8_t* buf = (uint8_t*)malloc((size_t)H * stride);
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *out = buf;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = buf + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  *adobe = cinfo.saw_Adobe_marker ? 1 : 0;
  jpeg_destroy_decompress(&cinfo);
  *w = W;
  *h = H;
  *ch = C;
  return 0;
}

// PNG via libpng's simplified read API: always RGBA8 output (the caller
// collapses alpha/gray per its own layout policy). Returns 0 on success.
int tic_sys_png_decode(const uint8_t* data, size_t len, uint8_t** out,
                       int* w, int* h) {
  png_image img;
  memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  *out = nullptr;
  if (!png_image_begin_read_from_memory(&img, data, len)) return -1;
  img.format = PNG_FORMAT_RGBA;
  size_t nbytes = PNG_IMAGE_SIZE(img);
  uint8_t* buf = (uint8_t*)malloc(nbytes);
  if (!buf) {
    png_image_free(&img);
    return -2;
  }
  if (!png_image_finish_read(&img, nullptr, buf, 0, nullptr)) {
    png_image_free(&img);
    free(buf);
    return -1;
  }
  *out = buf;
  *w = (int)img.width;
  *h = (int)img.height;
  return 0;
}

}  // extern "C"
