// JPEG decode for the native host input pipeline (the PyTorch port's copy of
// the JAX package's native/jpeg_decode.cpp).
//
// The reference's image path decodes JPEGs through PIL inside DataLoader
// workers (reference src/data/image_datasets/cocoimages_dataset.py:71-82);
// this is the native replacement: libjpeg decode at full resolution straight
// into a caller-provided RGB8 buffer. It matches PIL's default path
// bit-for-bit (both use the islow IDCT).
//
// Exposed C ABI (ctypes-bound in climb_tpu_torch/native/__init__.py):
//   jpg_dims(buf, len, &h, &w)                      -> header-only size probe
//   jpg_decode(buf, len, out, cap, &h, &w)          -> RGB8 rows, packed

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

}  // namespace

extern "C" {

// Returns 0 and fills (h, w) with the full-resolution dimensions, or -1 on
// malformed data.
int jpg_dims(const uint8_t* buf, int len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decodes into `out` (capacity `cap` bytes) as packed RGB8 rows. Fills the
// decoded (h, w). Returns 0 on success, -1 on malformed data, -2 if `out`
// is too small.
int jpg_decode(const uint8_t* buf, int len, uint8_t* out, long cap,
               int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;  // CMYK/grayscale/YCbCr all convert
  jpeg_start_decompress(&cinfo);

  const int oh = static_cast<int>(cinfo.output_height);
  const int ow = static_cast<int>(cinfo.output_width);
  const long row_bytes = static_cast<long>(ow) * cinfo.output_components;
  if (cinfo.output_components != 3 ||
      row_bytes * oh > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = oh;
  *w = ow;
  return 0;
}

}  // extern "C"
