// Native image resampling + canvas padding (host input pipeline fast path;
// the PyTorch port's copy of the JAX package's native/image_ops.cpp).
//
// The C image ops the reference leans on through
// PIL / torchvision (T.Resize inside every dataset, SURVEY.md section 2.9):
// PIL-compatible separable resampling (bicubic a=-0.5 / bilinear, with
// filter support scaled for downscaling exactly like Pillow's
// ImagingResample) from a decoded HxWx3 uint8 buffer straight into the
// fixed 384x640 canvas, multithreaded via OpenMP.
//
// Build: climb_tpu_torch/native/build.py (g++ -O3 -march=native -fopenmp).
// ABI: plain C, consumed via ctypes (climb_tpu_torch/native/__init__.py).
//
// img_set_num_threads sets the OpenMP team size. GNU OpenMP does not survive
// fork(): a child whose parent ran a parallel region waits forever for the
// parent's pool threads in its own first region. The bindings call it with 1
// in every forked child (the loader's process workers), which then resize on
// one thread each.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double bicubic_kernel(double x) {
  // Pillow's bicubic: Catmull-Rom family with a = -0.5, support 2.
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline double bilinear_kernel(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct FilterTable {
  std::vector<float> weights;   // [out, ksize] (float: inner-loop speed)
  std::vector<int> bounds;      // [out, 2] (start, size)
  int ksize = 0;
};

// Pillow-style precomputed coefficients for one axis.
FilterTable build_filter(int in_size, int out_size, double support_base,
                         double (*kernel)(double)) {
  FilterTable ft;
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = support_base * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  ft.ksize = ksize;
  ft.weights.assign((size_t)out_size * ksize, 0.0);
  ft.bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)std::max(0.0, std::floor(center - support));
    int xmax = (int)std::min((double)in_size, std::ceil(center + support));
    float* w = &ft.weights[(size_t)xx * ksize];
    double total = 0.0;
    int n = xmax - xmin;
    for (int x = 0; x < n; ++x) {
      double val = kernel((x + xmin - center + 0.5) / filterscale);
      w[x] = (float)val;
      total += val;
    }
    if (total != 0.0)
      for (int x = 0; x < n; ++x) w[x] = (float)(w[x] / total);
    ft.bounds[xx * 2] = xmin;
    ft.bounds[xx * 2 + 1] = n;
  }
  return ft;
}

inline uint8_t clip8(float v) {
  return (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
}

}  // namespace

extern "C" {

// Resize src (h_in, w_in, 3, uint8) to (h_out, w_out) with PIL-compatible
// separable resampling, writing into the top-left of dst
// (canvas_h, canvas_w, 3, uint8; caller pre-zeroes). filter: 0=bilinear,
// 1=bicubic. Returns 0 on success.
int img_resize_into_canvas(const uint8_t* src, int h_in, int w_in,
                           int h_out, int w_out, uint8_t* dst, int canvas_h,
                           int canvas_w, int filter) {
  if (h_out > canvas_h || w_out > canvas_w || h_in <= 0 || w_in <= 0) return -1;
  double support = filter == 1 ? 2.0 : 1.0;
  double (*kern)(double) = filter == 1 ? bicubic_kernel : bilinear_kernel;

  FilterTable fh = build_filter(w_in, w_out, support, kern);   // horizontal
  FilterTable fv = build_filter(h_in, h_out, support, kern);   // vertical

  // horizontal pass: (h_in, w_in) -> (h_in, w_out), float intermediate
  std::vector<float> tmp((size_t)h_in * w_out * 3);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h_in; ++y) {
    const uint8_t* row = src + (size_t)y * w_in * 3;
    float* out_row = &tmp[(size_t)y * w_out * 3];
    for (int x = 0; x < w_out; ++x) {
      int xmin = fh.bounds[x * 2], n = fh.bounds[x * 2 + 1];
      const float* w = &fh.weights[(size_t)x * fh.ksize];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + (size_t)(xmin + k) * 3;
        acc0 += w[k] * px[0];
        acc1 += w[k] * px[1];
        acc2 += w[k] * px[2];
      }
      out_row[x * 3 + 0] = acc0;
      out_row[x * 3 + 1] = acc1;
      out_row[x * 3 + 2] = acc2;
    }
  }

  // vertical pass: (h_in, w_out) -> (h_out, w_out) into the canvas
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h_out; ++y) {
    int ymin = fv.bounds[y * 2], n = fv.bounds[y * 2 + 1];
    const float* w = &fv.weights[(size_t)y * fv.ksize];
    uint8_t* out_row = dst + (size_t)y * canvas_w * 3;
    for (int x = 0; x < w_out; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < n; ++k) {
        const float* px = &tmp[((size_t)(ymin + k) * w_out + x) * 3];
        acc0 += w[k] * px[0];
        acc1 += w[k] * px[1];
        acc2 += w[k] * px[2];
      }
      out_row[x * 3 + 0] = clip8(acc0);
      out_row[x * 3 + 1] = clip8(acc1);
      out_row[x * 3 + 2] = clip8(acc2);
    }
  }
  return 0;
}

void img_set_num_threads(int n) {
#ifdef _OPENMP
  omp_set_num_threads(n);
#endif
}

}  // extern "C"
