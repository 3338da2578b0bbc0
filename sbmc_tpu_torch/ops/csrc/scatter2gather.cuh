// Per-element move of scatter2gather, and the per-pixel walk of
// scatter2gather_max.
//
// Shared by the CUDA kernels (scatter2gather.cu) and a host build
// (scatter2gather_host.cpp) that lets the CPU tests check the index math
// against the plain PyTorch version without a GPU.
//
// The splat weight of tap (dy', dx') at pixel q lands on pixel q + d' as
// the gather weight of the flipped tap. Read from the output's side, for
// gather tap t = dy*k + dx at pixel p = (y, x), d = (dy - o, dx - o),
// o = (k-1)/2:
//
//   out[dy*k + dx, p] = w[(k-1-dy)*k + (k-1-dx), p + d]  (0 outside the image)
//
// The op only moves values, so it is written on the element's bits: T is
// float for float32 and uint16_t for bfloat16 (an all-zero pattern is +0 in
// both), and the result is exact in either type.

#pragma once

#include "progressive_splat.cuh"

// One output element of one batch item. Pointers are already offset to the
// item: both hold k*k planes of h*w elements.
template <typename T>
PSF_HD void s2g_element(const T* weights, T* out, int h, int w, int k, int t,
                        int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int o = (k - 1) / 2;
  const int dy = t / k;
  const int dx = t - dy * k;
  const int sy = y + dy - o;
  const int sx = x + dx - o;
  T v = T(0);
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    const int64_t flip = static_cast<int64_t>(k - 1 - dy) * k + (k - 1 - dx);
    v = weights[flip * hw + static_cast<int64_t>(sy) * w + sx];
  }
  out[t * hw + static_cast<int64_t>(y) * w + x] = v;
}

// The value of a float32 or bfloat16 element as a float (bfloat16 is the top
// half of a float32).
PSF_HD float s2g_widen(float v) { return v; }
PSF_HD float s2g_widen(uint16_t v) { return psf_load(&v, 0); }

// scatter2gather_max at one pixel of one batch item: all k*k output taps of
// pixel p, moved as above, and kmax[p] = max_t float(out[t, p]). The max
// starts at -inf and takes every written value, the zeros of the taps that
// fall outside the image included; a NaN tap makes it NaN. Pointers are
// already offset to the item: weights/out hold k*k planes, kmax one plane.
template <typename T>
PSF_HD void s2g_max_pixel(const T* weights, T* out, float* kmax, int h, int w,
                          int k, int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  float m = -INFINITY;
  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - o;
    const bool row_in = sy >= 0 && sy < h;
    // Flipped source row of taps: plane (k-1-dy)*k + (k-1-dx).
    const int64_t plane_row = static_cast<int64_t>(k - 1 - dy) * k + (k - 1);
    for (int dx = 0; dx < k; ++dx) {
      const int sx = x + dx - o;
      T v = T(0);
      if (row_in && sx >= 0 && sx < w)
        v = weights[(plane_row - dx) * hw + static_cast<int64_t>(sy) * w + sx];
      out[(static_cast<int64_t>(dy) * k + dx) * hw + p] = v;
      const float f = s2g_widen(v);
      if (f > m || f != f) m = f;
    }
  }
  kmax[p] = m;
}
