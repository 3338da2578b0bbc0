// Per-element move of scatter2gather.
//
// Shared by the CUDA kernel (scatter2gather.cu) and a host build
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
