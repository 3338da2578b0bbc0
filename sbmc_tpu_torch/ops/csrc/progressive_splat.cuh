// Per-pixel arithmetic of the fused progressive splat step.
//
// Shared by the CUDA kernel (progressive_splat.cu) and a host build
// (progressive_splat_host.cpp) that lets the CPU tests check the index
// math against the plain PyTorch version without a GPU.
//
// For output pixel p = (y, x) and gather tap (dy, dx) with d = (dy-o, dx-o),
// o = (k-1)/2, the gather logit is the splat logit of the flipped tap read
// at the shifted pixel:
//
//   g[dy*k+dx, p] = L[(k-1-dy)*k + (k-1-dx), p + d]     (0 outside the image)
//
// which is scatter2gather without materialising the k^2-plane transposed
// tensor. The online softmax keeps a running max m per pixel; a tap that
// raises m rescales the accumulators by exp(m_old - m_new) first, so every
// logit is read once. Data outside the image is 0, so such a tap adds
// exp(0 - m) to sum_w and nothing to sum_r (the zero-padded transpose).

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PSF_HD __host__ __device__ __forceinline__
#else
#define PSF_HD inline
#endif

PSF_HD float psf_load(const float* p, int64_t i) { return p[i]; }

// bfloat16 is the top half of a float32: widening is a shift.
PSF_HD float psf_load(const uint16_t* p, int64_t i) {
  const uint32_t bits = static_cast<uint32_t>(p[i]) << 16;
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof(f));
  return f;
#endif
}

// One pixel of one batch item. Pointers are already offset to the item:
// data/sum_r/out_r hold C planes, logits k*k planes, the rest one plane,
// each plane h*w elements.
template <int C, typename T>
PSF_HD void psf_pixel(const float* data, const T* logits, const float* sum_r,
                      const float* sum_w, const float* max_w, float* out_r,
                      float* out_w, float* out_m, int h, int w, int k, int y,
                      int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  const float m0 = max_w[p];
  float m = m0;
  float accw = 0.f;
  float accr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) accr[c] = 0.f;

  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - o;
    const bool row_in = sy >= 0 && sy < h;
    // Flipped source row of taps: plane (k-1-dy)*k + (k-1-dx).
    const int64_t plane_row = static_cast<int64_t>(k - 1 - dy) * k + (k - 1);
    for (int dx = 0; dx < k; ++dx) {
      const int sx = x + dx - o;
      const bool in = row_in && sx >= 0 && sx < w;
      const int64_t q = static_cast<int64_t>(sy) * w + sx;
      const float v = in ? psf_load(logits, (plane_row - dx) * hw + q) : 0.f;
      if (v > m) {
        const float s = expf(m - v);
        accw *= s;
#pragma unroll
        for (int c = 0; c < C; ++c) accr[c] *= s;
        m = v;
      }
      const float e = expf(v - m);
      accw += e;
      if (in) {
#pragma unroll
        for (int c = 0; c < C; ++c) accr[c] += e * data[c * hw + q];
      }
    }
  }

  const float s = expf(m0 - m);
  out_m[p] = m;
  out_w[p] = sum_w[p] * s + accw;
#pragma unroll
  for (int c = 0; c < C; ++c)
    out_r[c * hw + p] = sum_r[c * hw + p] * s + accr[c];
}
