// Per-pixel arithmetic of kernel weighting, of its gradient to the weights
// and of kernel weighting with the softmax exponential fused in.
//
// Shared by the CUDA kernels (kernel_weighting.cu) and a host build
// (kernel_weighting_host.cpp) that lets the CPU tests check the index math
// against the plain PyTorch version without a GPU.
//
// Tap t = dy*k + dx of pixel p = (y, x) looks at pixel p + d_t,
// d_t = (dy - o, dx - o), o = (k-1)/2; data outside the image is 0:
//
//   out[c, p]  = sum_t w[t, p] * data[c, p + d_t]
//   sum_w[p]   = sum_t w[t, p]                (every tap, in or out of bounds)
//   d_w[t, p]  = d_sum_w[p] + sum_c data[c, p + d_t] * d_out[c, p]
//
// and the exp variant weighs with w[t, p] = exp(logits[t, p] - maxes[p]),
// formed in registers (expf in float32, the logits widened first).
//
// Both are gathers: every w[t, p] / d_w[t, p] is touched at the thread's own
// pixel, the halo falls on the C-plane data, and there are no atomics.

#pragma once

#include "progressive_splat.cuh"

// Forward at one pixel of one batch item. Pointers are already offset to the
// item: data/out hold C planes, weights k*k planes, sum_w one plane, each
// plane h*w elements. Weights of either type are widened to float32.
template <int C, typename T>
PSF_HD void kw_fwd_pixel(const float* data, const T* weights, float* out,
                         float* sum_w, int h, int w, int k, int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  float accw = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - o;
    const bool row_in = sy >= 0 && sy < h;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = x + dx - o;
      const int64_t t = static_cast<int64_t>(dy) * k + dx;
      const float wt = psf_load(weights, t * hw + p);
      accw += wt;
      if (row_in && sx >= 0 && sx < w) {
        const int64_t q = static_cast<int64_t>(sy) * w + sx;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += wt * data[c * hw + q];
      }
    }
  }
  sum_w[p] = accw;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * hw + p] = acc[c];
}

// Gradient to the weights at one pixel of one batch item, all k*k taps, in
// float32. data and d_out hold C planes, d_sum_w one plane.
template <int C>
PSF_HD void kw_dw_pixel(const float* data, const float* d_out,
                        const float* d_sum_w, float* d_w, int h, int w, int k,
                        int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  const float dsw = d_sum_w[p];
  float dout[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dout[c] = d_out[c * hw + p];

  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - o;
    const bool row_in = sy >= 0 && sy < h;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = x + dx - o;
      const int64_t t = static_cast<int64_t>(dy) * k + dx;
      float g = dsw;
      if (row_in && sx >= 0 && sx < w) {
        const int64_t q = static_cast<int64_t>(sy) * w + sx;
#pragma unroll
        for (int c = 0; c < C; ++c) g += data[c * hw + q] * dout[c];
      }
      d_w[t * hw + p] = g;
    }
  }
}

// Kernel weighting of exp(logits - maxes) at one pixel of one batch item:
// kw_fwd_pixel with each weight formed in registers as
// expf(float(logits[t, p]) - maxes[p]). Pointers are already offset to the
// item: data/out hold C planes, logits k*k planes, maxes/sum_w one plane.
template <int C, typename T>
PSF_HD void kw_exp_pixel(const float* data, const T* logits,
                         const float* maxes, float* out, float* sum_w, int h,
                         int w, int k, int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  const float m = maxes[p];
  float accw = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - o;
    const bool row_in = sy >= 0 && sy < h;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = x + dx - o;
      const int64_t t = static_cast<int64_t>(dy) * k + dx;
      const float wt = expf(psf_load(logits, t * hw + p) - m);
      accw += wt;
      if (row_in && sx >= 0 && sx < w) {
        const int64_t q = static_cast<int64_t>(sy) * w + sx;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += wt * data[c * hw + q];
      }
    }
  }
  sum_w[p] = accw;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * hw + p] = acc[c];
}
