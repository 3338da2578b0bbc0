// Per-pixel arithmetic of the fused progressive splat step's backward.
//
// Shared by the CUDA kernels (progressive_splat_bwd.cu) and a host build
// (progressive_splat_bwd_host.cpp) that lets the CPU tests check the index
// math against the plain PyTorch version without a GPU.
//
// In the forward, the splat logit L[t, p] of tap t = dy*k + dx at pixel p
// lands on pixel p + d_t, d_t = (dy - o, dx - o), o = (k-1)/2, with weight
//
//   e[t, p] = exp(L[t, p] - m[p + d_t])          (p + d_t inside the image)
//
// where m is the running max AFTER the update, so the exponent is <= 0.
// The running max is a constant of the backward (the shift cancels in
// sum_r / sum_w). With d_r, d_w the cotangents of the new sums:
//
//   d_data[c, p] = sum_t e[t, p] * d_r[c, p + d_t]
//   d_L[t, p]    = e[t, p] * (d_w[p + d_t] + sum_c data[c, p] * d_r[c, p + d_t])
//
// The first line is the gather form sum_j exp(L[flip j, p] - m[p - d_j])
// * d_r[c, p - d_j] with t = flip j (d_{flip j} = -d_j). A pair (p, p + d_t)
// with p + d_t outside the image contributes nothing: the forward's
// out-of-image gather taps (logit 0) have no logit behind them. Both are
// pure gathers: every L[t, p] is read at the thread's own pixel, the halo
// falls on the small m, d_w and d_r planes, and there are no atomics.

#pragma once

#include "progressive_splat.cuh"

// float32 -> bfloat16 bits, round to nearest even (what a cast does in
// PyTorch and in JAX), the same on the device and on the host.
PSF_HD uint16_t psb_bf16_bits(float v) {
  uint32_t bits;
#ifdef __CUDA_ARCH__
  bits = __float_as_uint(v);
#else
  memcpy(&bits, &v, sizeof(bits));
#endif
  if ((bits & 0x7fffffffu) > 0x7f800000u)  // NaN stays a quiet NaN
    return static_cast<uint16_t>((bits >> 16) | 0x40u);
  bits += 0x7fffu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>(bits >> 16);
}

PSF_HD void psb_store(float* p, int64_t i, float v) { p[i] = v; }
PSF_HD void psb_store(uint16_t* p, int64_t i, float v) {
  p[i] = psb_bf16_bits(v);
}

// d_data at one pixel of one batch item. Pointers are already offset to the
// item: logits holds k*k planes, d_r and d_data C planes, new_max one plane,
// each plane h*w elements.
template <int C, typename T>
PSF_HD void psb_ddata_pixel(const T* logits, const float* new_max,
                            const float* d_r, float* d_data, int h, int w,
                            int k, int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int dy = 0; dy < k; ++dy) {
    const int ty = y + dy - o;
    if (ty < 0 || ty >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int tx = x + dx - o;
      if (tx < 0 || tx >= w) continue;
      const int64_t q = static_cast<int64_t>(ty) * w + tx;
      const int64_t t = static_cast<int64_t>(dy) * k + dx;
      const float e = expf(psf_load(logits, t * hw + p) - new_max[q]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += e * d_r[c * hw + q];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) d_data[c * hw + p] = acc[c];
}

// d_L at one pixel of one batch item, all k*k taps, written in the logits'
// own type. data holds C planes, d_w one plane.
template <int C, typename T>
PSF_HD void psb_dlogits_pixel(const float* data, const T* logits,
                              const float* new_max, const float* d_r,
                              const float* d_w, T* d_logits, int h, int w,
                              int k, int y, int x) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (k - 1) / 2;
  float dat[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dat[c] = data[c * hw + p];

  for (int dy = 0; dy < k; ++dy) {
    const int ty = y + dy - o;
    const bool row_in = ty >= 0 && ty < h;
    for (int dx = 0; dx < k; ++dx) {
      const int tx = x + dx - o;
      const int64_t t = static_cast<int64_t>(dy) * k + dx;
      float g = 0.f;
      if (row_in && tx >= 0 && tx < w) {
        const int64_t q = static_cast<int64_t>(ty) * w + tx;
        float inner = d_w[q];
#pragma unroll
        for (int c = 0; c < C; ++c) inner += dat[c] * d_r[c * hw + q];
        g = expf(psf_load(logits, t * hw + p) - new_max[q]) * inner;
      }
      psb_store(d_logits, t * hw + p, g);
    }
  }
}
