// Arithmetic of the fused progressive splat step's backward.
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

// ---------------------------------------------------------------------------
// The vector kernel of d_L (psb_dlogits_vec in progressive_splat_bwd.cu):
// one work item is V = 16 / sizeof(T) consecutive pixels of one row and the
// k taps of one tap row dy, each tap one 16-byte load of L and one 16-byte
// store of d_L at the item's own pixels. exp is psf_exp (exp2 of the
// log2(e)-scaled argument, progressive_splat.cuh).

// 16 bytes of logits widened to float: 4 float32 or 8 bfloat16.
PSF_HD void psb_load_vec(const float* p, float (&v)[4]) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

PSF_HD void psb_load_vec(const uint16_t* p, float (&v)[8]) {
#ifdef __CUDA_ARCH__
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the low half comes first
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
#else
  for (int i = 0; i < 8; ++i) v[i] = psf_load(p, i);
#endif
}

// 16 bytes of gradient in the logits' type (bf16 rounded to nearest even).
PSF_HD void psb_store_vec(float* p, const float (&v)[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

PSF_HD void psb_store_vec(uint16_t* p, const float (&v)[8]) {
#ifdef __CUDA_ARCH__
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = static_cast<uint32_t>(psb_bf16_bits(v[2 * i])) |
           (static_cast<uint32_t>(psb_bf16_bits(v[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
#else
  for (int i = 0; i < 8; ++i) psb_store(p, i, v[i]);
#endif
}

// One work item: pixels p .. p + V - 1 of one batch item (pointers offset to
// the item, logits and d_logits k*k planes of hw elements), tap row dy.
// dat[j][c] is data[c, p + j]. small.get(col, m, a) gives, at the pixel
// (y + dy - o, x - o + col) of the item's row y and first column x, the
// running max m and a = (d_w, d_r[0..C-1]); outside the image m = +inf and
// a = 0, so that tap's gradient is exp(-inf) * 0 = 0.
template <int C, int K, int V, typename T, typename Small>
PSF_HD void psb_dlogits_row(const float (&dat)[V][C], const T* logits,
                            T* d_logits, int64_t hw, int64_t p, int dy,
                            const Small& small) {
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    const int64_t off = static_cast<int64_t>(dy * K + dx) * hw + p;
    float l[V];
    psb_load_vec(logits + off, l);
    float g[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float m;
      float a[C + 1];
      small.get(dx + j, m, a);
      float inner = a[0];
#pragma unroll
      for (int c = 0; c < C; ++c) inner += dat[j][c] * a[c + 1];
      g[j] = psf_exp(l[j] - m) * inner;
    }
    psb_store_vec(d_logits + off, g);
  }
}

// ---------------------------------------------------------------------------
// The vector kernel of d_data (psb_ddata_vec in progressive_splat_bwd.cu): a
// work item is V = 16 / sizeof(T) consecutive pixels of one row, as in the
// vector kernel of d_L, and the k taps of one tap row dy; d_data sums over
// the taps, so the item keeps C x V float32 sums. The tap row's k 16-byte
// loads of L are issued first, all in flight at once; then each of the
// V + k - 1 halo columns s of the row serves the taps dx = s - j of the V
// pixels j, so the small planes are read V + k - 1 times a row instead of
// V * k. exp(L - m) is taken as exp2(L * log2(e) - m2) with m2 = m * log2(e)
// formed once per halo pixel: one FMA and one exp2 per tap (psf_exp's form,
// with the product folded into the FMA).

// m * log2(e), the running max as the kernel stages it (+inf stays +inf, so
// a tap whose target lies outside the image weighs exp2(-inf) = 0).
PSF_HD float psb_m2(float m) { return m * kPsfLog2e; }

// 16 bytes of logits as four raw words.
PSF_HD void psb_load_raw(const void* p, uint32_t (&u)[4]) {
#ifdef __CUDA_ARCH__
  const uint4 q = __ldg(static_cast<const uint4*>(p));
  u[0] = q.x;
  u[1] = q.y;
  u[2] = q.z;
  u[3] = q.w;
#else
  memcpy(u, p, 16);
#endif
}

PSF_HD float psb_bits_float(uint32_t bits) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof(f));
  return f;
#endif
}

// Logit j of the 16 raw bytes, widened to float (bfloat16: the low half of
// a word comes first, little-endian).
PSF_HD float psb_widen(const uint32_t (&u)[4], int j, float) {
  return psb_bits_float(u[j]);
}
PSF_HD float psb_widen(const uint32_t (&u)[4], int j, uint16_t) {
  const uint32_t word = u[j >> 1];
  return psb_bits_float((j & 1) ? (word & 0xffff0000u) : (word << 16));
}

template <int C, int V>
PSF_HD void psb_ddata_zero(float (&acc)[V][C]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
}

// a += b: joins the partial sums of the groups of tap rows, in group order.
template <int C, int V>
PSF_HD void psb_ddata_merge(float (&a)[V][C], const float (&b)[V][C]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) a[j][c] += b[j][c];
}

// Tap row dy of one work item, added to acc. l points at the item's first
// pixel in tap plane dy * K (planes hw elements apart). small.get(dy, s, m2,
// d) gives, at the pixel (y + dy - o, x - o + s) of the item's row y and
// first column x, m2 = psb_m2(m) and d[C] = d_r: +inf and zeros outside the
// image.
template <int C, int K, int V, typename T, typename Small>
PSF_HD void psb_ddata_row(const T* l, int64_t hw, int dy, const Small& small,
                          float (&acc)[V][C]) {
  uint32_t raw[K][4];
#pragma unroll
  for (int dx = 0; dx < K; ++dx) psb_load_raw(l + dx * hw, raw[dx]);
#pragma unroll
  for (int s = 0; s < K + V - 1; ++s) {
    float m2;
    float d[C];
    small.get(dy, s, m2, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int dx = s - j;
      if (dx < 0 || dx >= K) continue;
      const float e = exp2f(fmaf(psb_widen(raw[dx], j, T()), kPsfLog2e, -m2));
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = fmaf(e, d[c], acc[j][c]);
    }
  }
}

// The partial sums of group g of G at one work item: the tap rows g,
// g + G, ... in order. l0 points at the item's first pixel in tap plane 0.
template <int C, int K, int V, typename T, typename Small>
PSF_HD void psb_ddata_group(const T* l0, int64_t hw, int g, int groups,
                            const Small& small, float (&acc)[V][C]) {
  psb_ddata_zero(acc);
  for (int dy = g; dy < K; dy += groups)
    psb_ddata_row<C, K, V>(l0 + static_cast<int64_t>(dy) * K * hw, hw, dy,
                           small, acc);
}

// d_data of one work item, channel c at d + c * hw: V float32 values, one
// (float32 logits) or two (bfloat16) 16-byte streaming stores on the card.
template <int C, int V>
PSF_HD void psb_ddata_store(float* d, int64_t hw, const float (&acc)[V][C]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j0 = 0; j0 < V; j0 += 4) {
      float* p = d + c * hw + j0;
#ifdef __CUDA_ARCH__
      __stcs(reinterpret_cast<float4*>(p),
             make_float4(acc[j0][c], acc[j0 + 1][c], acc[j0 + 2][c],
                         acc[j0 + 3][c]));
#else
      for (int j = 0; j < 4; ++j) p[j] = acc[j0 + j][c];
#endif
    }
}
