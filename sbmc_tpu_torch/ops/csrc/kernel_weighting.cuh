// Arithmetic of kernel weighting, of its gradient to the weights and of
// kernel weighting with the softmax exponential fused in: the per-pixel
// functions of the generic kernels and the work items of the tiled ones.
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
#include "progressive_splat_bwd.cuh"  // psb_bf16_bits, psb_store

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

// ---------------------------------------------------------------------------
// The tiled kernels (kw_fwd and kw_dw in kernel_weighting.cu). A work item is
// V consecutive pixels of one row (the forward's V is 2 where the weight rows
// allow 2-pixel loads, else 1; the gradient's V is 4, 2 or 1 by the same
// rule for its stores) and the K taps of one tap row dy. The data of a tap row
// comes from a halo accessor: halo.get(dy, s, d) fills d[C] with
// data[., y + dy - o, x - o + s] for the item's first pixel (y, x) and
// s = 0 .. K + V - 2, 0 outside the image. The kernel reads it from the data
// tile it staged in shared memory, the host build from the planes.

// V weights of one tap at the item's pixels, widened to float32: one 8-byte
// (float32) or 4-byte (bfloat16) load where V = 2.
PSF_HD void kw_load(const float* p, float (&v)[1]) { v[0] = p[0]; }

PSF_HD void kw_load(const uint16_t* p, float (&v)[1]) {
  v[0] = psf_load(p, 0);
}

PSF_HD void kw_load(const float* p, float (&v)[2]) {
#ifdef __CUDA_ARCH__
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
#else
  v[0] = p[0];
  v[1] = p[1];
#endif
}

PSF_HD void kw_load(const uint16_t* p, float (&v)[2]) {
#ifdef __CUDA_ARCH__
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(u << 16);  // little-endian: the low half comes first
  v[1] = __uint_as_float(u & 0xffff0000u);
#else
  v[0] = psf_load(p, 0);
  v[1] = psf_load(p, 1);
#endif
}

// V values of one plane at the item's pixels, in the plane's type (bfloat16
// rounded to nearest even): on the card one 4-, 8- or 16-byte streaming
// store (st.global.cs, evict-first: nothing reads the planes back while the
// kernel runs, and on the card it took the k^2-plane gradient 3-4% closer
// to its bound than plain stores).
PSF_HD void kw_store(float* p, const float (&v)[1]) {
#ifdef __CUDA_ARCH__
  __stcs(p, v[0]);
#else
  p[0] = v[0];
#endif
}

PSF_HD void kw_store(uint16_t* p, const float (&v)[1]) {
#ifdef __CUDA_ARCH__
  __stcs(p, psb_bf16_bits(v[0]));
#else
  p[0] = psb_bf16_bits(v[0]);
#endif
}

PSF_HD uint32_t kw_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(psb_bf16_bits(lo)) |
         (static_cast<uint32_t>(psb_bf16_bits(hi)) << 16);
}

PSF_HD void kw_store(float* p, const float (&v)[2]) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
#else
  p[0] = v[0];
  p[1] = v[1];
#endif
}

PSF_HD void kw_store(uint16_t* p, const float (&v)[2]) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<uint32_t*>(p), kw_bf16x2(v[0], v[1]));
#else
  p[0] = psb_bf16_bits(v[0]);
  p[1] = psb_bf16_bits(v[1]);
#endif
}

PSF_HD void kw_store(float* p, const float (&v)[4]) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
#else
  for (int j = 0; j < 4; ++j) p[j] = v[j];
#endif
}

PSF_HD void kw_store(uint16_t* p, const float (&v)[4]) {
#ifdef __CUDA_ARCH__
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(kw_bf16x2(v[0], v[1]), kw_bf16x2(v[2], v[3])));
#else
  for (int j = 0; j < 4; ++j) p[j] = psb_bf16_bits(v[j]);
#endif
}

// The forward's partial sums at the item's V pixels.
template <int C, int V>
struct KwAcc {
  float r[V][C];
  float w[V];
};

template <int C, int V>
PSF_HD void kw_zero(KwAcc<C, V>& a) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a.w[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) a.r[j][c] = 0.f;
  }
}

// a += b: joins the partial sums of the groups of tap rows, in group order.
template <int C, int V>
PSF_HD void kw_merge(KwAcc<C, V>& a, const KwAcc<C, V>& b) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a.w[j] += b.w[j];
#pragma unroll
    for (int c = 0; c < C; ++c) a.r[j][c] += b.r[j][c];
  }
}

// The forward's tap row dy of one work item, added to a in tap order. w
// points at the item's first pixel in tap plane dy * K. The row's K weight
// loads are issued first, all in flight at once; then each data column s
// serves the taps dx = s - j of the V pixels.
template <int C, int K, int V, typename T, typename Halo>
PSF_HD void kw_fwd_row(const T* w, int64_t hw, int dy, const Halo& halo,
                       KwAcc<C, V>& a) {
  float wt[K][V];
#pragma unroll
  for (int dx = 0; dx < K; ++dx) kw_load(w + dx * hw, wt[dx]);
#pragma unroll
  for (int s = 0; s < K + V - 1; ++s) {
    float d[C];
    halo.get(dy, s, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int dx = s - j;
      if (dx < 0 || dx >= K) continue;
      a.w[j] += wt[dx][j];
#pragma unroll
      for (int c = 0; c < C; ++c) a.r[j][c] += wt[dx][j] * d[c];
    }
  }
}

// The forward's partial sums of group g of G: the tap rows g, g + G, ... in
// order. w points at the item's first pixel in tap plane 0.
template <int C, int K, int V, typename T, typename Halo>
PSF_HD KwAcc<C, V> kw_fwd_group(const T* w, int64_t hw, int g, int groups,
                                const Halo& halo) {
  KwAcc<C, V> a;
  kw_zero(a);
  for (int dy = g; dy < K; dy += groups)
    kw_fwd_row<C, K, V>(w + static_cast<int64_t>(dy) * K * hw, hw, dy, halo,
                        a);
  return a;
}

// The weight gradient of group g of G at one work item: the tap rows g,
// g + G, ... . dout[j][c] = d_out[c, p + j], dsw[j] = d_sum_w[p + j]; dw
// points at the item's first pixel in gradient plane 0, of the weights'
// type. Each value is float32 dsw + sum_c data * dout, rounded once on the
// store; a tap's V values go out as soon as its last data column is in.
template <int C, int K, int V, typename T, typename Halo>
PSF_HD void kw_dw_group(const float (&dout)[V][C], const float (&dsw)[V],
                        T* dw, int64_t hw, int g, int groups,
                        const Halo& halo) {
  for (int dy = g; dy < K; dy += groups) {
    T* row = dw + static_cast<int64_t>(dy) * K * hw;
    float acc[K][V];
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[dx][j] = dsw[j];
#pragma unroll
    for (int s = 0; s < K + V - 1; ++s) {
      float d[C];
      halo.get(dy, s, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int dx = s - j;
        if (dx < 0 || dx >= K) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[dx][j] += d[c] * dout[j][c];
      }
      if (s >= V - 1) kw_store(row + (s - (V - 1)) * hw, acc[s - (V - 1)]);
    }
  }
}
