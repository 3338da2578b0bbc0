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
// tensor. The online softmax keeps a running max m per pixel; the generic
// kernel rescales the accumulators by exp(m_old - m_new) at each tap that
// raises m, the tiled kernel once per row of k taps, so every logit is read
// once. Data outside the image is 0, so such a tap adds exp(0 - m) to sum_w
// and nothing to sum_r (the zero-padded transpose).

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

// ---------------------------------------------------------------------------
// Row-wise online softmax of the tiled kernel (psf_tma in
// progressive_splat.cu), as __host__ __device__ pieces the host build runs
// too.
//
// The tiled kernel takes exp(x) as exp2(x * log2(e)): exp2f is one MUFU.EX2
// on the card plus a range fixup, where expf adds a range reduction. The
// extra rounding of the product is about |x| * 2^-24 relative, far inside
// the kernels' tolerance (2e-5 relative).
constexpr float kPsfLog2e = 1.4426950408889634f;

PSF_HD float psf_exp(float x) { return exp2f(x * kPsfLog2e); }

// A partial online-softmax state of one pixel: the running max m, and
// sum_w and sum_r both scaled by exp(-m).
template <int C>
struct PsfState {
  float m;
  float w;
  float r[C];
};

// An empty state at max m (the kernel starts every pixel at the old max).
template <int C>
PSF_HD PsfState<C> psf_state_at(float m) {
  PsfState<C> s;
  s.m = m;
  s.w = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s.r[c] = 0.f;
  return s;
}

// a <- a (+) b: both taken to the larger max, each scaled by exp(m_i - m).
// It joins the old state with the new taps.
template <int C>
PSF_HD void psf_merge(PsfState<C>& a, const PsfState<C>& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = psf_exp(a.m - m);
  const float fb = psf_exp(b.m - m);
  a.m = m;
  a.w = a.w * fa + b.w * fb;
#pragma unroll
  for (int c = 0; c < C; ++c) a.r[c] = a.r[c] * fa + b.r[c] * fb;
}

// One row of K gather taps (dx = 0..K-1) into s: the row's max first, one
// rescale of the accumulators to it (one exp, taken whether or not the max
// moved: no data-dependent branch), then K exps and FMAs. v[dx] is the
// tap's logit, dat.get(dx, d) fills d[C] with the data at the tap's source
// pixel (0 outside the image, where v[dx] is 0 too).
template <int C, int K, typename Data>
PSF_HD void psf_row_update(PsfState<C>& s, const float (&v)[K],
                           const Data& dat) {
  float rm = v[0];
#pragma unroll
  for (int dx = 1; dx < K; ++dx) rm = fmaxf(rm, v[dx]);
  const float m = fmaxf(s.m, rm);
  const float f = psf_exp(s.m - m);
  s.m = m;
  s.w *= f;
#pragma unroll
  for (int c = 0; c < C; ++c) s.r[c] *= f;
#pragma unroll
  for (int dx = 0; dx < K; ++dx) {
    const float e = psf_exp(v[dx] - m);
    float d[C];
    dat.get(dx, d);
    s.w += e;
#pragma unroll
    for (int c = 0; c < C; ++c) s.r[c] += e * d[c];
  }
}

// ---------------------------------------------------------------------------
// The tiled kernel's TMA boxes (psf_tma). Tap (dy, dx) of the tile at
// (y0, x0) is one box of logits plane (K-1-dy)*K + (K-1-dx), TH rows of
// kBoxW = 32 + kAlign columns (kAlign elements: 16 bytes), starting at row
// psf_clamp(y0 + dy - o, h) and column psf_box_x(x0 + dx - o, w): TMA takes
// only a box that starts inside the tensor on a 16-byte column. It fills
// what runs past the image's right or bottom edge with zeros.

// A box start clamped into [0, n - 1].
PSF_HD int psf_clamp(int v, int n) {
#ifdef __CUDA_ARCH__
  return min(max(v, 0), n - 1);
#else
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
#endif
}

// The column a box for source column gx starts at: clamped into the row,
// then down to a 16-byte boundary. w is a multiple of kAlign, so the start
// stays in the row.
template <int kAlign>
PSF_HD int psf_box_x(int gx, int w) {
  return psf_clamp(gx, w) & ~(kAlign - 1);
}

// ---------------------------------------------------------------------------
// One pixel of one batch item, the per-tap loop of the generic kernel
// (psf_generic). Pointers are already offset to the item:
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
