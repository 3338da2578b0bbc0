// Per-element move of scatter2gather (the generic kernel), the vector
// kernel's work item, and the per-pixel walk of scatter2gather_max.
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

// ---------------------------------------------------------------------------
// The vector kernel of scatter2gather (s2g_vec in scatter2gather.cu). Output
// plane t is input plane K*K-1-t (the flipped tap) shifted by d_t and
// zero-filled, so a work item is V consecutive output elements of one row:
// NB = V * sizeof(T) bytes (2, 4, 8 or 16), w and both tensors' bases
// multiples of NB (ops.s2g_pixels). Its source starts sx = x + dx - o, which
// is r = sx mod V elements past an aligned vector; r is the same for every
// item of a plane. The item loads the two aligned source vectors that cover
// it, each wholly inside or wholly outside the row (w is a multiple of V):
// one outside the row or the image reads as zeros, and no element needs a
// test of its own. A funnel shift by r * sizeof(T) bytes then realigns them.

// NB bytes as 32-bit words (a 2-byte item uses the low half of one word).
template <int NB>
struct S2gBits {
  static constexpr int kWords = NB >= 4 ? NB / 4 : 1;
  uint32_t u[kWords];
};

template <int NB>
PSF_HD void s2g_zero(S2gBits<NB>& b) {
#pragma unroll
  for (int i = 0; i < S2gBits<NB>::kWords; ++i) b.u[i] = 0u;
}

// An aligned load of NB bytes.
template <int NB>
PSF_HD void s2g_load(const void* p, S2gBits<NB>& b) {
#ifdef __CUDA_ARCH__
  if constexpr (NB == 16) {
    const uint4 q = __ldg(static_cast<const uint4*>(p));
    b.u[0] = q.x;
    b.u[1] = q.y;
    b.u[2] = q.z;
    b.u[3] = q.w;
  } else if constexpr (NB == 8) {
    const uint2 q = __ldg(static_cast<const uint2*>(p));
    b.u[0] = q.x;
    b.u[1] = q.y;
  } else if constexpr (NB == 4) {
    b.u[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    b.u[0] = __ldg(static_cast<const unsigned short*>(p));
  }
#else
  b.u[0] = 0u;
  memcpy(b.u, p, NB);
#endif
}

// An aligned streaming store of NB bytes (evict-first: nothing reads the
// output back while the kernel runs).
template <int NB>
PSF_HD void s2g_store(void* p, const S2gBits<NB>& b) {
#ifdef __CUDA_ARCH__
  if constexpr (NB == 16)
    __stcs(static_cast<uint4*>(p), make_uint4(b.u[0], b.u[1], b.u[2], b.u[3]));
  else if constexpr (NB == 8)
    __stcs(static_cast<uint2*>(p), make_uint2(b.u[0], b.u[1]));
  else if constexpr (NB == 4)
    __stcs(static_cast<unsigned int*>(p), b.u[0]);
  else
    __stcs(static_cast<unsigned short*>(p),
           static_cast<unsigned short>(b.u[0]));
#else
  memcpy(p, b.u, NB);
#endif
}

// The low 32 bits of (hi:lo) >> sh, sh in [0, 32): one SHF on the card.
PSF_HD uint32_t s2g_funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return static_cast<uint32_t>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> sh);
#endif
}

// Words WS .. WS + kWords of the concatenation (a, b), shifted right by sh
// bits.
template <int WS, int NB>
PSF_HD void s2g_take(const S2gBits<NB>& a, const S2gBits<NB>& b, int sh,
                     S2gBits<NB>& out) {
  constexpr int kW = S2gBits<NB>::kWords;
  uint32_t c[2 * kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    c[i] = a.u[i];
    c[kW + i] = b.u[i];
  }
#pragma unroll
  for (int i = 0; i < kW; ++i)
    out.u[i] = s2g_funnel(c[WS + i], c[WS + i + 1], sh);
}

// Bytes rb .. rb + NB of the concatenation (a, b), rb a multiple of 2 below
// NB: the vector r = rb / sizeof(T) elements into a. The word offset is a
// branch uniform over a plane (the same r for every item), so the words stay
// in registers.
template <int NB>
PSF_HD void s2g_realign(const S2gBits<NB>& a, const S2gBits<NB>& b, int rb,
                        S2gBits<NB>& out) {
  if constexpr (NB <= 2) {
    out = a;  // one element: never misaligned
  } else {
    const int sh = (rb & 3) * 8;
    switch (rb >> 2) {
      case 0:
        s2g_take<0>(a, b, sh, out);
        break;
      case 1:
        if constexpr (NB > 4) s2g_take<1>(a, b, sh, out);
        break;
      case 2:
        if constexpr (NB > 8) s2g_take<2>(a, b, sh, out);
        break;
      default:
        if constexpr (NB > 8) s2g_take<3>(a, b, sh, out);
        break;
    }
  }
}

// One work item: output elements e .. e + V - 1 of one plane (e a multiple
// of V; row y = e / w, column x = e % w; h * w below 2^31). src is the
// item's source plane (K*K-1-t of the batch item); sy_off = dy - o and
// sx_off = dx - o are the plane's shift, r = sx_off mod V (in [0, V)).
template <typename T, int V>
PSF_HD void s2g_vec_item(const T* src, int h, int w, int e, int sy_off,
                         int sx_off, int r,
                         S2gBits<V * static_cast<int>(sizeof(T))>& out) {
  constexpr int NB = V * static_cast<int>(sizeof(T));
  const int y = e / w;  // a plane has fewer than 2^31 elements
  const int x = e - y * w;
  const int sy = y + sy_off;
  const int a = x + sx_off - r;  // aligned start of the first source vector
  const bool row_in = sy >= 0 && sy < h;
  const T* row = src + static_cast<int64_t>(sy) * w;
  S2gBits<NB> lo, hi;
  s2g_zero(lo);
  s2g_zero(hi);
  if (row_in && a >= 0 && a < w) s2g_load(row + a, lo);
  if (r != 0 && row_in && a + V >= 0 && a + V < w) s2g_load(row + a + V, hi);
  s2g_realign(lo, hi, r * static_cast<int>(sizeof(T)), out);
}

// Output plane t of K*K: its source plane K*K-1-t (the flipped tap), its
// shift (dy - o, dx - o) and r = (dx - o) mod V.
struct S2gPlane {
  int src, sy_off, sx_off, r;
};

template <int K, int V>
PSF_HD S2gPlane s2g_plane(int t) {
  constexpr int kO = (K - 1) / 2;
  const int dy = t / K, dx = t % K;
  return {K * K - 1 - t, dy - kO, dx - kO, ((dx - kO) % V + V) % V};
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
