// Ray x triangle hit test of the wavefront renderer, per ray and triangle.
//
// Shared by the CUDA kernels (trace_hits.cu) and a host build
// (trace_hits_host.cpp) that lets the CPU tests hold it against the plain
// PyTorch version and the JAX renderer without a GPU.
//
// The test is sbmc_tpu/render/pathtracer.py _tri_ts: a plane plus dual-basis
// barycentric form of Moeller-Trumbore. Per triangle, with n = e1 x e2 and
// the dual basis g1 = (e2 x n) / |n|^2, g2 = (n x e1) / |n|^2, the caller
// packs 16 floats (kTriStride):
//
//   [0:3] n   [3:6] g1   [6:9] g2   [9] cn = n.v0   [10] c1 = g1.v0
//   [11] c2 = g2.v0   [12] mn = n.m   [13] m1 = g1.m   [14] m2 = g2.m
//
// (m the triangle's motion over the shutter), and a ray (o, d) at time tt
// hits at
//
//   den = d.n,  t = (cn + tt mn - o.n) / den,
//   u = o.g1 - c1 - tt m1 + t d.g1,  v = o.g2 - c2 - tt m2 + t d.g2
//
// when |den| > 1e-9, u >= 0, v >= 0, u + v <= 1 and t > 1e-3; otherwise
// the distance is kTriMiss (the JAX package's _INF). den > 0 on a hit is a
// back face: the ray is inside the closed mesh. The dot products are summed
// x, y, z in that order, as the plain version sums them; nvcc may contract
// them into fused multiply-adds, which moves t by an ulp or so.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define TH_HD __host__ __device__ __forceinline__
#else
#define TH_HD inline
#endif

constexpr int kTriStride = 16;
constexpr float kTriMiss = 1e10f;

struct ThRay {
  float ox, oy, oz, dx, dy, dz, tt;
};

// The terms of one ray x triangle test that precede the division:
// t = num / den, u = a1 + t dg1, v = a2 + t dg2.
struct ThTerms {
  float num, den, a1, a2, dg1, dg2;
};

// The terms at the ray's time, each summed as th_hit always summed it:
// num = (cn + tt mn) - o.n, a1 = (o.g1 - c1) - tt m1, a2 likewise.
TH_HD ThTerms th_terms(const float* c, const ThRay& r) {
  const float o_n = r.ox * c[0] + r.oy * c[1] + r.oz * c[2];
  const float o_g1 = r.ox * c[3] + r.oy * c[4] + r.oz * c[5];
  const float o_g2 = r.ox * c[6] + r.oy * c[7] + r.oz * c[8];
  return ThTerms{c[9] + r.tt * c[12] - o_n,
                 r.dx * c[0] + r.dy * c[1] + r.dz * c[2],
                 o_g1 - c[10] - r.tt * c[13],
                 o_g2 - c[11] - r.tt * c[14],
                 r.dx * c[3] + r.dy * c[4] + r.dz * c[5],
                 r.dx * c[6] + r.dy * c[7] + r.dz * c[8]};
}

// The terms at time 0 (shadow rays), without the motion products: with tt
// = 0 they add only a signed zero, which can change the sign of a zero
// num, a1 or a2 and nothing else, and a zero num gives t = +-0, a miss,
// while u >= 0, v >= 0 and u + v <= 1 take either zero alike. So the
// test's results are th_terms' at tt = 0, bit for bit (the CPU tests hold
// them so, moving meshes included).
TH_HD ThTerms th_terms_static(const float* c, const ThRay& r) {
  const float o_n = r.ox * c[0] + r.oy * c[1] + r.oz * c[2];
  const float o_g1 = r.ox * c[3] + r.oy * c[4] + r.oz * c[5];
  const float o_g2 = r.ox * c[6] + r.oy * c[7] + r.oz * c[8];
  return ThTerms{c[9] - o_n, r.dx * c[0] + r.dy * c[1] + r.dz * c[2],
                 o_g1 - c[10], o_g2 - c[11],
                 r.dx * c[3] + r.dy * c[4] + r.dz * c[5],
                 r.dx * c[6] + r.dy * c[7] + r.dz * c[8]};
}

// The exact test on the terms: the IEEE division, then the barycentric and
// distance tests. Distance (kTriMiss on a miss); back: a back-face hit.
TH_HD float th_finish(const ThTerms& k, bool& back) {
  const bool valid = fabsf(k.den) > 1e-9f;
  const float t = k.num / (valid ? k.den : 1.0f);
  const float u = k.a1 + t * k.dg1;
  const float v = k.a2 + t * k.dg2;
  const bool ok = valid && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 1e-3f;
  back = ok && k.den > 0.f;
  return ok ? t : kTriMiss;
}

// Distance to packed triangle c along the ray (kTriMiss on a miss); sets
// back to whether a hit is on the back face. The generic kernels' test;
// th_terms then th_finish is the same arithmetic in the same order.
TH_HD float th_hit(const float* c, const ThRay& r, bool& back) {
  const float o_n = r.ox * c[0] + r.oy * c[1] + r.oz * c[2];
  const float o_g1 = r.ox * c[3] + r.oy * c[4] + r.oz * c[5];
  const float o_g2 = r.ox * c[6] + r.oy * c[7] + r.oz * c[8];
  const float den = r.dx * c[0] + r.dy * c[1] + r.dz * c[2];
  const float d_g1 = r.dx * c[3] + r.dy * c[4] + r.dz * c[5];
  const float d_g2 = r.dx * c[6] + r.dy * c[7] + r.dz * c[8];
  const bool valid = fabsf(den) > 1e-9f;
  const float t = (c[9] + r.tt * c[12] - o_n) / (valid ? den : 1.0f);
  const float u = o_g1 - c[10] - r.tt * c[13] + t * d_g1;
  const float v = o_g2 - c[11] - r.tt * c[14] + t * d_g2;
  const bool ok = valid && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 1e-3f;
  back = ok && den > 0.f;
  return ok ? t : kTriMiss;
}

// Nearest-hit state of one ray: the smallest distance so far, the first
// triangle that reached it (jnp.argmin's tie rule) and its back-face flag.
struct ThNearest {
  float t = kTriMiss;
  int idx = 0;
  bool back = false;
  TH_HD void visit(const float* c, const ThRay& r, int i) {
    bool b;
    const float d = th_hit(c, r, b);
    if (d < t) {
      t = d;
      idx = i;
      back = b;
    }
  }
};

// Whether the triangle occludes a shadow ray whose light lies at dist:
// pathtracer._occluded's ts < dist - 1e-3 (lim = dist - 1e-3f).
TH_HD bool th_blocks(const float* c, const ThRay& r, float lim) {
  bool b;
  return th_hit(c, r, b) < lim;
}

// ---------------------------------------------------------------------------
// The tiled kernels' loop: a division-free filter on every pair, the exact
// test (th_finish, the IEEE arithmetic above) on the pairs that pass.
//
// The filter takes an approximate t~ = num * rcp(den) from the hardware
// reciprocal (rcp.approx.ftz.f32: within 1 ulp of 1/den where den and its
// reciprocal are normal floats, PTX ISA; a subnormal den, |den| < 1e-9 and
// never valid, flushes to 0) and forms u~, v~ from it as th_finish forms
// u, v from t. With eps = 2^-24 and the reciprocal within 3 eps (1.5 ulp:
// the host build's model below errs more than the hardware), |t - t~| <=
// 5.02 eps |t~| (two more roundings), so u and u~ differ by at most
// (5.02 + 4.03) eps |t~ dg1| + 4.02 eps |a1| and the underflow of a few
// operations (< 2^-140; each computed with or without a fused
// multiply-add), where |t~ dg1| <= (|u~| + |a1|)(1 + 3 eps); v alike. With
// K = kFilterK = 2^-15 (> 50 times those relative bounds) and the margin
// m = K (|a1| + |a2| + 1) the filter drops a pair only where
//   u~ < -m                  => u < 0,
//   v~ < -m                  => v < 0,
//   u~, v~ >= -m and u~ + v~ > 1 + m  => u + v > 1 + 2e-5 (> 1 rounded),
//   !(t~ >= 1e-3 (1 - K))    => t < 1e-3, or a NaN t~ (NaN terms, or den
//                               0, infinite or subnormal: each a miss),
//   t~ > t_max = hi (1 + K)  => t > hi,
// so th_finish would give kTriMiss or a distance >= hi: the pair cannot
// change a nearest hit below hi or block a shadow ray at hi. NaN u~, v~
// drop nothing. Where |den| >= 2^126 (a reciprocal below the normal range)
// nothing is dropped. The distances, indices and flags that come out are
// th_finish's, decided by the same arithmetic as th_hit's.
//
// A triangle that does not move (mn = m1 = m2 = 0, marked by th_mark_static
// in the unused 16th word) is tested with th_terms_static at any time: the
// motion products tt * 0 add a signed zero only (see th_terms_static). A
// ray whose time is not finite misses every triangle in th_hit (a NaN or
// infinite num, a1 or a2 fails a test), so th_tiled_ray gives it a NaN
// origin, with which every term it meets is NaN and th_finish misses too.

#ifndef TH_FILTER_K
#define TH_FILTER_K (1.0f / 32768.0f)
#endif
constexpr float kFilterK = TH_FILTER_K;
constexpr float kFilterTLo = 1e-3f * (1.0f - kFilterK);
constexpr float kFilterDenMax = 8.50705917e37f;  // 2^126

// rcp.approx.ftz.f32 on the card; on the host, the correctly rounded
// reciprocal moved one ulp up or down (by the low bit of x), a model that
// errs more than the hardware.
TH_HD float th_rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  uint32_t bits;
  memcpy(&bits, &x, sizeof bits);
  return nextafterf(1.0f / x, (bits & 1u) ? INFINITY : -INFINITY);
#endif
}

// The filter's bound for a nearest hit or blocker below hi.
TH_HD float th_widen(float hi) { return hi * (1.0f + kFilterK); }

// False only where th_finish(k) gives kTriMiss or a distance above the
// hi of t_max = th_widen(hi) (see above). The comparisons are combined
// without short circuits.
TH_HD bool th_may_hit(const ThTerms& k, float t_max) {
  const float t = k.num * th_rcp_approx(k.den);
  const float u = k.a1 + t * k.dg1;
  const float v = k.a2 + t * k.dg2;
  const float neg_m = -kFilterK * (fabsf(k.a1) + fabsf(k.a2)) - kFilterK;
  const bool keep = (t >= kFilterTLo) & !(t > t_max) & !(u < neg_m) &
                    !(v < neg_m) & !(u + v > 1.0f - neg_m);
  return keep | (fabsf(k.den) >= kFilterDenMax);
}

// Marks a packed triangle that does not move (its motion terms all zero)
// in its 16th word, which the test does not read otherwise.
TH_HD void th_mark_static(float* c) {
  c[15] = (c[12] == 0.f && c[13] == 0.f && c[14] == 0.f) ? 1.f : 0.f;
}

// A tiled kernel's copy of a ray: the same ray, or one with a NaN origin
// where its time is not finite (both miss every triangle; see above).
TH_HD ThRay th_tiled_ray(ThRay r) {
  if (!(r.tt - r.tt == 0.f)) r.ox = NAN;
  return r;
}

// Nearest-hit state of a tiled kernel's ray: ThNearest's, plus the
// filter's bound from the distance so far.
struct ThNearestFiltered {
  float t = kTriMiss;
  int idx = 0;
  bool back = false;
  float t_max = th_widen(kTriMiss);
  TH_HD void take(const ThTerms& k, int i) {
    bool b;
    const float d = th_finish(k, b);
    if (d < t) {
      t = d;
      idx = i;
      back = b;
      t_max = th_widen(d);
    }
  }
};

// 16-byte aligned packed triangle, loaded once for several rays.
struct alignas(16) ThTri {
  float c[kTriStride];
};

TH_HD ThTri th_load(const float* p) {
  ThTri tri;
#ifdef __CUDA_ARCH__
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kTriStride / 4; ++i) {
    const float4 x = q[i];
    tri.c[4 * i] = x.x;
    tri.c[4 * i + 1] = x.y;
    tri.c[4 * i + 2] = x.z;
    tri.c[4 * i + 3] = x.w;
  }
#else
  memcpy(tri.c, p, sizeof tri.c);
#endif
  return tri;
}

// Whether a packed triangle is degenerate (n = 0, as the scene's padding
// to a power-of-two count): |d.n| > 1e-9 fails for every ray, so it is
// never hit.
TH_HD bool th_degenerate(const float* c) {
  return c[0] == 0.f && c[1] == 0.f && c[2] == 0.f;
}

// R1's loop for one thread: its R rays (th_tiled_ray's) against triangles
// [j0, j1) of tris (marked by th_mark_static) in index order, each
// triangle read once for all R; a pair reaches th_finish only where the
// filter passes it, and then updates the state as ThNearest::visit would
// (strict <: the first index wins ties).
template <int R>
TH_HD void th_nearest_span(const float* tris, int j0, int j1,
                           const ThRay* ray, ThNearestFiltered* best) {
  for (int j = j0; j < j1; ++j) {
    const ThTri c = th_load(tris + j * kTriStride);
    ThTerms k[R];
    unsigned keep = 0;
    if (c.c[15] != 0.f) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        k[r] = th_terms_static(c.c, ray[r]);
        keep |= unsigned(th_may_hit(k[r], best[r].t_max)) << r;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        k[r] = th_terms(c.c, ray[r]);
        keep |= unsigned(th_may_hit(k[r], best[r].t_max)) << r;
      }
    }
    if (keep) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (keep >> r & 1u) best[r].take(k[r], j);
    }
  }
}

// R2's loop for one thread: its first R shadow rays (time 0) against
// triangles [j0, j1) in index order; a ray stays blocked once a triangle
// lies below its lim = dist - 1e-3 (t_max = th_widen(lim)), and a blocked
// ray reaches th_finish no more.
template <int R>
TH_HD void th_any_span(const float* tris, int j0, int j1, const ThRay* ray,
                       const float* lim, const float* t_max, bool* blocked) {
  for (int j = j0; j < j1; ++j) {
    const ThTri c = th_load(tris + j * kTriStride);
    ThTerms k[R];
    unsigned keep = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k[r] = th_terms_static(c.c, ray[r]);
      keep |= unsigned(!blocked[r] & th_may_hit(k[r], t_max[r])) << r;
    }
    if (keep) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bool b;
        if ((keep >> r & 1u) && th_finish(k[r], b) < lim[r])
          blocked[r] = true;
      }
    }
  }
}
