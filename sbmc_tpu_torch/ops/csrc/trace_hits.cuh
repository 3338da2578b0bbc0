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

// Distance to packed triangle c along the ray (kTriMiss on a miss); sets
// back to whether a hit is on the back face.
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
