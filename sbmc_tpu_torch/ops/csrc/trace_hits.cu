// R1 tri_nearest and R2 tri_any: the wavefront renderer's ray x triangle
// tests, one fused pass per batch of rays.
//
// The port of the triangle half of sbmc_tpu/render/pathtracer.py
// _intersect (R1: _tri_ts reduced by argmin, :756-766) and _occluded (R2:
// _tri_ts under a distance, :885-887). There is no Pallas kernel behind
// them: XLA computed the [rays, triangles] products on the TPU's matrix
// unit. Written in eager PyTorch those are a dozen [N, T] intermediates a
// call, ~2.5 GB of device memory traffic a path vertex at 16384 rays and
// 1024 triangles.
//
// Bound: FP32 arithmetic. Each ray x triangle pair is ~50 operations (six
// 3-term dot products, a division, the barycentric tests) on 28 bytes of
// ray data read once and 64 bytes of triangle constants shared by every
// ray. Design: one thread a ray with the ray in registers; the block stages
// the packed triangle constants through shared memory kChunk triangles at a
// time (16-byte loads, every thread then reads the same triangle: a
// broadcast); nearest keeps the running argmin in registers (strict <, so
// the first triangle wins ties as jnp.argmin does); any stops a ray at its
// first blocker and the block at the chunk where all its rays are done.

#include <cuda_runtime.h>

#include "trace_hits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // triangles staged at once: 16 KB

// Stage triangles [c0, c0 + m) into shared memory (m * 4 float4s).
__device__ __forceinline__ void stage(float* s, const float* tris, int c0,
                                      int m) {
  const float4* src = reinterpret_cast<const float4*>(tris) +
                      static_cast<int64_t>(c0) * (kTriStride / 4);
  float4* dst = reinterpret_cast<float4*>(s);
  for (int j = threadIdx.x; j < m * (kTriStride / 4); j += kThreads)
    dst[j] = src[j];
}

__device__ __forceinline__ ThRay load_ray(const float* org, const float* dirs,
                                          float tt, int r) {
  return ThRay{org[3 * r], org[3 * r + 1], org[3 * r + 2], dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2], tt};
}

__global__ void __launch_bounds__(kThreads)
    tri_nearest_kernel(const float* __restrict__ org,
                       const float* __restrict__ dirs,
                       const float* __restrict__ time,
                       const float* __restrict__ tris, int n, int t,
                       float* __restrict__ out_t, int* __restrict__ out_idx,
                       uint8_t* __restrict__ out_back) {
  __shared__ __align__(16) float s[kChunk * kTriStride];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n;
  const ThRay ray = live ? load_ray(org, dirs, time[r], r) : ThRay{};
  ThNearest best;
  for (int c0 = 0; c0 < t; c0 += kChunk) {
    const int m = min(kChunk, t - c0);
    __syncthreads();
    stage(s, tris, c0, m);
    __syncthreads();
    if (live)
      for (int j = 0; j < m; ++j) best.visit(s + j * kTriStride, ray, c0 + j);
  }
  if (live) {
    out_t[r] = best.t;
    out_idx[r] = best.idx;
    out_back[r] = best.back;
  }
}

__global__ void __launch_bounds__(kThreads)
    tri_any_kernel(const float* __restrict__ org,
                   const float* __restrict__ dirs,
                   const float* __restrict__ dist,
                   const float* __restrict__ tris, int n, int t,
                   uint8_t* __restrict__ out) {
  __shared__ __align__(16) float s[kChunk * kTriStride];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n;
  // Shadow rays test the static geometry: time 0 (pathtracer._occluded).
  const ThRay ray = live ? load_ray(org, dirs, 0.f, r) : ThRay{};
  const float lim = live ? dist[r] - 1e-3f : 0.f;
  bool done = !live, blocked = false;
  for (int c0 = 0; c0 < t; c0 += kChunk) {
    const int m = min(kChunk, t - c0);
    __syncthreads();
    stage(s, tris, c0, m);
    __syncthreads();
    for (int j = 0; j < m && !done; ++j)
      if (th_blocks(s + j * kTriStride, ray, lim)) blocked = done = true;
    if (__syncthreads_and(done)) break;
  }
  if (live) out[r] = blocked;
}

}  // namespace

// org, dirs: [n, 3]; time: [n]; tris: [t, 16] packed constants, 16-byte
// aligned; out: t [n] float32, idx [n] int32, back [n] uint8.
extern "C" int sbmc_tri_nearest(const float* org, const float* dirs,
                                const float* time, const float* tris, int n,
                                int t, float* out_t, int* out_idx,
                                uint8_t* out_back, void* stream) {
  if (n < 1 || t < 1 || reinterpret_cast<uintptr_t>(tris) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  tri_nearest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      org, dirs, time, tris, n, t, out_t, out_idx, out_back);
  return static_cast<int>(cudaGetLastError());
}

// org, dirs: [n, 3]; dist: [n]; tris as above; out: [n] bool (uint8).
extern "C" int sbmc_tri_any(const float* org, const float* dirs,
                            const float* dist, const float* tris, int n,
                            int t, uint8_t* out, void* stream) {
  if (n < 1 || t < 1 || reinterpret_cast<uintptr_t>(tris) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  tri_any_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(org, dirs, dist, tris,
                                                        n, t, out);
  return static_cast<int>(cudaGetLastError());
}
