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
// ray; the issue slots, not memory, set the time.
//
// Two kernels each:
//
// - tiled (tri_nearest_tiles, tri_any_tiles: every count up to
//   kTiledMaxTris triangles). Each block stages all of a scene's
//   triangles in dynamic shared memory once, and stops at the last one
//   that is not degenerate (the scene's power-of-two padding, n = 0, is
//   never hit). Its warps then walk tiles of 32 x R rays, R = kRays rays
//   a thread, so each triangle read from shared memory (a broadcast: all
//   lanes read the same word) serves R pairs whose chains interleave. A
//   pair is first tested without a division (th_may_hit: the hardware
//   reciprocal, margins proven conservative in trace_hits.cuh); only the
//   pairs that pass it run the exact test th_finish, whose IEEE division
//   and comparisons decide every returned value. R2 tests at time 0
//   without the motion products (th_terms_static), and a warp takes its
//   tiles from a queue: every kAnyStep triangles it leaves the tile once
//   all its rays are blocked, and every kAnyChunk triangles it moves its
//   live rays into its first slots through shared memory, so that emptied
//   slots stop costing issue slots.
// - generic (tri_nearest_generic, tri_any_generic: any count): the first
//   port's kernels, one ray a thread and th_hit on every pair, staging
//   kChunk triangles at a time.
//
// Triangles are visited in index order in all four: R1's tie rule (the
// first index wins, as jnp.argmin) needs it, and so does R2's bound (pairs
// up to each ray's first blocker).

#include <cuda_runtime.h>

#include "trace_hits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // generic: triangles staged at once, 16 KB
constexpr int kWarps = kThreads / 32;
constexpr int kTiledMaxTris = 2048;  // 128 KB of triangles
constexpr int kRays = 4;        // rays a thread of the tiled kernels
constexpr int kAnyStep = 16;    // R2: triangles between warp votes
constexpr int kAnyChunk = 64;   // R2: triangles between compactions

// Stage triangles [c0, c0 + m) into shared memory (m * 4 float4s).
__device__ __forceinline__ void stage(float* s, const float* tris, int c0,
                                      int m) {
  const float4* src = reinterpret_cast<const float4*>(tris) +
                      static_cast<int64_t>(c0) * (kTriStride / 4);
  float4* dst = reinterpret_cast<float4*>(s);
  for (int j = threadIdx.x; j < m * (kTriStride / 4); j += blockDim.x)
    dst[j] = src[j];
}

// Stage all t triangles, each marked by th_mark_static (its last float4
// holds mn, m1, m2 and the mark); returns one past the last that is not
// degenerate.
__device__ int stage_all(float* s, const float* tris, int t, int* s_real) {
  if (threadIdx.x == 0) *s_real = 0;
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(tris);
  float4* dst = reinterpret_cast<float4*>(s);
  int last = 0;
  for (int j = threadIdx.x; j < t * (kTriStride / 4); j += blockDim.x) {
    float4 x = src[j];
    if (j % (kTriStride / 4) == kTriStride / 4 - 1)
      x.w = (x.x == 0.f && x.y == 0.f && x.z == 0.f) ? 1.f : 0.f;
    dst[j] = x;
    const bool real = x.x != 0.f || x.y != 0.f || x.z != 0.f;
    if (j % (kTriStride / 4) == 0 && real) last = j / (kTriStride / 4) + 1;
  }
  if (last) atomicMax(s_real, last);
  __syncthreads();
  return *s_real;
}

__device__ __forceinline__ ThRay load_ray(const float* org, const float* dirs,
                                          float tt, int r) {
  return ThRay{org[3 * r], org[3 * r + 1], org[3 * r + 2], dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2], tt};
}

__global__ void __launch_bounds__(kThreads)
    tri_nearest_generic_kernel(const float* __restrict__ org,
                               const float* __restrict__ dirs,
                               const float* __restrict__ time,
                               const float* __restrict__ tris, int n, int t,
                               float* __restrict__ out_t,
                               int* __restrict__ out_idx,
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
    tri_any_generic_kernel(const float* __restrict__ org,
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

// R1, tiled: warp w of the grid takes tiles w, w + warps, ... of 32 x R
// rays; ray r * 32 + lane of a tile sits in slot r of that lane (loads and
// stores coalesced per slot).
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    tri_nearest_tiles(const float* __restrict__ org,
                      const float* __restrict__ dirs,
                      const float* __restrict__ time,
                      const float* __restrict__ tris, int n, int t,
                      float* __restrict__ out_t, int* __restrict__ out_idx,
                      uint8_t* __restrict__ out_back) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_real;
  const int t_real = stage_all(smem, tris, t, &s_real);
  const int lane = threadIdx.x & 31;
  const int tiles = (n + 32 * R - 1) / (32 * R);
  for (int tile = blockIdx.x * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * kWarps) {
    ThRay ray[R];
    ThNearestFiltered best[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int id = tile * 32 * R + r * 32 + lane;
      ray[r] = id < n ? th_tiled_ray(load_ray(org, dirs, time[id], id))
                      : ThRay{};
    }
    th_nearest_span<R>(smem, 0, t_real, ray, best);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int id = tile * 32 * R + r * 32 + lane;
      if (id < n) {
        out_t[id] = best[r].t;
        out_idx[id] = best[r].idx;
        out_back[id] = best[r].back;
      }
    }
  }
}

// A slot's ray (id -1: an empty slot, which counts as blocked, so it
// never reaches th_finish), its lim and the filter's bound.
__device__ __forceinline__ void any_load(const float* org, const float* dirs,
                                         const float* dist, int id,
                                         ThRay& ray, float& lim,
                                         float& t_max, bool& blocked) {
  if (id >= 0) {
    ray = load_ray(org, dirs, 0.f, id);
    lim = dist[id] - 1e-3f;
    blocked = false;
  } else {
    ray = ThRay{};
    lim = 0.f;
    blocked = true;
  }
  t_max = th_widen(lim);
}

// The first s of a lane's R slots against triangles [j0, j1): a template
// per s, so that emptied slots cost no instruction.
template <int R>
__device__ __forceinline__ void any_span_slots(int s, const float* tris,
                                               int j0, int j1,
                                               const ThRay* ray,
                                               const float* lim,
                                               const float* t_max,
                                               bool* blocked) {
  if (R >= 4 && s >= 4)
    th_any_span<(R >= 4 ? 4 : 1)>(tris, j0, j1, ray, lim, t_max, blocked);
  else if (R >= 3 && s == 3)
    th_any_span<(R >= 3 ? 3 : 1)>(tris, j0, j1, ray, lim, t_max, blocked);
  else if (s == 2)
    th_any_span<2>(tris, j0, j1, ray, lim, t_max, blocked);
  else
    th_any_span<1>(tris, j0, j1, ray, lim, t_max, blocked);
}

// R2, tiled: each warp takes tiles of 32 x R rays from the queue
// *next_tile (0 at launch) until none is left; see the file's comment.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    tri_any_tiles(const float* __restrict__ org,
                  const float* __restrict__ dirs,
                  const float* __restrict__ dist,
                  const float* __restrict__ tris, int n, int t,
                  uint8_t* __restrict__ out, int* __restrict__ next_tile) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_real;
  const int t_real = stage_all(smem, tris, t, &s_real);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* ids = reinterpret_cast<int*>(smem + t * kTriStride) +
             (threadIdx.x >> 5) * 32 * R;
  const int tiles = (n + 32 * R - 1) / (32 * R);
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(next_tile, 1);
    tile = __shfl_sync(~0u, tile, 0);
    if (tile >= tiles) break;
    int id[R];
    ThRay ray[R];
    float lim[R], t_max[R];
    bool blocked[R];
    int live = 0;  // live rays of the warp, in its first slots
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tile * 32 * R + r * 32 + lane;
      id[r] = i < n ? i : -1;
      any_load(org, dirs, dist, id[r], ray[r], lim[r], t_max[r], blocked[r]);
      live += __popc(__ballot_sync(~0u, id[r] >= 0));
    }
    int slots = (live + 31) / 32;
    for (int j0 = 0; j0 < t_real && slots; j0 += kAnyChunk) {
      const int j1 = min(j0 + kAnyChunk, t_real);
      for (int j = j0; j < j1; j += kAnyStep) {
        any_span_slots<R>(slots, smem, j, min(j + kAnyStep, j1), ray, lim,
                          t_max, blocked);
        bool mine = false;
#pragma unroll
        for (int r = 0; r < R; ++r) mine |= !blocked[r];
        if (!__any_sync(~0u, mine)) break;
      }
      // Count the live rays; move them into the first slots when that
      // empties a slot.
      unsigned mask[R];
      int total = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mask[r] = __ballot_sync(~0u, !blocked[r]);
        total += __popc(mask[r]);
      }
      if ((total + 31) / 32 == slots) continue;
      int pos = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (id[r] >= 0 && blocked[r]) out[id[r]] = 1;
        if (!blocked[r]) ids[pos + __popc(mask[r] & below)] = id[r];
        pos += __popc(mask[r]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = r * 32 + lane;
        id[r] = q < total ? ids[q] : -1;
        any_load(org, dirs, dist, id[r], ray[r], lim[r], t_max[r],
                 blocked[r]);
      }
      __syncwarp();
      slots = (total + 31) / 32;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (id[r] >= 0) out[id[r]] = blocked[r];
  }
}

// Blocks of a tiled kernel that the card holds at once with `smem` bytes
// of dynamic shared memory each (the attribute that lets a block take more
// than 48 KB set first), at most `want`.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int want, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = min(want, sms * per_sm);
  return 0;
}

template <int R>
int nearest_tiles(const float* org, const float* dirs, const float* time,
                  const float* tris, int n, int t, float* out_t, int* out_idx,
                  uint8_t* out_back, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(t) * kTriStride * sizeof(float);
  const int warps = (n + 32 * R - 1) / (32 * R);
  int blocks = 0;
  if (int err = resident_blocks(tri_nearest_tiles<R>, smem,
                                (warps + kWarps - 1) / kWarps, &blocks))
    return err;
  tri_nearest_tiles<R><<<blocks, kThreads, smem, stream>>>(
      org, dirs, time, tris, n, t, out_t, out_idx, out_back);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int any_tiles(const float* org, const float* dirs, const float* dist,
              const float* tris, int n, int t, uint8_t* out, int* next_tile,
              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(t) * kTriStride * sizeof(float) +
                      kWarps * 32 * R * sizeof(int);
  const int warps = (n + 32 * R - 1) / (32 * R);
  int blocks = 0;
  if (int err = resident_blocks(tri_any_tiles<R>, smem,
                                (warps + kWarps - 1) / kWarps, &blocks))
    return err;
  tri_any_tiles<R><<<blocks, kThreads, smem, stream>>>(
      org, dirs, dist, tris, n, t, out, next_tile);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int n, int t, const float* tris) {
  return n < 1 || t < 1 || reinterpret_cast<uintptr_t>(tris) % 16;
}

}  // namespace

// org, dirs: [n, 3]; time: [n]; tris: [t, 16] packed constants, 16-byte
// aligned; out: t [n] float32, idx [n] int32, back [n] uint8. The tiled
// kernel takes t <= kTiledMaxTris.
extern "C" int sbmc_tri_nearest(const float* org, const float* dirs,
                                const float* time, const float* tris, int n,
                                int t, float* out_t, int* out_idx,
                                uint8_t* out_back, void* stream) {
  if (bad_args(n, t, tris) || t > kTiledMaxTris)
    return static_cast<int>(cudaErrorInvalidValue);
  return nearest_tiles<kRays>(org, dirs, time, tris, n, t, out_t, out_idx,
                              out_back, static_cast<cudaStream_t>(stream));
}

extern "C" int sbmc_tri_nearest_generic(const float* org, const float* dirs,
                                        const float* time, const float* tris,
                                        int n, int t, float* out_t,
                                        int* out_idx, uint8_t* out_back,
                                        void* stream) {
  if (bad_args(n, t, tris)) return static_cast<int>(cudaErrorInvalidValue);
  tri_nearest_generic_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      org, dirs, time, tris, n, t, out_t, out_idx, out_back);
  return static_cast<int>(cudaGetLastError());
}

// org, dirs: [n, 3]; dist: [n]; tris as above; out: [n] bool (uint8);
// next_tile: one int32, 0 at launch (the warps' queue). The tiled kernel
// takes t <= kTiledMaxTris.
extern "C" int sbmc_tri_any(const float* org, const float* dirs,
                            const float* dist, const float* tris, int n,
                            int t, uint8_t* out, int* next_tile,
                            void* stream) {
  if (bad_args(n, t, tris) || t > kTiledMaxTris)
    return static_cast<int>(cudaErrorInvalidValue);
  return any_tiles<kRays>(org, dirs, dist, tris, n, t, out, next_tile,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int sbmc_tri_any_generic(const float* org, const float* dirs,
                                    const float* dist, const float* tris,
                                    int n, int t, uint8_t* out,
                                    void* stream) {
  if (bad_args(n, t, tris)) return static_cast<int>(cudaErrorInvalidValue);
  tri_any_generic_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      org, dirs, dist, tris, n, t, out);
  return static_cast<int>(cudaGetLastError());
}
