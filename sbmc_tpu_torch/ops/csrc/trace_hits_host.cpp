// Host build of the triangle hit tests (trace_hits.cuh) in plain loops, so
// the CPU tests can hold them against the plain PyTorch versions and JAX
// without a GPU:
//
//   g++ -O2 -shared -fPIC -o libtrace_hits_host.so trace_hits_host.cpp
//
// sbmc_tri_nearest_host / sbmc_tri_any_host: the generic kernels' loop
// (th_hit on every pair; nearest: strict <, the first triangle wins ties;
// any: the first blocker ends the ray). sbmc_tri_nearest_tiles_host /
// sbmc_tri_any_tiles_host: the tiled kernels' loop (th_nearest_span,
// th_any_span: the filter, then th_finish on what passes), `rays` rays at a
// time (1, 2 or 4, the kernels' R), over a copy of the triangles marked as
// the kernels stage them (th_mark_static) up to the last one that is not
// degenerate, R2 in chunks of kAnyChunk that stop once all rays of the
// group are blocked.

#include <vector>

#include "trace_hits.cuh"

namespace {

constexpr int kAnyChunk = 64;

ThRay ray_at(const float* org, const float* dirs, float tt, int r) {
  return ThRay{org[3 * r], org[3 * r + 1], org[3 * r + 2], dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2], tt};
}

// One past the last triangle that is not degenerate.
int real_count(const float* tris, int t) {
  while (t > 0 && th_degenerate(tris + (t - 1) * kTriStride)) --t;
  return t;
}

// The triangles as the kernels stage them: marked by th_mark_static.
std::vector<float> staged(const float* tris, int t) {
  std::vector<float> s(tris, tris + static_cast<size_t>(t) * kTriStride);
  for (int i = 0; i < t; ++i) th_mark_static(s.data() + i * kTriStride);
  return s;
}

template <int R>
void nearest_tiles(const float* org, const float* dirs, const float* time,
                   const float* tris, int n, int t, float* out_t,
                   int* out_idx, uint8_t* out_back) {
  const int t_real = real_count(tris, t);
  const std::vector<float> s = staged(tris, t);
  for (int r0 = 0; r0 < n; r0 += R) {
    ThRay ray[R];
    ThNearestFiltered best[R];
    for (int r = 0; r < R; ++r)
      ray[r] = r0 + r < n
                   ? th_tiled_ray(ray_at(org, dirs, time[r0 + r], r0 + r))
                   : ThRay{};
    th_nearest_span<R>(s.data(), 0, t_real, ray, best);
    for (int r = 0; r < R && r0 + r < n; ++r) {
      out_t[r0 + r] = best[r].t;
      out_idx[r0 + r] = best[r].idx;
      out_back[r0 + r] = best[r].back;
    }
  }
}

template <int R>
void any_tiles(const float* org, const float* dirs, const float* dist,
               const float* tris, int n, int t, uint8_t* out) {
  const int t_real = real_count(tris, t);
  const std::vector<float> s = staged(tris, t);
  for (int r0 = 0; r0 < n; r0 += R) {
    ThRay ray[R];
    float lim[R], t_max[R];
    bool blocked[R];
    for (int r = 0; r < R; ++r) {
      const bool live = r0 + r < n;
      ray[r] = live ? ray_at(org, dirs, 0.f, r0 + r) : ThRay{};
      lim[r] = live ? dist[r0 + r] - 1e-3f : 0.f;
      t_max[r] = th_widen(lim[r]);
      blocked[r] = !live;
    }
    for (int j0 = 0; j0 < t_real; j0 += kAnyChunk) {
      th_any_span<R>(s.data(), j0,
                     j0 + kAnyChunk < t_real ? j0 + kAnyChunk : t_real, ray,
                     lim, t_max, blocked);
      bool all = true;
      for (int r = 0; r < R; ++r) all = all && blocked[r];
      if (all) break;
    }
    for (int r = 0; r < R && r0 + r < n; ++r) out[r0 + r] = blocked[r];
  }
}

}  // namespace

extern "C" int sbmc_tri_nearest_host(const float* org, const float* dirs,
                                     const float* time, const float* tris,
                                     int n, int t, float* out_t, int* out_idx,
                                     uint8_t* out_back) {
  for (int r = 0; r < n; ++r) {
    const ThRay ray = ray_at(org, dirs, time[r], r);
    ThNearest best;
    for (int i = 0; i < t; ++i) best.visit(tris + i * kTriStride, ray, i);
    out_t[r] = best.t;
    out_idx[r] = best.idx;
    out_back[r] = best.back;
  }
  return 0;
}

extern "C" int sbmc_tri_any_host(const float* org, const float* dirs,
                                 const float* dist, const float* tris, int n,
                                 int t, uint8_t* out) {
  for (int r = 0; r < n; ++r) {
    const ThRay ray = ray_at(org, dirs, 0.f, r);
    const float lim = dist[r] - 1e-3f;
    bool blocked = false;
    for (int i = 0; i < t && !blocked; ++i)
      blocked = th_blocks(tris + i * kTriStride, ray, lim);
    out[r] = blocked;
  }
  return 0;
}

// The tiled kernels' arguments (rays: 1, 2 or 4 a thread) minus the
// stream; 1 for another rays value.
extern "C" int sbmc_tri_nearest_tiles_host(const float* org,
                                           const float* dirs,
                                           const float* time,
                                           const float* tris, int n, int t,
                                           float* out_t, int* out_idx,
                                           uint8_t* out_back, int rays) {
  switch (rays) {
    case 1:
      nearest_tiles<1>(org, dirs, time, tris, n, t, out_t, out_idx, out_back);
      return 0;
    case 2:
      nearest_tiles<2>(org, dirs, time, tris, n, t, out_t, out_idx, out_back);
      return 0;
    case 4:
      nearest_tiles<4>(org, dirs, time, tris, n, t, out_t, out_idx, out_back);
      return 0;
    default:
      return 1;
  }
}

extern "C" int sbmc_tri_any_tiles_host(const float* org, const float* dirs,
                                       const float* dist, const float* tris,
                                       int n, int t, uint8_t* out, int rays) {
  switch (rays) {
    case 1:
      any_tiles<1>(org, dirs, dist, tris, n, t, out);
      return 0;
    case 2:
      any_tiles<2>(org, dirs, dist, tris, n, t, out);
      return 0;
    case 4:
      any_tiles<4>(org, dirs, dist, tris, n, t, out);
      return 0;
    default:
      return 1;
  }
}
