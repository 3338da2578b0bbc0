// Host build of the triangle hit tests (trace_hits.cuh) in plain loops, the
// reductions as the kernels take them (nearest: strict <, first triangle
// wins ties; any: the first blocker ends the ray), so the CPU tests can hold
// them against the plain PyTorch versions and JAX without a GPU:
//
//   g++ -O2 -shared -fPIC -o libtrace_hits_host.so trace_hits_host.cpp

#include "trace_hits.cuh"

namespace {

ThRay ray_at(const float* org, const float* dirs, float tt, int r) {
  return ThRay{org[3 * r], org[3 * r + 1], org[3 * r + 2], dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2], tt};
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
