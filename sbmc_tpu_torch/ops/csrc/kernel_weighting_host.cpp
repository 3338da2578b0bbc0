// Host build of kernel weighting, of its gradient to the weights and of its
// exp variant: the generic kernels' per-pixel functions and the tiled
// kernels' work items (kernel_weighting.cuh) run in plain loops, the work
// items assembled as kw_fwd and kw_dw assemble them (the same groups of tap
// rows, the forward's partial sums joined in group order). It exists so the
// CPU tests can check the kernels' index math (p + d_t, the image bounds,
// sum_w over every tap, the in-register exp, the bfloat16 rounding) against
// the plain PyTorch versions without a GPU:
//
//   g++ -O2 -shared -fPIC -o libkw_host.so kernel_weighting_host.cpp

#include "kernel_weighting.cuh"

namespace {

template <int C, typename T>
void run_fwd(const float* data, const T* weights, float* out, float* sum_w,
             int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        kw_fwd_pixel<C, T>(data + n * C * hw, weights + n * k2 * hw,
                           out + n * C * hw, sum_w + n * hw, h, w, k, y, x);
}

template <int C>
void fwd_c(const float* data, const void* weights, int weights_bf16,
           float* out, float* sum_w, int bs, int h, int w, int k) {
  if (weights_bf16)
    run_fwd<C>(data, static_cast<const uint16_t*>(weights), out, sum_w, bs, h,
               w, k);
  else
    run_fwd<C>(data, static_cast<const float*>(weights), out, sum_w, bs, h, w,
               k);
}

template <int C>
void run_dw(const float* data, const float* d_out, const float* d_sum_w,
            float* d_w, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        kw_dw_pixel<C>(data + n * C * hw, d_out + n * C * hw,
                       d_sum_w + n * hw, d_w + n * k2 * hw, h, w, k, y, x);
}

template <int C, typename T>
void run_exp(const float* data, const T* logits, const float* maxes,
             float* out, float* sum_w, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        kw_exp_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                           maxes + n * hw, out + n * C * hw, sum_w + n * hw,
                           h, w, k, y, x);
}

template <int C>
void exp_c(const float* data, const void* logits, int logits_bf16,
           const float* maxes, float* out, float* sum_w, int bs, int h, int w,
           int k) {
  if (logits_bf16)
    run_exp<C>(data, static_cast<const uint16_t*>(logits), maxes, out, sum_w,
               bs, h, w, k);
  else
    run_exp<C>(data, static_cast<const float*>(logits), maxes, out, sum_w,
               bs, h, w, k);
}

// The data at the shifted pixels of one work item's tap rows, read from the
// planes: the host's stand-in for the tiled kernels' halo in shared memory.
template <int C>
struct PlaneHalo {
  const float* data;
  int64_t hw;
  int h, w, y0, x0;  // the item's first pixel less o
  void get(int dy, int col, float (&d)[C]) const {
    const int sy = y0 + dy, sx = x0 + col;
    const bool in = sy >= 0 && sy < h && sx >= 0 && sx < w;
    const int64_t q = static_cast<int64_t>(sy) * w + sx;
    for (int c = 0; c < C; ++c) d[c] = in ? data[c * hw + q] : 0.f;
  }
};

// Every work item of the tiled forward (batch item, row, V pixels), its
// groups' partial sums joined in group order as kw_fwd joins them.
template <int C, int K, int V, typename T>
void run_fwd_tiles(const float* data, const T* weights, float* out,
                   float* sum_w, int bs, int h, int w, int groups) {
  constexpr int o = (K - 1) / 2;
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; x += V) {
        const int64_t p = static_cast<int64_t>(y) * w + x;
        const T* wp = weights + n * K * K * hw + p;
        const PlaneHalo<C> halo{data + n * C * hw, hw, h, w, y - o, x - o};
        KwAcc<C, V> a = kw_fwd_group<C, K, V>(wp, hw, 0, groups, halo);
        for (int g = 1; g < groups; ++g)
          kw_merge(a, kw_fwd_group<C, K, V>(wp, hw, g, groups, halo));
        kw_store(sum_w + n * hw + p, a.w);
        for (int c = 0; c < C; ++c) {
          float v[V];
          for (int j = 0; j < V; ++j) v[j] = a.r[j][c];
          kw_store(out + (n * C + c) * hw + p, v);
        }
      }
}

// Every work item of the tiled weight gradient, each group's rows in turn.
template <int C, int K, int V, typename T>
void run_dw_tiles(const float* data, const float* d_out,
                  const float* d_sum_w, T* d_w, int bs, int h, int w,
                  int groups) {
  constexpr int o = (K - 1) / 2;
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; x += V) {
        const int64_t p = static_cast<int64_t>(y) * w + x;
        float dout[V][C], dsw[V];
        for (int j = 0; j < V; ++j) {
          dsw[j] = d_sum_w[n * hw + p + j];
          for (int c = 0; c < C; ++c)
            dout[j][c] = d_out[(n * C + c) * hw + p + j];
        }
        const PlaneHalo<C> halo{data + n * C * hw, hw, h, w, y - o, x - o};
        for (int g = 0; g < groups; ++g)
          kw_dw_group<C, K, V>(dout, dsw, d_w + n * K * K * hw + p, hw, g,
                               groups, halo);
      }
}

// Calls Fn<K, V>::run(args...) for k in {3, 5, 21} and v in {1, 2, ...,
// kMaxV}; returns 1 outside that set.
template <int K, int kMaxV, template <int, int> class Fn, typename... Args>
int by_v(int v, Args... args) {
  if (v == 1) {
    Fn<K, 1>::run(args...);
    return 0;
  }
  if (v == 2) {
    Fn<K, 2>::run(args...);
    return 0;
  }
  if constexpr (kMaxV >= 4) {
    if (v == 4) {
      Fn<K, 4>::run(args...);
      return 0;
    }
  }
  return 1;
}

template <int kMaxV, template <int, int> class Fn, typename... Args>
int by_k_v(int k, int v, Args... args) {
  switch (k) {
    case 3: return by_v<3, kMaxV, Fn>(v, args...);
    case 5: return by_v<5, kMaxV, Fn>(v, args...);
    case 21: return by_v<21, kMaxV, Fn>(v, args...);
    default: return 1;
  }
}

template <int C, typename T>
struct FwdTiles {
  template <int K, int V>
  struct At {
    static void run(const float* data, const void* weights, float* out,
                    float* sum_w, int bs, int h, int w, int groups) {
      run_fwd_tiles<C, K, V>(data, static_cast<const T*>(weights), out,
                             sum_w, bs, h, w, groups);
    }
  };
};

template <int C, typename T>
struct DwTiles {
  template <int K, int V>
  struct At {
    static void run(const float* data, const float* d_out,
                    const float* d_sum_w, void* d_w, int bs, int h, int w,
                    int groups) {
      run_dw_tiles<C, K, V>(data, d_out, d_sum_w, static_cast<T*>(d_w), bs,
                            h, w, groups);
    }
  };
};

// The tiled kernels' groups (1, 2, 4 or 8, at most k) and a v (1, 2 or 4,
// at most max_v) that divides the width.
bool tiles_ok(int w, int k, int v, int max_v, int groups) {
  return (groups == 1 || groups == 2 || groups == 4 || groups == 8) &&
         groups <= k && (v == 1 || v == 2 || v == 4) && v <= max_v &&
         w % v == 0;
}

}  // namespace

// The tiled kernels' arithmetic, work item by work item: the arguments of
// the CUDA entry points sbmc_kernel_weighting and sbmc_kernel_weighting_dw,
// minus the stream. Both return 0, or 1 outside the tiled kernels' set: c 2
// or 3, k 3, 5 or 21, v 1 or 2 (the gradient's also 4) dividing w, groups
// 1, 2, 4 or 8 and at most k.

extern "C" int sbmc_kernel_weighting_tiles_host(
    const float* data, const void* weights, int weights_bf16, float* out,
    float* sum_w, int bs, int c, int h, int w, int k, int v, int groups) {
  if (!tiles_ok(w, k, v, 2, groups)) return 1;
  if (c == 2 && weights_bf16)
    return by_k_v<2, FwdTiles<2, uint16_t>::At>(k, v, data, weights, out, sum_w,
                                              bs, h, w, groups);
  if (c == 2)
    return by_k_v<2, FwdTiles<2, float>::At>(k, v, data, weights, out, sum_w,
                                           bs, h, w, groups);
  if (c == 3 && weights_bf16)
    return by_k_v<2, FwdTiles<3, uint16_t>::At>(k, v, data, weights, out, sum_w,
                                              bs, h, w, groups);
  if (c == 3)
    return by_k_v<2, FwdTiles<3, float>::At>(k, v, data, weights, out, sum_w,
                                           bs, h, w, groups);
  return 1;
}

extern "C" int sbmc_kernel_weighting_dw_tiles_host(
    const float* data, const float* d_out, const float* d_sum_w, void* d_w,
    int out_bf16, int bs, int c, int h, int w, int k, int v, int groups) {
  if (!tiles_ok(w, k, v, 4, groups)) return 1;
  if (c == 2 && out_bf16)
    return by_k_v<4, DwTiles<2, uint16_t>::At>(k, v, data, d_out, d_sum_w, d_w,
                                             bs, h, w, groups);
  if (c == 2)
    return by_k_v<4, DwTiles<2, float>::At>(k, v, data, d_out, d_sum_w, d_w, bs,
                                          h, w, groups);
  if (c == 3 && out_bf16)
    return by_k_v<4, DwTiles<3, uint16_t>::At>(k, v, data, d_out, d_sum_w, d_w,
                                             bs, h, w, groups);
  if (c == 3)
    return by_k_v<4, DwTiles<3, float>::At>(k, v, data, d_out, d_sum_w, d_w, bs,
                                          h, w, groups);
  return 1;
}

// The generic kernels' arithmetic: same arguments as the CUDA entry points
// sbmc_kernel_weighting_generic, sbmc_kernel_weighting_dw_generic (float32
// d_w) and sbmc_kernel_weighting_exp, minus the stream. All return 0, or 1
// for a channel count other than 2 or 3 (the kernels' template set).

extern "C" int sbmc_kernel_weighting_host(const float* data,
                                          const void* weights,
                                          int weights_bf16, float* out,
                                          float* sum_w, int bs, int c, int h,
                                          int w, int k) {
  switch (c) {
    case 2:
      fwd_c<2>(data, weights, weights_bf16, out, sum_w, bs, h, w, k);
      return 0;
    case 3:
      fwd_c<3>(data, weights, weights_bf16, out, sum_w, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}

extern "C" int sbmc_kernel_weighting_dw_host(const float* data,
                                             const float* d_out,
                                             const float* d_sum_w, float* d_w,
                                             int bs, int c, int h, int w,
                                             int k) {
  switch (c) {
    case 2:
      run_dw<2>(data, d_out, d_sum_w, d_w, bs, h, w, k);
      return 0;
    case 3:
      run_dw<3>(data, d_out, d_sum_w, d_w, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}

extern "C" int sbmc_kernel_weighting_exp_host(const float* data,
                                              const void* logits,
                                              int logits_bf16,
                                              const float* maxes, float* out,
                                              float* sum_w, int bs, int c,
                                              int h, int w, int k) {
  switch (c) {
    case 2:
      exp_c<2>(data, logits, logits_bf16, maxes, out, sum_w, bs, h, w, k);
      return 0;
    case 3:
      exp_c<3>(data, logits, logits_bf16, maxes, out, sum_w, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}
