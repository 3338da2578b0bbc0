// Host build of scatter2gather and scatter2gather_max: the kernels'
// per-element and per-pixel functions and the vector kernel's work item
// (scatter2gather.cuh) run in plain loops. It exists so the CPU tests can
// check the kernels' index math (the flipped tap, the shift, the image
// bounds, the realigning funnel shift, the tap max) against the plain
// PyTorch versions without a GPU:
//
//   g++ -O2 -shared -fPIC -o libs2g_host.so scatter2gather_host.cpp

#include "scatter2gather.cuh"

namespace {

template <typename T>
void run(const T* weights, T* out, int bs, int h, int w, int k) {
  const int64_t item = static_cast<int64_t>(k) * k * h * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int t = 0; t < k * k; ++t)
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          s2g_element<T>(weights + n * item, out + n * item, h, w, k, t, y, x);
}

template <typename T>
void run_max(const T* weights, T* out, float* kmax, int bs, int h, int w,
             int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t item = static_cast<int64_t>(k) * k * hw;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        s2g_max_pixel<T>(weights + n * item, out + n * item, kmax + n * hw, h,
                         w, k, y, x);
}

// Every work item of the vector kernel (batch item, plane, V elements) in
// turn, each moved and stored as s2g_vec moves and stores it.
template <typename T, int V, int K>
void run_vec(const T* weights, T* out, int bs, int h, int w) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int t = 0; t < K * K; ++t) {
      const S2gPlane pl = s2g_plane<K, V>(t);
      const T* src = weights + (n * K * K + pl.src) * hw;
      T* dst = out + (n * K * K + t) * hw;
      for (int e = 0; e < hw; e += V) {
        S2gBits<V * static_cast<int>(sizeof(T))> v;
        s2g_vec_item<T, V>(src, h, w, e, pl.sy_off, pl.sx_off, pl.r, v);
        s2g_store(dst + e, v);
      }
    }
}

template <typename T, int V>
int vec_k(const void* weights, void* out, int bs, int h, int w, int k) {
  const T* in = static_cast<const T*>(weights);
  T* o = static_cast<T*>(out);
  switch (k) {
    case 3:
      run_vec<T, V, 3>(in, o, bs, h, w);
      return 0;
    case 5:
      run_vec<T, V, 5>(in, o, bs, h, w);
      return 0;
    case 21:
      run_vec<T, V, 21>(in, o, bs, h, w);
      return 0;
    default:
      return 1;
  }
}

template <typename T>
int vec_v(const void* weights, void* out, int bs, int h, int w, int k,
          int v) {
  if (v < 1 || w % v != 0) return 1;
  switch (v * static_cast<int>(sizeof(T))) {
    case 16:
      return vec_k<T, 16 / sizeof(T)>(weights, out, bs, h, w, k);
    case 8:
      return vec_k<T, 8 / sizeof(T)>(weights, out, bs, h, w, k);
    case 4:
      return vec_k<T, 4 / sizeof(T)>(weights, out, bs, h, w, k);
    case 2:
      if constexpr (sizeof(T) == 2)
        return vec_k<T, 1>(weights, out, bs, h, w, k);
      return 1;
    default:
      return 1;
  }
}

}  // namespace

// The vector kernel's moves, work item by work item: the arguments of
// sbmc_scatter2gather, minus the stream. Returns 0, or 1 outside the vector
// kernel's set: itemsize 4 or 2, k 3, 5 or 21, items of v elements of 2, 4,
// 8 or 16 bytes that divide w. (The kernel also needs both bases aligned to
// an item; a host array need not be.)
extern "C" int sbmc_scatter2gather_vec_host(const void* weights, int itemsize,
                                            void* out, int bs, int h, int w,
                                            int k, int v) {
  if (itemsize == 4) return vec_v<float>(weights, out, bs, h, w, k, v);
  if (itemsize == 2) return vec_v<uint16_t>(weights, out, bs, h, w, k, v);
  return 1;
}

// The generic kernel's and s2g_max's arithmetic: the arguments of
// sbmc_scatter2gather_generic and sbmc_scatter2gather_max, minus the stream.
// Both return 0, or 1 for an item size other than 4 (float32) or 2
// (bfloat16).

extern "C" int sbmc_scatter2gather_host(const void* weights, int itemsize,
                                        void* out, int bs, int h, int w,
                                        int k) {
  if (itemsize == 4)
    run(static_cast<const float*>(weights), static_cast<float*>(out), bs, h,
        w, k);
  else if (itemsize == 2)
    run(static_cast<const uint16_t*>(weights), static_cast<uint16_t*>(out),
        bs, h, w, k);
  else
    return 1;
  return 0;
}

extern "C" int sbmc_scatter2gather_max_host(const void* weights, int itemsize,
                                            void* out, float* kmax, int bs,
                                            int h, int w, int k) {
  if (itemsize == 4)
    run_max(static_cast<const float*>(weights), static_cast<float*>(out),
            kmax, bs, h, w, k);
  else if (itemsize == 2)
    run_max(static_cast<const uint16_t*>(weights),
            static_cast<uint16_t*>(out), kmax, bs, h, w, k);
  else
    return 1;
  return 0;
}
