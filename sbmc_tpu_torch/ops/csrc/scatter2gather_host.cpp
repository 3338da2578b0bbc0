// Host build of scatter2gather and scatter2gather_max: the kernels'
// per-element and per-pixel functions (scatter2gather.cuh) run in plain
// loops. It exists so the CPU tests can check the kernels' index math (the
// flipped tap, the shift, the image bounds, the tap max) against the plain
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

}  // namespace

// Same arguments as the CUDA entry points, minus the stream. Both return 0,
// or 1 for an item size other than 4 (float32) or 2 (bfloat16).

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
