// Host build of the fused progressive splat step's backward: the kernels'
// per-pixel functions (progressive_splat_bwd.cuh) run in plain loops. It
// exists so the CPU tests can check the kernels' index math (p + d_t, the
// image bounds) and the bfloat16 rounding against the plain PyTorch version
// without a GPU:
//
//   g++ -O2 -shared -fPIC -o libpsb_host.so progressive_splat_bwd_host.cpp

#include "progressive_splat_bwd.cuh"

namespace {

template <int C, typename T>
void run_ddata(const T* logits, const float* new_max, const float* d_r,
               float* d_data, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psb_ddata_pixel<C, T>(logits + n * k2 * hw, new_max + n * hw,
                              d_r + n * C * hw, d_data + n * C * hw, h, w, k,
                              y, x);
}

template <int C, typename T>
void run_dlogits(const float* data, const T* logits, const float* new_max,
                 const float* d_r, const float* d_w, T* d_logits, int bs,
                 int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psb_dlogits_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                                new_max + n * hw, d_r + n * C * hw,
                                d_w + n * hw, d_logits + n * k2 * hw, h, w, k,
                                y, x);
}

template <int C>
void ddata_c(const void* logits, int logits_bf16, const float* new_max,
             const float* d_r, float* d_data, int bs, int h, int w, int k) {
  if (logits_bf16)
    run_ddata<C>(static_cast<const uint16_t*>(logits), new_max, d_r, d_data,
                 bs, h, w, k);
  else
    run_ddata<C>(static_cast<const float*>(logits), new_max, d_r, d_data, bs,
                 h, w, k);
}

template <int C>
void dlogits_c(const float* data, const void* logits, int logits_bf16,
               const float* new_max, const float* d_r, const float* d_w,
               void* d_logits, int bs, int h, int w, int k) {
  if (logits_bf16)
    run_dlogits<C>(data, static_cast<const uint16_t*>(logits), new_max, d_r,
                   d_w, static_cast<uint16_t*>(d_logits), bs, h, w, k);
  else
    run_dlogits<C>(data, static_cast<const float*>(logits), new_max, d_r, d_w,
                   static_cast<float*>(d_logits), bs, h, w, k);
}

}  // namespace

// Same arguments as the CUDA entry points, minus the stream. Both return 0,
// or 1 for a channel count other than 2 or 3 (the kernels' template set).

extern "C" int sbmc_progressive_splat_ddata_host(
    const void* logits, int logits_bf16, const float* new_max,
    const float* d_r, float* d_data, int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      ddata_c<2>(logits, logits_bf16, new_max, d_r, d_data, bs, h, w, k);
      return 0;
    case 3:
      ddata_c<3>(logits, logits_bf16, new_max, d_r, d_data, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}

extern "C" int sbmc_progressive_splat_dlogits_host(
    const float* data, const void* logits, int logits_bf16,
    const float* new_max, const float* d_r, const float* d_w, void* d_logits,
    int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      dlogits_c<2>(data, logits, logits_bf16, new_max, d_r, d_w, d_logits, bs,
                   h, w, k);
      return 0;
    case 3:
      dlogits_c<3>(data, logits, logits_bf16, new_max, d_r, d_w, d_logits, bs,
                   h, w, k);
      return 0;
    default:
      return 1;
  }
}
