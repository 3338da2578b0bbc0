// Host build of kernel weighting, of its gradient to the weights and of its
// exp variant: the kernels' per-pixel functions (kernel_weighting.cuh) run in
// plain loops. It exists so the CPU tests can check the kernels' index math
// (p + d_t, the image bounds, sum_w over every tap, the in-register exp)
// against the plain PyTorch versions without a GPU:
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

}  // namespace

// Same arguments as the CUDA entry points, minus the stream. All return 0,
// or 1 for a channel count other than 2 or 3 (the kernels' template set).

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
