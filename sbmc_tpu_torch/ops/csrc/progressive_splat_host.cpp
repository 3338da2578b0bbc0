// Host build of the fused progressive splat step: the kernel's per-pixel
// function (progressive_splat.cuh) run in a plain loop. It exists so the CPU
// tests can check the kernel's index math and online softmax against the
// plain PyTorch version without a GPU:
//
//   g++ -O2 -shared -fPIC -o libpsf_host.so progressive_splat_host.cpp

#include "progressive_splat.cuh"

namespace {

template <int C, typename T>
void run(const float* data, const T* logits, const float* sum_r,
         const float* sum_w, const float* max_w, float* out_r, float* out_w,
         float* out_m, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psf_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                        sum_r + n * C * hw, sum_w + n * hw, max_w + n * hw,
                        out_r + n * C * hw, out_w + n * hw, out_m + n * hw, h,
                        w, k, y, x);
}

template <int C>
void run_c(const float* data, const void* logits, int logits_bf16,
           const float* sum_r, const float* sum_w, const float* max_w,
           float* out_r, float* out_w, float* out_m, int bs, int h, int w,
           int k) {
  if (logits_bf16)
    run<C>(data, static_cast<const uint16_t*>(logits), sum_r, sum_w, max_w,
           out_r, out_w, out_m, bs, h, w, k);
  else
    run<C>(data, static_cast<const float*>(logits), sum_r, sum_w, max_w, out_r,
           out_w, out_m, bs, h, w, k);
}

}  // namespace

// Same arguments as sbmc_progressive_splat, minus the stream. Returns 0, or
// 1 for a channel count other than 2 or 3 (the kernel's template set).
extern "C" int sbmc_progressive_splat_host(
    const float* data, const void* logits, int logits_bf16, const float* sum_r,
    const float* sum_w, const float* max_w, float* out_r, float* out_w,
    float* out_m, int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      run_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
               out_m, bs, h, w, k);
      return 0;
    case 3:
      run_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
               out_m, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}
