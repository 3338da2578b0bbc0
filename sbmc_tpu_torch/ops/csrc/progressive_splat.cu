// Fused progressive splat step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_psf_kernel` (launched by
// `progressive_splat_fused_pallas`, sbmc_tpu/ops/pallas_kernels.py:535).
// One sample's online-softmax splat update:
//
//   m'     = max(max_w, max_t g_t)
//   sum_r' = sum_r * exp(max_w - m') + sum_t exp(g_t - m') * data[p + d_t]
//   sum_w' = sum_w * exp(max_w - m') + sum_t exp(g_t - m')
//
// where g is the gather (transposed) form of the splat logits, read straight
// from the splat logits with the flipped, shifted index (see
// progressive_splat.cuh).
//
// What bounds it on this card: the k^2-plane logits stream. At the flagship
// k = 21 every pixel reads 441 logits and writes 5 floats, so the kernel is
// memory-bound on k2*h*w*itemsize bytes of logits per sample step (1.95 GB
// for a bf16 1080x2048 tile, ~0.58 ms at 3.35 TB/s); the arithmetic, one exp
// and C+1 FMAs per tap, is far below the card's rate.
//
// What the design does about it: the transposed tensor is never written to
// device memory (the composed version writes and re-reads it), the running
// max is folded into the same loop so each logit is read exactly once, and
// one thread per output pixel with x fastest across threadIdx.x makes each
// warp's read of a tap plane one contiguous row segment. The data planes are
// small and re-read by all k^2 taps, so they stay in L1/L2. Element offsets
// are 64-bit: k2*h*w exceeds 2^31 at a 1080x2048 tile once bs >= 3.

#include <cuda_runtime.h>

#include "progressive_splat.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    psf_kernel(const float* __restrict__ data, const T* __restrict__ logits,
               const float* __restrict__ sum_r, const float* __restrict__ sum_w,
               const float* __restrict__ max_w, float* __restrict__ out_r,
               float* __restrict__ out_w, float* __restrict__ out_m, int h,
               int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  psf_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw, sum_r + n * C * hw,
                  sum_w + n * hw, max_w + n * hw, out_r + n * C * hw,
                  out_w + n * hw, out_m + n * hw, h, w, k, y, x);
}

template <int C, typename T>
void launch(const float* data, const void* logits, const float* sum_r,
            const float* sum_w, const float* max_w, float* out_r, float* out_w,
            float* out_m, int bs, int h, int w, int k, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, bs);
  psf_kernel<C, T><<<grid, block, 0, stream>>>(
      data, static_cast<const T*>(logits), sum_r, sum_w, max_w, out_r, out_w,
      out_m, h, w, k);
}

template <int C>
void launch_c(const float* data, const void* logits, int logits_bf16,
              const float* sum_r, const float* sum_w, const float* max_w,
              float* out_r, float* out_w, float* out_m, int bs, int h, int w,
              int k, cudaStream_t stream) {
  if (logits_bf16) {
    launch<C, uint16_t>(data, logits, sum_r, sum_w, max_w, out_r, out_w, out_m,
                        bs, h, w, k, stream);
  } else {
    launch<C, float>(data, logits, sum_r, sum_w, max_w, out_r, out_w, out_m, bs,
                     h, w, k, stream);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (a refused
// launch is reported here, not by a later synchronise). Returns
// cudaErrorInvalidValue for a channel count other than 2 or 3 (radiance has
// 3; the tests also use 2). The caller checks shapes, dtypes, contiguity and
// the device.
extern "C" int sbmc_progressive_splat(const float* data, const void* logits,
                                      int logits_bf16, const float* sum_r,
                                      const float* sum_w, const float* max_w,
                                      float* out_r, float* out_w, float* out_m,
                                      int bs, int c, int h, int w, int k,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 2:
      launch_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
                  out_m, bs, h, w, k, s);
      break;
    case 3:
      launch_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
                  out_m, bs, h, w, k, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
