// Backward of the fused progressive splat step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_psb_ddata_kernel` and
// `_psb_dlogits_kernel` (both launched by `progressive_splat_bwd_pallas`,
// sbmc_tpu/ops/pallas_kernels.py:728 and :755). With e[t, p] =
// exp(L[t, p] - m[p + d_t]), m the forward's running max after the update:
//
//   psb_ddata:   d_data[c, p] = sum_t e[t, p] * d_r[c, p + d_t]
//   psb_dlogits: d_L[t, p]    = e[t, p] * (d_w[p + d_t]
//                                          + sum_c data[c, p] * d_r[c, p + d_t])
//
// (see progressive_splat_bwd.cuh; pairs with p + d_t outside the image
// contribute 0).
//
// What bounds them on this card: bytes. psb_ddata reads the k^2-plane logits
// once (k2*h*w*itemsize per batch item) and writes C planes; psb_dlogits
// reads the logits and writes a gradient of the same size. The arithmetic,
// one exp and C or C+1 FMAs per tap, is far below the card's rate.
//
// What the design does about it: the composed version transposes the
// k^2-plane tensor through device memory three times (e, s2g(e),
// s2g(e * d_e)); here the flip/shift algebra puts every halo on the small
// m, d_w and d_r planes, so each kernel reads every logit exactly once, at
// the thread's own pixel. One thread per pixel with x fastest across
// threadIdx.x makes a warp's read of logit plane t, and its write of
// gradient plane t, one contiguous row segment; the small planes are
// re-read by all k^2 taps and stay in L1/L2. d_L is written in the logits'
// own type (bf16 by round-to-nearest-even), so no float32 copy of it ever
// exists. Both are gathers without atomics: the result is deterministic.
// Element offsets are 64-bit, as in the forward.

#include <cuda_runtime.h>

#include "progressive_splat_bwd.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    psb_ddata_kernel(const T* __restrict__ logits,
                     const float* __restrict__ new_max,
                     const float* __restrict__ d_r, float* __restrict__ d_data,
                     int h, int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  psb_ddata_pixel<C, T>(logits + n * k2 * hw, new_max + n * hw,
                        d_r + n * C * hw, d_data + n * C * hw, h, w, k, y, x);
}

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    psb_dlogits_kernel(const float* __restrict__ data,
                       const T* __restrict__ logits,
                       const float* __restrict__ new_max,
                       const float* __restrict__ d_r,
                       const float* __restrict__ d_w, T* __restrict__ d_logits,
                       int h, int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  psb_dlogits_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                          new_max + n * hw, d_r + n * C * hw, d_w + n * hw,
                          d_logits + n * k2 * hw, h, w, k, y, x);
}

dim3 grid_of(int bs, int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, bs);
}

template <int C, typename T>
void launch_ddata(const void* logits, const float* new_max, const float* d_r,
                  float* d_data, int bs, int h, int w, int k,
                  cudaStream_t stream) {
  psb_ddata_kernel<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                           stream>>>(static_cast<const T*>(logits), new_max,
                                     d_r, d_data, h, w, k);
}

template <int C, typename T>
void launch_dlogits(const float* data, const void* logits,
                    const float* new_max, const float* d_r, const float* d_w,
                    void* d_logits, int bs, int h, int w, int k,
                    cudaStream_t stream) {
  psb_dlogits_kernel<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                             stream>>>(data, static_cast<const T*>(logits),
                                       new_max, d_r, d_w,
                                       static_cast<T*>(d_logits), h, w, k);
}

}  // namespace

// Both functions launch on `stream` and return cudaGetLastError() (a refused
// launch is reported here, not by a later synchronise), or
// cudaErrorInvalidValue for a channel count other than 2 or 3. The caller
// checks shapes, dtypes, contiguity and the device.

extern "C" int sbmc_progressive_splat_ddata(const void* logits,
                                            int logits_bf16,
                                            const float* new_max,
                                            const float* d_r, float* d_data,
                                            int bs, int c, int h, int w, int k,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_ddata<2, uint16_t>(logits, new_max, d_r, d_data, bs, h, w, k, s);
  else if (c == 2)
    launch_ddata<2, float>(logits, new_max, d_r, d_data, bs, h, w, k, s);
  else if (c == 3 && logits_bf16)
    launch_ddata<3, uint16_t>(logits, new_max, d_r, d_data, bs, h, w, k, s);
  else if (c == 3)
    launch_ddata<3, float>(logits, new_max, d_r, d_data, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbmc_progressive_splat_dlogits(
    const float* data, const void* logits, int logits_bf16,
    const float* new_max, const float* d_r, const float* d_w, void* d_logits,
    int bs, int c, int h, int w, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_dlogits<2, uint16_t>(data, logits, new_max, d_r, d_w, d_logits, bs,
                                h, w, k, s);
  else if (c == 2)
    launch_dlogits<2, float>(data, logits, new_max, d_r, d_w, d_logits, bs, h,
                             w, k, s);
  else if (c == 3 && logits_bf16)
    launch_dlogits<3, uint16_t>(data, logits, new_max, d_r, d_w, d_logits, bs,
                                h, w, k, s);
  else if (c == 3)
    launch_dlogits<3, float>(data, logits, new_max, d_r, d_w, d_logits, bs, h,
                             w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
