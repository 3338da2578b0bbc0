// Kernel weighting, its gradient to the weights and kernel weighting with
// the softmax exponential fused in, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kw_fwd_kernel` (launched by
// `kernel_weighting_fwd_pallas`, sbmc_tpu/ops/pallas_kernels.py:151),
// `_kw_dw_kernel` (launched by `kernel_weighting_dw_pallas`, :321) and
// `_kw_exp_kernel` (launched by `kernel_weighting_exp_pallas`, :232):
//
//   kw_fwd: out[c, p] = sum_t w[t, p] * data[c, p + d_t]
//           sum_w[p]  = sum_t w[t, p]
//   kw_dw:  d_w[t, p] = d_sum_w[p] + sum_c data[c, p + d_t] * d_out[c, p]
//   kw_exp: kw_fwd with w[t, p] = exp(logits[t, p] - maxes[p])
//
// (see kernel_weighting.cuh; data outside the image is 0, and every tap
// counts in sum_w).
//
// What bounds them on this card: bytes. kw_fwd reads the k^2-plane weights
// once (k2*h*w*itemsize per batch item, 441 planes at k = 21) against C
// planes of data and C + 1 planes of output; kw_dw writes a float32 tensor
// of that size once. The arithmetic, C FMAs and an add per tap, is far below
// the card's rate.
//
// What the design does about it: the k^2-plane tensor crosses device memory
// exactly once per kernel, at the thread's own pixel. One thread per pixel
// with x fastest across threadIdx.x makes a warp's read of weight plane t
// (or its write of gradient plane t) one contiguous row segment; the halo
// falls on the C-plane data, which all k^2 taps re-read and which stays in
// L1/L2. A bounds test takes the place of the TPU kernel's padded copies.
// bfloat16 weights are widened in registers, so no float32 copy of them ever
// exists. Both are gathers without atomics: the result is deterministic.
// Element offsets are 64-bit (k2*h*w passes 2^31 at batch 3 of 1080x2048).
//
// kw_exp is kw_fwd's design with one more float32 plane read (maxes, at the
// thread's own pixel) and each weight formed in registers as
// expf(float(logit) - max): the exponentiated k^2-plane tensor never exists
// in device memory, which is what the Pallas kernel fuses it for. Its bound
// is bytes as kw_fwd's is (one expf per tap stays far below the card's
// rate). expf is the accurate float32 exponential (no fast-math, no exp2
// rescale), as the JAX package's plain version computes it.

#include <cuda_runtime.h>

#include "kernel_weighting.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    kw_fwd_kernel(const float* __restrict__ data,
                  const T* __restrict__ weights, float* __restrict__ out,
                  float* __restrict__ sum_w, int h, int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  kw_fwd_pixel<C, T>(data + n * C * hw, weights + n * k2 * hw,
                     out + n * C * hw, sum_w + n * hw, h, w, k, y, x);
}

template <int C>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    kw_dw_kernel(const float* __restrict__ data,
                 const float* __restrict__ d_out,
                 const float* __restrict__ d_sum_w, float* __restrict__ d_w,
                 int h, int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  kw_dw_pixel<C>(data + n * C * hw, d_out + n * C * hw, d_sum_w + n * hw,
                 d_w + n * k2 * hw, h, w, k, y, x);
}

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    kw_exp_kernel(const float* __restrict__ data,
                  const T* __restrict__ logits,
                  const float* __restrict__ maxes, float* __restrict__ out,
                  float* __restrict__ sum_w, int h, int w, int k) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  kw_exp_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw, maxes + n * hw,
                     out + n * C * hw, sum_w + n * hw, h, w, k, y, x);
}

dim3 grid_of(int bs, int h, int w) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, bs);
}

template <int C, typename T>
void launch_fwd(const float* data, const void* weights, float* out,
                float* sum_w, int bs, int h, int w, int k,
                cudaStream_t stream) {
  kw_fwd_kernel<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                        stream>>>(data, static_cast<const T*>(weights), out,
                                  sum_w, h, w, k);
}

template <int C>
void launch_dw(const float* data, const float* d_out, const float* d_sum_w,
               float* d_w, int bs, int h, int w, int k, cudaStream_t stream) {
  kw_dw_kernel<C><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0, stream>>>(
      data, d_out, d_sum_w, d_w, h, w, k);
}

template <int C, typename T>
void launch_exp(const float* data, const void* logits, const float* maxes,
                float* out, float* sum_w, int bs, int h, int w, int k,
                cudaStream_t stream) {
  kw_exp_kernel<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                        stream>>>(data, static_cast<const T*>(logits), maxes,
                                  out, sum_w, h, w, k);
}

}  // namespace

// The three functions launch on `stream` and return cudaGetLastError() (a
// refused launch is reported here, not by a later synchronise), or
// cudaErrorInvalidValue for a channel count other than 2 or 3. The caller
// checks shapes, dtypes, contiguity and the device.

extern "C" int sbmc_kernel_weighting(const float* data, const void* weights,
                                     int weights_bf16, float* out,
                                     float* sum_w, int bs, int c, int h, int w,
                                     int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && weights_bf16)
    launch_fwd<2, uint16_t>(data, weights, out, sum_w, bs, h, w, k, s);
  else if (c == 2)
    launch_fwd<2, float>(data, weights, out, sum_w, bs, h, w, k, s);
  else if (c == 3 && weights_bf16)
    launch_fwd<3, uint16_t>(data, weights, out, sum_w, bs, h, w, k, s);
  else if (c == 3)
    launch_fwd<3, float>(data, weights, out, sum_w, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbmc_kernel_weighting_dw(const float* data, const float* d_out,
                                        const float* d_sum_w, float* d_w,
                                        int bs, int c, int h, int w, int k,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2)
    launch_dw<2>(data, d_out, d_sum_w, d_w, bs, h, w, k, s);
  else if (c == 3)
    launch_dw<3>(data, d_out, d_sum_w, d_w, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbmc_kernel_weighting_exp(const float* data, const void* logits,
                                         int logits_bf16, const float* maxes,
                                         float* out, float* sum_w, int bs,
                                         int c, int h, int w, int k,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_exp<2, uint16_t>(data, logits, maxes, out, sum_w, bs, h, w, k, s);
  else if (c == 2)
    launch_exp<2, float>(data, logits, maxes, out, sum_w, bs, h, w, k, s);
  else if (c == 3 && logits_bf16)
    launch_exp<3, uint16_t>(data, logits, maxes, out, sum_w, bs, h, w, k, s);
  else if (c == 3)
    launch_exp<3, float>(data, logits, maxes, out, sum_w, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
