// scatter2gather for Hopper (sm_90a): transposes per-pixel splat kernels
// into gather kernels (and back: the op is its own adjoint); and
// scatter2gather_max, the same transpose with the per-pixel tap max.
//
// s2g replaces the Pallas TPU kernel `_s2g_kernel` (launched by
// `scatter2gather_pallas`, sbmc_tpu/ops/pallas_kernels.py:393):
//
//   out[dy*k + dx, p] = w[(k-1-dy)*k + (k-1-dx), p + (dy-o, dx-o)]
//
// with 0 outside the image (see scatter2gather.cuh). It keeps the dtype.
//
// What bounds it on this card: bytes, and nothing else: it reads the
// k^2-plane tensor once and writes one of the same size, with no arithmetic.
//
// What the design does about it: one thread per output element, x fastest
// across threadIdx.x, so a warp's write is one contiguous row segment of
// output plane t and its read one contiguous row segment of input plane
// `flip t`, shifted by d_t: both sides of the move are coalesced, every
// element crosses device memory once each way, and nothing is staged. A
// bounds test takes the place of the TPU kernel's padded copy and its
// double-buffered row DMA. bfloat16 moves as 16-bit patterns, so the result
// is bit-exact in both types. No atomics; element offsets are 64-bit.
//
// s2g_max replaces `_s2g_max_kernel` (launched by
// `scatter2gather_max_pallas`, pallas_kernels.py:419): the same output, plus
// kmax[p] = max_t float(out[t, p]) in float32, the zero-padded taps
// included (the Pallas kernel starts from -inf and maxes every written
// value). Bound by bytes as s2g is, plus one float32 plane written.
//
// What its design does about it: the max is a reduction over the taps of a
// pixel, so one thread owns one pixel and walks its k^2 taps in registers,
// with no shared memory and no second pass. x fastest across threadIdx.x
// keeps both sides of every tap's move coalesced: the warp reads a row
// segment of plane `flip t` shifted by d_t and writes a row segment of
// plane t. bfloat16 moves as 16-bit patterns (bit-exact) and is widened to
// float32 only for the compare, since a compare of raw bfloat16 bits orders
// negative numbers backwards. The image blocks sit on gridDim.x and the
// batch on gridDim.y, so no grid dimension passes 65535 at any image size.

#include <cuda_runtime.h>

#include "scatter2gather.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// grid: x = row-blocks * column-blocks of the image (the dimension that may
// pass 65535), y = output tap, z = batch item.
template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    s2g_kernel(const T* __restrict__ weights, T* __restrict__ out, int h,
               int w, int k, int blocks_x) {
  const int by = blockIdx.x / blocks_x;
  const int bx = blockIdx.x - by * blocks_x;
  const int x = bx * kBlockX + threadIdx.x;
  const int y = by * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.z;
  const int64_t item = static_cast<int64_t>(k) * k * h * w;
  s2g_element<T>(weights + n * item, out + n * item, h, w, k,
                 static_cast<int>(blockIdx.y), y, x);
}

// grid: x = row-blocks * column-blocks of the image, y = batch item.
template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    s2g_max_kernel(const T* __restrict__ weights, T* __restrict__ out,
                   float* __restrict__ kmax, int h, int w, int k,
                   int blocks_x) {
  const int by = blockIdx.x / blocks_x;
  const int bx = blockIdx.x - by * blocks_x;
  const int x = bx * kBlockX + threadIdx.x;
  const int y = by * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t n = blockIdx.y;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t item = static_cast<int64_t>(k) * k * hw;
  s2g_max_pixel<T>(weights + n * item, out + n * item, kmax + n * hw, h, w,
                   k, y, x);
}

template <typename T>
void launch_max(const void* weights, void* out, float* kmax, int bs, int h,
                int w, int k, cudaStream_t stream) {
  const int blocks_x = (w + kBlockX - 1) / kBlockX;
  const int blocks_y = (h + kBlockY - 1) / kBlockY;
  s2g_max_kernel<T><<<dim3(blocks_x * blocks_y, bs), dim3(kBlockX, kBlockY),
                      0, stream>>>(static_cast<const T*>(weights),
                                   static_cast<T*>(out), kmax, h, w, k,
                                   blocks_x);
}

template <typename T>
void launch(const void* weights, void* out, int bs, int h, int w, int k,
            cudaStream_t stream) {
  const int blocks_x = (w + kBlockX - 1) / kBlockX;
  const int blocks_y = (h + kBlockY - 1) / kBlockY;
  s2g_kernel<T><<<dim3(blocks_x * blocks_y, k * k, bs),
                  dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const T*>(weights), static_cast<T*>(out), h, w, k,
      blocks_x);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (a refused launch is
// reported here, not by a later synchronise). `itemsize` is 4 (float32) or
// 2 (bfloat16); anything else returns cudaErrorInvalidValue. The caller
// checks shapes, dtypes, contiguity and the device.

extern "C" int sbmc_scatter2gather(const void* weights, int itemsize,
                                   void* out, int bs, int h, int w, int k,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    launch<float>(weights, out, bs, h, w, k, s);
  else if (itemsize == 2)
    launch<uint16_t>(weights, out, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbmc_scatter2gather_max(const void* weights, int itemsize,
                                       void* out, float* kmax, int bs, int h,
                                       int w, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    launch_max<float>(weights, out, kmax, bs, h, w, k, s);
  else if (itemsize == 2)
    launch_max<uint16_t>(weights, out, kmax, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
