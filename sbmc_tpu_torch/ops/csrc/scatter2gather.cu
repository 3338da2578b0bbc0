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
// s2g_vec, the vector kernel, for k in {3, 5, 21} (ops.s2g_route) and every
// width. Each output plane t is input plane k*k-1-t shifted by d_t and
// zero-filled: a 2-D shifted copy. The first port's kernel moved one 2- or
// 4-byte element per thread, with its own div/mod and bounds test, a single
// load in flight and a read misaligned by dx - o elements: a warp stored 64
// bytes (bfloat16), at 22% of the bound at 1080x2048. Here:
//
// - A work item is V consecutive elements of an output row, V * itemsize
//   the widest of 16, 8, 4 or 2 bytes that divides the row's bytes and both
//   bases (ops.s2g_pixels): 16 at every path width but the gradient phase's
//   odd 53 (and KPCN's 92 in bfloat16, 8 bytes).
// - The misaligned source is realigned in registers: the item loads the two
//   aligned vectors that cover its source (read-only path) and takes its
//   bytes out of them with funnel shifts. The shift is the same for every
//   item of a plane, and each aligned vector lies wholly inside or outside
//   the row, so an edge costs a predicated load that reads as zero and no
//   per-element test. The neighbouring item's second vector is this one's
//   first: L1 serves it, and device memory sees each byte once. Staging
//   rows in shared memory (cp.async or TMA) would add a pass through it
//   for no fewer bytes; TMA would also need its boxes aligned down and
//   widened (see progressive_splat.cu), and the zeros at the edges written
//   by hand.
// - A block of 256 threads owns 1024 consecutive items of one plane (16 KB
//   at 16-byte items); each thread takes four of them, 256 items apart, and
//   issues their eight loads before the first store, so a warp moves 512
//   contiguous bytes per access and every thread has its loads in flight
//   together. The plane is contiguous, so a block's items run across rows:
//   one division per item finds the row.
// - Writes are 16-byte streaming stores (st.global.cs).
// - The grid's x holds (batch item, plane, chunk of 1024 items): no
//   dimension passes 65535 at any image size.
// It moves bits: bit-exact in both types.
//
// s2g_generic, the first port's kernel, kept as it was for the kernel sizes
// the vector kernel is not built for: one thread per output element, x
// fastest across threadIdx.x, a bounds test per element. bfloat16 moves as
// 16-bit patterns in both kernels. No atomics; element offsets are 64-bit.
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
    s2g_generic(const T* __restrict__ weights, T* __restrict__ out, int h,
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

constexpr int kVecThreads = 256;
constexpr int kVecItems = 4;  // items per thread, their loads in flight
constexpr int kVecChunk = kVecThreads * kVecItems;

// grid: x = (batch item * K*K + output plane) * chunks + chunk of kVecChunk
// items of the plane.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kVecThreads)
    s2g_vec(const T* __restrict__ weights, T* __restrict__ out, int h, int w,
            int chunks) {
  constexpr int NB = V * static_cast<int>(sizeof(T));
  const int plane = blockIdx.x / chunks;  // n * K*K + t
  const int chunk = blockIdx.x - plane * chunks;
  const int t = plane % (K * K);
  const S2gPlane pl = s2g_plane<K, V>(t);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const T* src = weights + (static_cast<int64_t>(plane) - t + pl.src) * hw;
  T* dst = out + static_cast<int64_t>(plane) * hw;
  const int items = static_cast<int>(hw / V);
  const int first = chunk * kVecChunk + static_cast<int>(threadIdx.x);
  S2gBits<NB> v[kVecItems];
#pragma unroll
  for (int i = 0; i < kVecItems; ++i) {
    const int it = first + i * kVecThreads;
    if (it < items)
      s2g_vec_item<T, V>(src, h, w, it * V, pl.sy_off, pl.sx_off, pl.r,
                         v[i]);
  }
#pragma unroll
  for (int i = 0; i < kVecItems; ++i) {
    const int it = first + i * kVecThreads;
    if (it < items) s2g_store(dst + static_cast<int64_t>(it) * V, v[i]);
  }
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
void launch_generic(const void* weights, void* out, int bs, int h, int w,
                    int k, cudaStream_t stream) {
  const int blocks_x = (w + kBlockX - 1) / kBlockX;
  const int blocks_y = (h + kBlockY - 1) / kBlockY;
  s2g_generic<T><<<dim3(blocks_x * blocks_y, k * k, bs),
                   dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const T*>(weights), static_cast<T*>(out), h, w, k,
      blocks_x);
}

template <typename T, int V, int K>
int launch_vec(const void* weights, void* out, int bs, int h, int w,
               cudaStream_t stream) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t chunks = (hw / V + kVecChunk - 1) / kVecChunk;
  const int64_t blocks = chunks * bs * K * K;
  if (hw >= 0x7fffffff || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  s2g_vec<T, V, K><<<static_cast<unsigned>(blocks), kVecThreads, 0,
                     stream>>>(static_cast<const T*>(weights),
                               static_cast<T*>(out), h, w,
                               static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int vec_k(const void* weights, void* out, int bs, int h, int w, int k,
          cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch_vec<T, V, 3>(weights, out, bs, h, w, stream);
    case 5:
      return launch_vec<T, V, 5>(weights, out, bs, h, w, stream);
    case 21:
      return launch_vec<T, V, 21>(weights, out, bs, h, w, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int vec_v(const void* weights, void* out, int bs, int h, int w, int k, int v,
          cudaStream_t stream) {
  switch (v * static_cast<int>(sizeof(T))) {
    case 16:
      return vec_k<T, 16 / sizeof(T)>(weights, out, bs, h, w, k, stream);
    case 8:
      return vec_k<T, 8 / sizeof(T)>(weights, out, bs, h, w, k, stream);
    case 4:
      return vec_k<T, 4 / sizeof(T)>(weights, out, bs, h, w, k, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return vec_k<T, 1>(weights, out, bs, h, w, k, stream);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() (a refused
// launch is reported here, not by a later synchronise). `itemsize` is 4
// (float32) or 2 (bfloat16); anything else returns cudaErrorInvalidValue, as
// do, for the vector kernel, k outside {3, 5, 21}, planes of 2^31 elements
// or more, and items of `v` elements whose bytes are not 2, 4, 8 or 16 or do
// not divide w and both bases. The caller checks shapes, dtypes, contiguity
// and the device.

extern "C" int sbmc_scatter2gather(const void* weights, int itemsize,
                                   void* out, int bs, int h, int w, int k,
                                   int v, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb = static_cast<int64_t>(v) * itemsize;
  if (v < 1 || w % v != 0 || reinterpret_cast<uintptr_t>(weights) % nb ||
      reinterpret_cast<uintptr_t>(out) % nb)
    return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 4) return vec_v<float>(weights, out, bs, h, w, k, v, s);
  if (itemsize == 2) return vec_v<uint16_t>(weights, out, bs, h, w, k, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sbmc_scatter2gather_generic(const void* weights, int itemsize,
                                           void* out, int bs, int h, int w,
                                           int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4)
    launch_generic<float>(weights, out, bs, h, w, k, s);
  else if (itemsize == 2)
    launch_generic<uint16_t>(weights, out, bs, h, w, k, s);
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
