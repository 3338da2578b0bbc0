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
// once (k2*h*w*itemsize per batch item) and writes C planes; d_L reads the
// logits and writes a gradient of the same size. The arithmetic, one exp
// and C or C+1 FMAs per tap, is below the card's rate.
//
// What the designs do about it: the composed version transposes the
// k^2-plane tensor through device memory three times (e, s2g(e),
// s2g(e * d_e)); here the flip/shift algebra puts every halo on the small
// m, d_w and d_r planes, so each kernel reads every logit exactly once, at
// the thread's own pixel. d_L is written in the logits' own type (bf16 by
// round-to-nearest-even), so no float32 copy of it ever exists. All are
// gathers without atomics: the result is deterministic. Element offsets are
// 64-bit.
//
// psb_ddata and psb_dlogits_generic: one thread per pixel, x fastest across
// threadIdx.x, a serial loop over the k^2 taps; the small planes are re-read
// by all taps from L1/L2. psb_dlogits_generic takes the shapes the vector
// kernel cannot (ops.splat_route): odd widths, other k.
//
// psb_dlogits_vec, the vector kernel of d_L, for k in {3, 5, 21} and w *
// itemsize a multiple of 16 bytes (every shape the model paths give it). d_L
// has no reduction over taps, so every (pixel, tap row) pair is independent:
// a thread owns 16 bytes of consecutive pixels (4 float32 or 8 bfloat16
// logits) and a tap row, and per tap moves them with one 16-byte load of L
// and one 16-byte store of d_L, where the generic kernel moved 2 or 4 bytes
// per access. A block owns an 8 x 64 pixel tile: 128 (float32) or 64
// (bfloat16) vectors, so its 256 threads form 2 or 4 groups, each taking
// every 2nd or 4th tap row; the grid's y splits the rows further where the
// tiles alone would give fewer than three blocks per SM (the training
// batch of 4 x 128 x 128: 128 tiles, so rows in 4 blocks;
// ops.dlogits_row_blocks chooses). The block stages m, d_w and d_r with a
// halo of o once in shared memory (m = +inf and zeros outside the image,
// which makes that tap's gradient exactly 0), de-interleaved by column
// residue modulo the vector width, so the threads of a warp read
// neighbouring words at every tap.
// With k unrolled, a thread has its row's k 16-byte loads in flight at
// once.

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
    psb_dlogits_generic(const float* __restrict__ data,
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
void launch_dlogits_generic(const float* data, const void* logits,
                            const float* new_max, const float* d_r,
                            const float* d_w, void* d_logits, int bs, int h,
                            int w, int k, cudaStream_t stream) {
  psb_dlogits_generic<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                              stream>>>(data, static_cast<const T*>(logits),
                                        new_max, d_r, d_w,
                                        static_cast<T*>(d_logits), h, w, k);
}

// -------------------------------------------------------- psb_dlogits_vec

constexpr int kVecTileH = 8;
constexpr int kVecTileW = 64;
constexpr int kVecThreads = 256;

template <int K, typename T>
struct VecLayout {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int kHaloH = kVecTileH + K - 1;
  static constexpr int kHaloW = kVecTileW + K - 1;
  static constexpr int kCols = (kHaloW + V - 1) / V;  // per column residue
  static constexpr int kRow = kCols * V;              // halo row stride
  static constexpr int kVecsPerRow = kVecTileW / V;
  static constexpr int kItems = kVecTileH * kVecsPerRow;  // vectors per tile
  static constexpr int kGroups = kVecThreads / kItems;
  // A float4 (d_w, d_r) and a float m per halo pixel.
  static constexpr int kBytes = kHaloH * kRow * (16 + 4);
};

// The small planes of one work item's tap row in shared memory: halo
// column col of the item lives at base + (col % V) * kCols + col / V.
template <int C, int V, int kCols>
struct HaloSmall {
  const float4* a;
  const float* m;
  int base;
  __host__ __device__ void get(int col, float& mv,
                               float (&av)[C + 1]) const {
    const int i = base + (col % V) * kCols + col / V;
    const float4 q = a[i];
    mv = m[i];
    av[0] = q.x;
    av[1] = q.y;
    av[2] = q.z;
    if constexpr (C > 2) av[3] = q.w;
  }
};

template <int C, int K, typename T>
__global__ void __launch_bounds__(kVecThreads)
    psb_dlogits_vec(const float* __restrict__ data,
                    const T* __restrict__ logits,
                    const float* __restrict__ new_max,
                    const float* __restrict__ d_r,
                    const float* __restrict__ d_w, T* __restrict__ d_logits,
                    int h, int w, int tiles_x) {
  using L = VecLayout<K, T>;
  constexpr int V = L::V;
  constexpr int kO = (K - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sa = reinterpret_cast<float4*>(smem);
  float* sm = reinterpret_cast<float*>(smem + L::kHaloH * L::kRow * 16);

  const int n = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_x) * kVecTileH;
  const int x0 = (blockIdx.x % tiles_x) * kVecTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t nhw = static_cast<int64_t>(n) * hw;

  for (int i = threadIdx.x; i < L::kHaloH * L::kHaloW; i += kVecThreads) {
    const int hy = i / L::kHaloW, hx = i % L::kHaloW;
    const int gy = y0 - kO + hy, gx = x0 - kO + hx;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int64_t q = static_cast<int64_t>(gy) * w + gx;
      m = new_max[nhw + q];
      a.x = d_w[nhw + q];
      a.y = d_r[(static_cast<int64_t>(n) * C) * hw + q];
      a.z = d_r[(static_cast<int64_t>(n) * C + 1) * hw + q];
      if constexpr (C > 2)
        a.w = d_r[(static_cast<int64_t>(n) * C + 2) * hw + q];
    }
    const int at = hy * L::kRow + (hx % V) * L::kCols + hx / V;
    sa[at] = a;
    sm[at] = m;
  }
  __syncthreads();

  const int item = threadIdx.x % L::kItems;
  const int group = threadIdx.x / L::kItems;
  const int ty = item / L::kVecsPerRow, vx = item % L::kVecsPerRow;
  const int y = y0 + ty, x = x0 + vx * V;
  if (y >= h || x >= w) return;  // w is a multiple of V: no partial vector
  const int64_t p = static_cast<int64_t>(y) * w + x;
  float dat[V][C];
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c)
      dat[j][c] = data[(static_cast<int64_t>(n) * C + c) * hw + p + j];
  const int64_t k2hw = static_cast<int64_t>(K) * K * hw;
  const T* ln = logits + n * k2hw;
  T* gn = d_logits + n * k2hw;
  const int step = gridDim.y * L::kGroups;
  for (int dy = blockIdx.y + gridDim.y * group; dy < K; dy += step)
    psb_dlogits_row<C, K, V>(
        dat, ln, gn, hw, p, dy,
        HaloSmall<C, V, L::kCols>{sa, sm, (ty + dy) * L::kRow + vx});
}

template <int C, int K, typename T>
int launch_dlogits_vec(const float* data, const void* logits,
                       const float* new_max, const float* d_r,
                       const float* d_w, void* d_logits, int bs, int h, int w,
                       int row_blocks, cudaStream_t stream) {
  using L = VecLayout<K, T>;
  if (row_blocks < 1 || row_blocks > K)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = psb_dlogits_vec<C, K, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kVecTileW - 1) / kVecTileW;
  const int tiles_y = (h + kVecTileH - 1) / kVecTileH;
  kernel<<<dim3(tiles_x * tiles_y, row_blocks, bs), kVecThreads, L::kBytes,
           stream>>>(data, static_cast<const T*>(logits), new_max, d_r, d_w,
                     static_cast<T*>(d_logits), h, w, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename T>
int dlogits_vec_k(const float* data, const void* logits, const float* new_max,
                  const float* d_r, const float* d_w, void* d_logits, int bs,
                  int h, int w, int k, int row_blocks, cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch_dlogits_vec<C, 3, T>(data, logits, new_max, d_r, d_w,
                                         d_logits, bs, h, w, row_blocks,
                                         stream);
    case 5:
      return launch_dlogits_vec<C, 5, T>(data, logits, new_max, d_r, d_w,
                                         d_logits, bs, h, w, row_blocks,
                                         stream);
    case 21:
      return launch_dlogits_vec<C, 21, T>(data, logits, new_max, d_r, d_w,
                                          d_logits, bs, h, w, row_blocks,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() (a refused
// launch is reported here, not by a later synchronise), or
// cudaErrorInvalidValue for a channel count other than 2 or 3 and, for the
// vector kernel, k outside {3, 5, 21}, row_blocks outside 1..k, logits or
// d_logits not 16-byte aligned or w * itemsize not a multiple of 16. The
// caller checks shapes, dtypes, contiguity and the device.

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
    int bs, int c, int h, int w, int k, int row_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(logits) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_logits) % 16 != 0 ||
      (static_cast<int64_t>(w) * (logits_bf16 ? 2 : 4)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 2 && logits_bf16)
    return dlogits_vec_k<2, uint16_t>(data, logits, new_max, d_r, d_w,
                                      d_logits, bs, h, w, k, row_blocks, s);
  if (c == 2)
    return dlogits_vec_k<2, float>(data, logits, new_max, d_r, d_w, d_logits,
                                   bs, h, w, k, row_blocks, s);
  if (c == 3 && logits_bf16)
    return dlogits_vec_k<3, uint16_t>(data, logits, new_max, d_r, d_w,
                                      d_logits, bs, h, w, k, row_blocks, s);
  if (c == 3)
    return dlogits_vec_k<3, float>(data, logits, new_max, d_r, d_w, d_logits,
                                   bs, h, w, k, row_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sbmc_progressive_splat_dlogits_generic(
    const float* data, const void* logits, int logits_bf16,
    const float* new_max, const float* d_r, const float* d_w, void* d_logits,
    int bs, int c, int h, int w, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_dlogits_generic<2, uint16_t>(data, logits, new_max, d_r, d_w,
                                        d_logits, bs, h, w, k, s);
  else if (c == 2)
    launch_dlogits_generic<2, float>(data, logits, new_max, d_r, d_w,
                                     d_logits, bs, h, w, k, s);
  else if (c == 3 && logits_bf16)
    launch_dlogits_generic<3, uint16_t>(data, logits, new_max, d_r, d_w,
                                        d_logits, bs, h, w, k, s);
  else if (c == 3)
    launch_dlogits_generic<3, float>(data, logits, new_max, d_r, d_w,
                                     d_logits, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
