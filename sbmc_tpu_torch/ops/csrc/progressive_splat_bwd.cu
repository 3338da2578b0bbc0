// Backward of the fused progressive splat step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_psb_ddata_kernel` and
// `_psb_dlogits_kernel` (both launched by `progressive_splat_bwd_pallas`,
// sbmc_tpu/ops/pallas_kernels.py:728 and :755). With e[t, p] =
// exp(L[t, p] - m[p + d_t]), m the forward's running max after the update:
//
//   d_data:   d_data[c, p] = sum_t e[t, p] * d_r[c, p + d_t]
//   d_L:      d_L[t, p]    = e[t, p] * (d_w[p + d_t]
//                                          + sum_c data[c, p] * d_r[c, p + d_t])
//
// (see progressive_splat_bwd.cuh; pairs with p + d_t outside the image
// contribute 0).
//
// What bounds them on this card: bytes. d_data reads the k^2-plane logits
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
// psb_ddata_generic and psb_dlogits_generic, the first port's kernels: one
// thread per pixel, x fastest across threadIdx.x, a serial loop over the
// k^2 taps; the small planes are re-read by all taps from L1/L2. They take
// the shapes the vector kernels cannot (ops.splat_route): odd widths, other
// k.
//
// psb_ddata_vec, the vector kernel of d_data, for the vector kernels' shapes
// (k in {3, 5, 21}, w * itemsize a multiple of 16). The generic kernel ran
// 441 dependent taps per thread, each a 2- or 4-byte load of L and 1 + C
// loads of m and d_r, on 65,536 threads at the training shape: 16% of its
// bound. It takes psb_dlogits_vec's work items and halo, and kw_fwd's join
// of groups of tap rows:
//
// - A thread owns a 16-byte vector of logits (4 float32 or 8 bfloat16
//   pixels) and, tap row by tap row, issues the row's k 16-byte loads of L
//   at once, then walks the row's V + k - 1 halo columns, each serving the
//   taps dx = s - j of its V pixels (progressive_splat_bwd.cuh). It keeps
//   C x V float32 sums. The logits stay raw (bfloat16 widened per use), so
//   a row's loads take 4k registers in either type; the kernel asks ptxas
//   for one block per SM at least, as kw_fwd does, so the row stays in
//   registers.
// - A block owns a tile 64 pixels wide. m (scaled by log2(e), +inf outside
//   the image, so that tap's weight is exp2(-inf) = 0) and d_r (zeros
//   outside) are staged once per tile in shared memory with a halo of o,
//   one float4 per pixel, de-interleaved by column residue modulo V so the
//   lanes of a warp read neighbouring float4s.
// - The block's 256 threads form G groups of tap rows (ops.ddata_groups:
//   the fewest of 1, 2, 4, 8 whose tiles, 64 / (G * itemsize) rows tall,
//   give 1.5 per SM: G = 4 at the float32 training batch, 8 in bfloat16, 1
//   at 1080x2048). Group g takes the tap rows g, g + G, ...; group 0 joins
//   the groups' sums through shared memory in group order (no atomics:
//   deterministic) and writes d_data with 16-byte streaming stores. Tap
//   rows are not split across blocks: a cluster of blocks sharing a tile's
//   rows through distributed shared memory was slower on the card at every
//   shape measured, since each block stages the whole halo again
//   (PERF.md).
// - exp(L - m) is exp2(fma(L, log2(e), -m * log2(e))), m * log2(e) formed
//   once per halo pixel: one FMA and one MUFU.EX2 (plus exp2f's range
//   fixup) per tap, within the check's tolerance (the generic kernel takes
//   expf, as the plain version does).
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
    psb_ddata_generic(const T* __restrict__ logits,
                      const float* __restrict__ new_max,
                      const float* __restrict__ d_r,
                      float* __restrict__ d_data, int h, int w, int k) {
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
void launch_ddata_generic(const void* logits, const float* new_max,
                          const float* d_r, float* d_data, int bs, int h,
                          int w, int k, cudaStream_t stream) {
  psb_ddata_generic<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
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

// --------------------------------------------------------- psb_ddata_vec

constexpr int kDdThreads = 256;
constexpr int kDdTileW = 64;

// A tile is 64 pixels wide (16 float32 or 8 bfloat16 vectors a row); its
// 256 threads form G groups of kDdThreads / G items, so it is
// kDdThreads / G / kVecsPerRow rows tall. The halo of the small planes is
// one float4 (m2, d_r[0..2]) per pixel, kCols per column residue modulo V.
template <int K, typename T>
struct DdLayout {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int kVecsPerRow = kDdTileW / V;
  static constexpr int kHaloW = kDdTileW + K - 1;
  static constexpr int kCols = (kHaloW + V - 1) / V;
  static constexpr int kRow = kCols * V;
  static __host__ __device__ int items(int groups) {
    return kDdThreads / groups;
  }
  static __host__ __device__ int rows(int groups) {
    return items(groups) / kVecsPerRow;
  }
  static __host__ __device__ int halo_bytes(int groups) {
    return (rows(groups) + K - 1) * kRow * 16;
  }
  // One slot of partial sums per group but the first, C * V floats per
  // item.
  static __host__ __device__ int bytes(int c, int groups) {
    return halo_bytes(groups) + (groups - 1) * c * V * items(groups) * 4;
  }
};

// A work item's view of the staged halo.
template <int C, int K, int V>
struct DdSmemSmall {
  const float4* s;
  int base;  // the item's tile row times kRow plus its vector in the row
  __device__ __forceinline__ void get(int dy, int col, float& m2,
                                      float (&d)[C]) const {
    constexpr int kCols = (kDdTileW + K - 1 + V - 1) / V;
    const float4 q = s[base + dy * kCols * V + (col % V) * kCols + col / V];
    m2 = q.x;
    d[0] = q.y;
    d[1] = q.z;
    if constexpr (C > 2) d[2] = q.w;
  }
};

// grid: x = tiles of the image, y = batch item.
template <int C, int K, typename T>
__global__ void __launch_bounds__(kDdThreads, 1)
    psb_ddata_vec(const T* __restrict__ logits,
                  const float* __restrict__ new_max,
                  const float* __restrict__ d_r, float* __restrict__ d_data,
                  int h, int w, int groups, int tiles_x) {
  using L = DdLayout<K, T>;
  constexpr int V = L::V;
  constexpr int kO = (K - 1) / 2;
  constexpr int kVals = C * V;
  constexpr int kBatch = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int items = L::items(groups);
  const int th = L::rows(groups);
  float4* halo = reinterpret_cast<float4*>(smem);
  float* part = reinterpret_cast<float*>(smem + L::halo_bytes(groups));

  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * kDdTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t nhw = static_cast<int64_t>(n) * hw;
  const float* dr = d_r + nhw * C;

  // The halo: m2 and d_r at (y0 - o .. y0 + th + o - 1, x0 - o ..
  // x0 + 64 + o - 1), +inf and zeros outside the image; each thread has
  // kBatch pixels' loads in flight before it stores any.
  const int total = (th + K - 1) * L::kHaloW;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kDdThreads) {
    float4 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kDdThreads;
      const int hy = i / L::kHaloW, hx = i % L::kHaloW;
      const int gy = y0 - kO + hy, gx = x0 - kO + hx;
      const bool in = i < total && gy >= 0 && gy < h && gx >= 0 && gx < w;
      const int64_t q = static_cast<int64_t>(gy) * w + gx;
      at[b] = i < total ? hy * L::kRow + (hx % V) * L::kCols + hx / V : -1;
      v[b] = make_float4(in ? psb_m2(new_max[nhw + q]) : INFINITY,
                         in ? dr[q] : 0.f, in ? dr[hw + q] : 0.f,
                         (C > 2 && in) ? dr[2 * hw + q] : 0.f);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (at[b] >= 0) halo[at[b]] = v[b];
  }
  __syncthreads();

  const int item = threadIdx.x % items;
  const int g = threadIdx.x / items;
  const int ty = item / L::kVecsPerRow, vx = item % L::kVecsPerRow;
  const int y = y0 + ty, x = x0 + vx * V;
  const bool valid = y < h && x < w;  // w is a multiple of V
  const int64_t p = static_cast<int64_t>(y) * w + x;
  float acc[V][C];
  if (valid)
    psb_ddata_group<C, K, V>(
        logits + static_cast<int64_t>(n) * K * K * hw + p, hw, g, groups,
        DdSmemSmall<C, K, V>{halo, ty * L::kRow + vx}, acc);
  else
    psb_ddata_zero(acc);

  if (groups > 1) {
    // Partial sums of groups 1 .. G-1, one float per (group, value, item),
    // items fastest so a warp's stores and loads are conflict-free.
    if (g > 0 && valid) {
      float* mine = part + (g - 1) * kVals * items + item;
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) mine[(j * C + c) * items] = acc[j][c];
    }
    __syncthreads();
    if (g == 0 && valid) {
      for (int g2 = 1; g2 < groups; ++g2) {
        const float* src = part + (g2 - 1) * kVals * items + item;
        float b[V][C];
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int c = 0; c < C; ++c) b[j][c] = src[(j * C + c) * items];
        psb_ddata_merge(acc, b);
      }
    }
  }
  if (g == 0 && valid) psb_ddata_store<C, V>(d_data + nhw * C + p, hw, acc);
}

template <int C, int K, typename T>
int launch_ddata_vec(const void* logits, const float* new_max,
                     const float* d_r, float* d_data, int bs, int h, int w,
                     int groups, cudaStream_t stream) {
  using L = DdLayout<K, T>;
  if ((groups != 1 && groups != 2 && groups != 4 && groups != 8) ||
      groups > K)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = psb_ddata_vec<C, K, T>;
  const int bytes = L::bytes(C, groups);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kDdTileW - 1) / kDdTileW;
  const int tiles_y = (h + L::rows(groups) - 1) / L::rows(groups);
  kernel<<<dim3(tiles_x * tiles_y, bs), kDdThreads, bytes, stream>>>(
      static_cast<const T*>(logits), new_max, d_r, d_data, h, w, groups,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename T>
int ddata_vec_k(const void* logits, const float* new_max, const float* d_r,
                float* d_data, int bs, int h, int w, int k, int groups,
                cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch_ddata_vec<C, 3, T>(logits, new_max, d_r, d_data, bs, h,
                                       w, groups, stream);
    case 5:
      return launch_ddata_vec<C, 5, T>(logits, new_max, d_r, d_data, bs, h,
                                       w, groups, stream);
    case 21:
      return launch_ddata_vec<C, 21, T>(logits, new_max, d_r, d_data, bs, h,
                                        w, groups, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All four launch on `stream` and return cudaGetLastError() (a refused
// launch is reported here, not by a later synchronise), or
// cudaErrorInvalidValue for a channel count other than 2 or 3 and, for the
// vector kernels, k outside {3, 5, 21}, logits (and d_logits or d_data) not
// 16-byte aligned or w * itemsize not a multiple of 16; for the vector
// d_logits kernel row_blocks outside 1..k; for the vector d_data kernel
// groups outside {1, 2, 4, 8} or above k. The caller checks shapes, dtypes,
// contiguity and the device.

extern "C" int sbmc_progressive_splat_ddata(const void* logits,
                                            int logits_bf16,
                                            const float* new_max,
                                            const float* d_r, float* d_data,
                                            int bs, int c, int h, int w, int k,
                                            int groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(logits) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_data) % 16 != 0 ||
      (static_cast<int64_t>(w) * (logits_bf16 ? 2 : 4)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 2 && logits_bf16)
    return ddata_vec_k<2, uint16_t>(logits, new_max, d_r, d_data, bs, h, w,
                                    k, groups, s);
  if (c == 2)
    return ddata_vec_k<2, float>(logits, new_max, d_r, d_data, bs, h, w, k,
                                 groups, s);
  if (c == 3 && logits_bf16)
    return ddata_vec_k<3, uint16_t>(logits, new_max, d_r, d_data, bs, h, w,
                                    k, groups, s);
  if (c == 3)
    return ddata_vec_k<3, float>(logits, new_max, d_r, d_data, bs, h, w, k,
                                 groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sbmc_progressive_splat_ddata_generic(
    const void* logits, int logits_bf16, const float* new_max,
    const float* d_r, float* d_data, int bs, int c, int h, int w, int k,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_ddata_generic<2, uint16_t>(logits, new_max, d_r, d_data, bs, h, w,
                                      k, s);
  else if (c == 2)
    launch_ddata_generic<2, float>(logits, new_max, d_r, d_data, bs, h, w, k,
                                   s);
  else if (c == 3 && logits_bf16)
    launch_ddata_generic<3, uint16_t>(logits, new_max, d_r, d_data, bs, h, w,
                                      k, s);
  else if (c == 3)
    launch_ddata_generic<3, float>(logits, new_max, d_r, d_data, bs, h, w, k,
                                   s);
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
