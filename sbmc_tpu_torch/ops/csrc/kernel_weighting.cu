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
// once (k2*h*w*itemsize per batch item, 441 planes at k = 21: 1.95 GB for a
// bfloat16 1080x2048 tile, 0.58 ms at 3.35 TB/s) against C planes of data
// and C + 1 planes of output; kw_dw writes a tensor of that size once, in
// the weights' type. The arithmetic, C FMAs and an add per tap, is far below
// the card's rate. Every design below touches each element of the k^2-plane
// tensor exactly once, at its own pixel; all are gathers without atomics,
// so the result is deterministic. Element offsets are 64-bit (k2*h*w passes
// 2^31 at batch 3 of 1080x2048).
//
// kw_fwd and kw_dw, the tiled kernels, for k in {3, 5, 21} and any width
// (ops.kw_route). The first port's kernels ran one thread per pixel over
// 441 serial taps, each tap a 2- or 4-byte weight access and C data loads
// through L1/L2 behind a bounds branch: about one weight access in flight
// per thread, and at KPCN's training shape (4, 3, 92, 92) 33,856 threads,
// about 8 warps per SM. Here:
//
// - A block of 256 threads owns a tile of TH rows x 32 work items, a work
//   item V consecutive pixels of a row, so one warp is one tile row and
//   moves up to 512 contiguous bytes of a tap plane per access. V is the
//   widest of 2 (the forward: 8-byte float32 or 4-byte bfloat16 loads) or
//   4 (the gradient: 16- or 8-byte stores), 2, 1 that divides the width
//   and the tap planes' base in elements (ops.kw_pixels): every width of
//   the KPCN and gather paths takes the widest, the gradient phase's odd
//   53 takes 1.
// - The block stages the tile's C-plane data halo once in shared memory,
//   zero outside the image, de-interleaved by column residue modulo V so
//   the lanes of a warp read neighbouring words; each thread has four halo
//   pixels' loads in flight at once. Taps then need no branch. K is a
//   template parameter and the dx loop is unrolled: a thread issues its
//   tap row's K weight loads at once, and each staged data column serves
//   the V pixels' taps that read it. kw_fwd asks ptxas for one block per SM
//   at least, which lets it keep a row's loads (and the next row's) in
//   registers; left to itself it kept few registers and waited on every
//   row.
// - The block's threads form G = 8 / TH groups of the tile's items; group g
//   takes the tap rows g, g + G, ... . kw_fwd joins the groups' partial
//   sums through shared memory in group order (fixed: deterministic, no
//   atomics); kw_dw has no reduction over taps, so its groups only split
//   the rows. ops.kw_groups gives the forward the fewest groups (tallest
//   tiles, fewest halo rows per output row) that keep about as many weight
//   bytes in flight as one float32 block per SM (2 groups at the float32
//   training shape, 4 in bfloat16, 1 at 1080x2048); the gradient takes 8
//   (ops.kw_dw_groups). chip_smoke.py times every count beside the chosen
//   one.
// - kw_dw writes the gradient in the weights' type: bfloat16 weights get
//   their float32 sum rounded once to nearest even on the store, which
//   halves the bytes of the write against a float32 gradient and a cast.
//   Its stores are streaming (evict-first).
//
// What remains above the bound: at 1080x2048 the forward reads its weights
// about as fast as torch.sum reads the same tensor, and the gradient writes
// somewhat slower than a fill of the same bytes (chip_smoke.py prints both
// yardsticks); at the training shape a block's halo staging and the last,
// partly filled wave weigh on an 18 us bound.
//
// kw_fwd_generic and kw_dw_generic, the first port's kernels, kept as they
// were for the kernel sizes the tiled kernels are not built for: one thread
// per pixel with x fastest across threadIdx.x, the k^2 taps in a serial
// loop, a bounds test in place of the TPU kernel's padded copies, the halo
// re-read from L1/L2. kw_dw_generic writes float32.
//
// kw_exp, the tiled kernel weighting of exp(logits - maxes), for k in
// {3, 5, 21} and any width (ops.kw_route), is kw_fwd with one more float32
// plane read (maxes) and the weight transform KwExp (kernel_weighting.cuh):
// the same kernel source, instantiated with KwPlain for kw_fwd, whose code
// does not change. An item loads its V shifts once (one 8-byte load where
// V = 2, which then also needs an aligned maxes base) and forms each weight
// in registers as exp2f(fmaf(L, log2(e), -m * log2(e))): one FMA and one
// MUFU.EX2 per tap, the form the splat kernels take. The exponentiated
// k^2-plane tensor never exists in device memory, which is what the Pallas
// kernel fuses it for. Its bound is bytes as kw_fwd's is: at 1080x2048 the
// 441 exp2 per pixel are about 1 G MUFU results, some 0.25 ms at 16 a clock
// per SM, under the 0.60 ms of the bfloat16 logits' bytes if the loads
// hide them. ops.kw_exp_groups picks its groups of tap rows by kw_fwd's
// rule with bfloat16 logits counted as float32: the exp2 keep a bfloat16
// block as busy per byte as a float32 one, and at the training shape
// (4, 3, 128, 128) bfloat16 2 groups beat kw_groups' 4.
//
// kw_exp_generic, the first port's kernel, kept for the kernel sizes the
// tiled one is not built for: kw_fwd_generic's design with the maxes plane
// read at the thread's own pixel and each weight expf(float(logit) - max),
// the accurate float32 exponential as the JAX package's plain version
// computes it. One thread per pixel over 441 serial taps keeps about one
// logit load in flight a thread: it reaches about a third of its bound at
// 1080x2048 bf16 (PERF.md).

#include <cuda_runtime.h>

#include "kernel_weighting.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    kw_fwd_generic(const float* __restrict__ data,
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
    kw_dw_generic(const float* __restrict__ data,
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
    kw_exp_generic(const float* __restrict__ data,
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
void launch_fwd_generic(const float* data, const void* weights, float* out,
                        float* sum_w, int bs, int h, int w, int k,
                        cudaStream_t stream) {
  kw_fwd_generic<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                        stream>>>(data, static_cast<const T*>(weights), out,
                                  sum_w, h, w, k);
}

template <int C>
void launch_dw_generic(const float* data, const float* d_out,
                       const float* d_sum_w, float* d_w, int bs, int h, int w,
                       int k, cudaStream_t stream) {
  kw_dw_generic<C><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0, stream>>>(
      data, d_out, d_sum_w, d_w, h, w, k);
}

template <int C, typename T>
void launch_exp_generic(const float* data, const void* logits,
                        const float* maxes, float* out, float* sum_w, int bs,
                        int h, int w, int k, cudaStream_t stream) {
  kw_exp_generic<C, T><<<grid_of(bs, h, w), dim3(kBlockX, kBlockY), 0,
                         stream>>>(data, static_cast<const T*>(logits),
                                   maxes, out, sum_w, h, w, k);
}


// ------------------------------------------------------------ tiled kernels

constexpr int kKwThreads = 256;

// Geometry of a tile: 32 work items of V pixels per row (one warp), and the
// data halo's columns, kCols per residue modulo V (halo column col of the
// tile lives at (col % V) * kCols + col / V of its row).
template <int K, int V>
struct KwTile {
  static constexpr int kTileW = 32 * V;
  static constexpr int kHaloW = kTileW + K - 1;
  static constexpr int kCols = (kHaloW + V - 1) / V;
  static constexpr int kRow = kCols * V;
};

// A work item's view of the staged halo: channel c of the item's column s
// in tap row dy.
template <int C, int K, int V>
struct KwSmemHalo {
  const float* s;
  int plane;  // floats per channel
  int base;   // the item's tile row times kRow plus its index in the row
  __device__ __forceinline__ void get(int dy, int col, float (&d)[C]) const {
    using L = KwTile<K, V>;
    const int i = base + dy * L::kRow + (col % V) * L::kCols + col / V;
#pragma unroll
    for (int c = 0; c < C; ++c) d[c] = s[c * plane + i];
  }
};

// Stages the C data planes of the tile at (y0, x0), th rows, with a halo of
// o = (K-1)/2 around it, zero outside the image. A thread loads kBatch
// halo pixels before it stores any, so their loads are in flight together.
template <int C, int K, int V>
__device__ void kw_stage(float* s, int plane, const float* data, int h,
                         int w, int y0, int x0, int th) {
  using L = KwTile<K, V>;
  constexpr int kO = (K - 1) / 2;
  constexpr int kBatch = 4;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int total = (th + K - 1) * L::kHaloW;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kKwThreads) {
    float v[kBatch][C];
    int at[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kKwThreads;
      const int hy = i / L::kHaloW, hx = i % L::kHaloW;
      const int gy = y0 - kO + hy, gx = x0 - kO + hx;
      const bool in = i < total && gy >= 0 && gy < h && gx >= 0 && gx < w;
      const int64_t q = static_cast<int64_t>(gy) * w + gx;
      at[b] = i < total ? hy * L::kRow + (hx % V) * L::kCols + hx / V : -1;
#pragma unroll
      for (int c = 0; c < C; ++c) v[b][c] = in ? data[c * hw + q] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (at[b] >= 0)
#pragma unroll
        for (int c = 0; c < C; ++c) s[c * plane + at[b]] = v[b][c];
  }
}

template <int K, int V>
int kw_halo_floats(int c, int th) {
  return c * (th + K - 1) * KwTile<K, V>::kRow;
}

// The work item of thread threadIdx.x in a tile of th = 8 / groups rows.
struct KwItem {
  int ty, vx, g;
};

__device__ KwItem kw_item(int th) {
  const int items = 32 * th;
  const int i = threadIdx.x % items;
  return {i / 32, i % 32, static_cast<int>(threadIdx.x) / items};
}

// At least one block per SM: with that bound ptxas keeps a tap row's K
// loads and the next row's in registers, where it otherwise waited on each
// row. Xf is the weight transform (kernel_weighting.cuh): KwPlain for
// kw_fwd, which never reads `shift`, KwExp for kw_exp, whose shift plane is
// maxes.
template <int C, int K, int V, typename T, template <int> class Xf>
__global__ void __launch_bounds__(kKwThreads, 1)
    kw_fwd(const float* __restrict__ data, const T* __restrict__ weights,
           const float* __restrict__ shift, float* __restrict__ out,
           float* __restrict__ sum_w, int h, int w, int groups,
           int tiles_x) {
  using L = KwTile<K, V>;
  extern __shared__ __align__(16) float smem[];
  const int th = 8 / groups;
  const int plane = (th + K - 1) * L::kRow;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * L::kTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  kw_stage<C, K, V>(smem, plane, data + static_cast<int64_t>(n) * C * hw, h,
                    w, y0, x0, th);
  __syncthreads();

  const KwItem it = kw_item(th);
  const int y = y0 + it.ty, x = x0 + it.vx * V;
  // V = 2 only where w is even: an item is wholly inside or outside.
  const bool valid = y < h && x < w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  KwAcc<C, V> a;
  kw_zero(a);
  if (valid)
    a = kw_fwd_group<C, K, V>(
        weights + static_cast<int64_t>(n) * K * K * hw + p, hw, it.g, groups,
        KwSmemHalo<C, K, V>{smem, plane, it.ty * L::kRow + it.vx},
        Xf<V>::load(shift, static_cast<int64_t>(n) * hw + p));
  if (groups > 1) {
    // Partial sums of groups 1 .. G-1, one float per (group, value, item),
    // items fastest so a warp's stores and loads are conflict-free.
    constexpr int kVals = V * (C + 1);
    const int items = 32 * th;
    const int item = it.ty * 32 + it.vx;
    float* part = smem + C * plane;
    if (it.g > 0 && valid) {
      float* mine = part + (it.g - 1) * kVals * items + item;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mine[(j * (C + 1)) * items] = a.w[j];
#pragma unroll
        for (int c = 0; c < C; ++c) mine[(j * (C + 1) + 1 + c) * items] =
            a.r[j][c];
      }
    }
    __syncthreads();
    if (it.g == 0 && valid) {
      for (int g = 1; g < groups; ++g) {
        const float* theirs = part + (g - 1) * kVals * items + item;
        KwAcc<C, V> b;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          b.w[j] = theirs[(j * (C + 1)) * items];
#pragma unroll
          for (int c = 0; c < C; ++c)
            b.r[j][c] = theirs[(j * (C + 1) + 1 + c) * items];
        }
        kw_merge(a, b);
      }
    }
  }
  if (it.g != 0 || !valid) return;
  const int64_t nhw = static_cast<int64_t>(n) * hw;
  kw_store(sum_w + nhw + p, a.w);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = a.r[j][c];
    kw_store(out + (nhw * C + c * hw) + p, v);
  }
}

template <int C, int K, int V, typename T>
__global__ void __launch_bounds__(kKwThreads)
    kw_dw(const float* __restrict__ data, const float* __restrict__ d_out,
          const float* __restrict__ d_sum_w, T* __restrict__ d_w, int h,
          int w, int groups, int tiles_x) {
  using L = KwTile<K, V>;
  extern __shared__ __align__(16) float smem[];
  const int th = 8 / groups;
  const int plane = (th + K - 1) * L::kRow;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * L::kTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  // The item's cotangents are loaded first, in flight while the halo is
  // staged.
  const KwItem it = kw_item(th);
  const int y = y0 + it.ty, x = x0 + it.vx * V;
  const bool valid = y < h && x < w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int64_t nhw = static_cast<int64_t>(n) * hw;
  float dout[V][C], dsw[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    dsw[j] = valid ? d_sum_w[nhw + p + j] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dout[j][c] = valid ? d_out[nhw * C + c * hw + p + j] : 0.f;
  }
  kw_stage<C, K, V>(smem, plane, data + static_cast<int64_t>(n) * C * hw, h,
                    w, y0, x0, th);
  __syncthreads();
  if (!valid) return;  // no barrier follows
  kw_dw_group<C, K, V>(dout, dsw,
                       d_w + static_cast<int64_t>(n) * K * K * hw + p, hw,
                       it.g, groups,
                       KwSmemHalo<C, K, V>{smem, plane, it.ty * L::kRow +
                                                            it.vx});
}

// Launches kernel with the grid of tiles of 8 / groups rows for (K, V) and
// the halo (plus, for the forward, the groups' partial sums) as dynamic
// shared memory, opted in above 48 KB (the gradient's 4-pixel items in
// 8-row tiles at K = 21: 50 KB).
template <int C, int K, int V, typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, bool partials, int bs, int h, int w,
                 int groups, cudaStream_t stream, Args... args) {
  using L = KwTile<K, V>;
  const int th = 8 / groups;
  const int tiles_x = (w + L::kTileW - 1) / L::kTileW;
  const int tiles = tiles_x * ((h + th - 1) / th);
  const int bytes =
      static_cast<int>(sizeof(float)) *
      (kw_halo_floats<K, V>(C, th) +
       (partials ? (groups - 1) * V * (C + 1) * 32 * th : 0));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(tiles, bs), kKwThreads, bytes, stream>>>(args..., h, w,
                                                          groups, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int K, int V, typename T, template <int> class Xf>
int fwd_tiled(const float* data, const void* weights, const float* shift,
              float* out, float* sum_w, int bs, int h, int w, int groups,
              cudaStream_t stream) {
  return launch_tiled<C, K, V>(kw_fwd<C, K, V, T, Xf>, true, bs, h, w,
                               groups, stream, data,
                               static_cast<const T*>(weights), shift, out,
                               sum_w);
}

template <int C, int K, int V, typename T>
int dw_tiled(const float* data, const float* d_out, const float* d_sum_w,
             void* d_w, int bs, int h, int w, int groups,
             cudaStream_t stream) {
  return launch_tiled<C, K, V>(kw_dw<C, K, V, T>, false, bs, h, w, groups,
                               stream, data, d_out, d_sum_w,
                               static_cast<T*>(d_w));
}

// The tiled kernels' instance for (k, v): Fn<K, V>::run(args...), or
// cudaErrorInvalidValue outside {3, 5, 21} x {1, 2, ..., kMaxV}.
template <int K, int kMaxV, template <int, int> class Fn, typename... Args>
int by_v(int v, Args... args) {
  if (v == 1) return Fn<K, 1>::run(args...);
  if (v == 2) return Fn<K, 2>::run(args...);
  if constexpr (kMaxV >= 4) {
    if (v == 4) return Fn<K, 4>::run(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kMaxV, template <int, int> class Fn, typename... Args>
int by_k_v(int k, int v, Args... args) {
  switch (k) {
    case 3: return by_v<3, kMaxV, Fn>(v, args...);
    case 5: return by_v<5, kMaxV, Fn>(v, args...);
    case 21: return by_v<21, kMaxV, Fn>(v, args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int C, typename T, template <int> class Xf>
struct Fwd {
  template <int K, int V>
  struct At {
    static int run(const float* data, const void* weights,
                   const float* shift, float* out, float* sum_w, int bs,
                   int h, int w, int groups, cudaStream_t stream) {
      return fwd_tiled<C, K, V, T, Xf>(data, weights, shift, out, sum_w, bs,
                                       h, w, groups, stream);
    }
  };
};

template <int C, typename T>
struct Dw {
  template <int K, int V>
  struct At {
    static int run(const float* data, const float* d_out,
                   const float* d_sum_w, void* d_w, int bs, int h, int w,
                   int groups, cudaStream_t stream) {
      return dw_tiled<C, K, V, T>(data, d_out, d_sum_w, d_w, bs, h, w,
                                  groups, stream);
    }
  };
};

// The arguments the tiled kernels take: groups 1, 2, 4 or 8 and at most k;
// v 1, 2 or 4 (at most max_v) dividing the width and the k^2-plane
// tensor's base address in elements (its item's loads or stores).
bool tiled_args_ok(const void* planes, int itemsize, int w, int k, int v,
                   int max_v, int groups) {
  if (groups != 1 && groups != 2 && groups != 4 && groups != 8) return false;
  if (groups > k) return false;
  if (v != 1 && v != 2 && v != 4) return false;
  return v <= max_v && w % v == 0 &&
         reinterpret_cast<uintptr_t>(planes) % (v * itemsize) == 0;
}

// The tiled forward for c channels and the weights' type: kw_fwd (Xf =
// KwPlain, shift unread) or kw_exp (KwExp, shift = maxes).
template <template <int> class Xf>
int fwd_by_c_type(const float* data, const void* weights, int weights_bf16,
                  const float* shift, float* out, float* sum_w, int bs, int c,
                  int h, int w, int k, int v, int groups,
                  cudaStream_t stream) {
  if (c == 2 && weights_bf16)
    return by_k_v<2, Fwd<2, uint16_t, Xf>::template At>(
        k, v, data, weights, shift, out, sum_w, bs, h, w, groups, stream);
  if (c == 2)
    return by_k_v<2, Fwd<2, float, Xf>::template At>(
        k, v, data, weights, shift, out, sum_w, bs, h, w, groups, stream);
  if (c == 3 && weights_bf16)
    return by_k_v<2, Fwd<3, uint16_t, Xf>::template At>(
        k, v, data, weights, shift, out, sum_w, bs, h, w, groups, stream);
  if (c == 3)
    return by_k_v<2, Fwd<3, float, Xf>::template At>(
        k, v, data, weights, shift, out, sum_w, bs, h, w, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tiled entry points sbmc_kernel_weighting, sbmc_kernel_weighting_exp
// and sbmc_kernel_weighting_dw return cudaErrorInvalidValue for arguments
// outside tiled_args_ok or k outside {3, 5, 21}.
//
// All launch on `stream` and return cudaGetLastError() (a refused launch is
// reported here, not by a later synchronise), or cudaErrorInvalidValue for
// a channel count other than 2 or 3. The caller checks shapes, dtypes,
// contiguity and the device.

extern "C" int sbmc_kernel_weighting(const float* data, const void* weights,
                                     int weights_bf16, float* out,
                                     float* sum_w, int bs, int c, int h, int w,
                                     int k, int v, int groups, void* stream) {
  if (!tiled_args_ok(weights, weights_bf16 ? 2 : 4, w, k, v, 2, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_by_c_type<KwPlain>(data, weights, weights_bf16, nullptr, out,
                                sum_w, bs, c, h, w, k, v, groups,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int sbmc_kernel_weighting_generic(const float* data,
                                             const void* weights,
                                             int weights_bf16, float* out,
                                             float* sum_w, int bs, int c,
                                             int h, int w, int k,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && weights_bf16)
    launch_fwd_generic<2, uint16_t>(data, weights, out, sum_w, bs, h, w, k,
                                    s);
  else if (c == 2)
    launch_fwd_generic<2, float>(data, weights, out, sum_w, bs, h, w, k, s);
  else if (c == 3 && weights_bf16)
    launch_fwd_generic<3, uint16_t>(data, weights, out, sum_w, bs, h, w, k,
                                    s);
  else if (c == 3)
    launch_fwd_generic<3, float>(data, weights, out, sum_w, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// d_w in the weights' type: bfloat16 (out_bf16) or float32.
extern "C" int sbmc_kernel_weighting_dw(const float* data, const float* d_out,
                                        const float* d_sum_w, void* d_w,
                                        int out_bf16, int bs, int c, int h,
                                        int w, int k, int v, int groups,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tiled_args_ok(d_w, out_bf16 ? 2 : 4, w, k, v, 4, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 2 && out_bf16)
    return by_k_v<4, Dw<2, uint16_t>::At>(k, v, data, d_out, d_sum_w, d_w,
                                          bs, h, w, groups, s);
  if (c == 2)
    return by_k_v<4, Dw<2, float>::At>(k, v, data, d_out, d_sum_w, d_w,
                                       bs, h, w, groups, s);
  if (c == 3 && out_bf16)
    return by_k_v<4, Dw<3, uint16_t>::At>(k, v, data, d_out, d_sum_w, d_w,
                                          bs, h, w, groups, s);
  if (c == 3)
    return by_k_v<4, Dw<3, float>::At>(k, v, data, d_out, d_sum_w, d_w,
                                       bs, h, w, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// d_w in float32.
extern "C" int sbmc_kernel_weighting_dw_generic(const float* data,
                                                const float* d_out,
                                                const float* d_sum_w,
                                                float* d_w, int bs, int c,
                                                int h, int w, int k,
                                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2)
    launch_dw_generic<2>(data, d_out, d_sum_w, d_w, bs, h, w, k, s);
  else if (c == 3)
    launch_dw_generic<3>(data, d_out, d_sum_w, d_w, bs, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The tiled kw_exp: v also divides the maxes plane's base in elements (its
// item's shift load).
extern "C" int sbmc_kernel_weighting_exp(const float* data, const void* logits,
                                         int logits_bf16, const float* maxes,
                                         float* out, float* sum_w, int bs,
                                         int c, int h, int w, int k, int v,
                                         int groups, void* stream) {
  if (!tiled_args_ok(logits, logits_bf16 ? 2 : 4, w, k, v, 2, groups) ||
      reinterpret_cast<uintptr_t>(maxes) % (v * sizeof(float)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_by_c_type<KwExp>(data, logits, logits_bf16, maxes, out, sum_w,
                              bs, c, h, w, k, v, groups,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int sbmc_kernel_weighting_exp_generic(
    const float* data, const void* logits, int logits_bf16,
    const float* maxes, float* out, float* sum_w, int bs, int c, int h, int w,
    int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 2 && logits_bf16)
    launch_exp_generic<2, uint16_t>(data, logits, maxes, out, sum_w, bs, h,
                                    w, k, s);
  else if (c == 2)
    launch_exp_generic<2, float>(data, logits, maxes, out, sum_w, bs, h, w,
                                 k, s);
  else if (c == 3 && logits_bf16)
    launch_exp_generic<3, uint16_t>(data, logits, maxes, out, sum_w, bs, h,
                                    w, k, s);
  else if (c == 3)
    launch_exp_generic<3, float>(data, logits, maxes, out, sum_w, bs, h, w,
                                 k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
