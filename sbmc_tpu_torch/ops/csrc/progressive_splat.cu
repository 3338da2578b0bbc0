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
// for a bf16 1080x2048 tile, 0.58 ms at 3.35 TB/s); the arithmetic, one exp
// and C+1 FMAs per tap, is below the card's rate.
//
// Two kernels, chosen by shape in the wrapper (ops.splat_route):
//
// psf_tma, the tiled kernel, for k in {3, 5, 21} and logits whose rows TMA
// can address (w * itemsize a multiple of 16 bytes, a 16-byte aligned base):
// every shape the model paths give the step. A block owns a tile of TH x 32
// output pixels. Tap (dy, dx) of the whole tile is one TMA box of the
// logits viewed as [bs*k*k, h, w]: plane (k-1-dy)*k + (k-1-dx) from
// (x0 + dx - o, y0 + dy - o) on. TMA zero-fills where a box runs past the
// image's right or bottom edge, which is the zero-padded transpose's logit
// 0 there. TMA only takes a box that starts inside the tensor on a 16-byte
// boundary of its row (it traps otherwise), so every box starts at its
// first source pixel clamped into the image and its column aligned down,
// and is 16 bytes wider than the tile (36 float32 or 40 bfloat16 columns);
// consumers read it at a constant column offset per tap, and the tiles
// within o of an edge shift and mask their reads.
//
// One producer thread keeps a ring of S stages in shared memory, each stage
// one row of k boxes behind its own pair of mbarriers; eight consumer warps
// own the tile's pixels (TH/8 each). Per row a consumer takes the k logits
// into registers, releases the stage, and runs the row update of
// progressive_splat.cuh (the row's max, one rescale, k exps and FMAs, no
// data-dependent branch), with the data read from a halo of the tile staged
// once in shared memory as one 8- or 16-byte vector per pixel (zero outside
// the image). The first port's kernel kept about one 2-byte load in flight
// per thread, 4 KB per SM, where Little's law at 3.35 TB/s and ~0.6 us of
// DRAM latency asks for ~15-18 KB: S is the most stages that fit beside the
// halo in 110 KB of shared memory (two blocks per SM), at least 2, at most
// k. At k = 21 and three channels that gives float32 8-row tiles 3 stages
// (94 KB a block), bfloat16 8-row tiles 6 (102 KB) and bfloat16 16-row
// tiles 3 (108 KB): two blocks per SM, 140-160 KB of ring per SM. Float32
// 16-row tiles do not fit: a stage is 47 KB and the halo 29 KB, so they
// take the minimum of 2 stages, 124 KB, and run one block per SM with a
// 94 KB ring.
//
// Tiles are 32 pixels wide and TH = 8 or 16 rows: 8-row tiles run more
// stages and leave a smaller last wave, 16-row ones stage fewer halos;
// neither won at every shape on the card, so the wrapper takes 8 where its
// grid needs fewer than twice the waves of the 16-row grid
// (ops.splat_tile_rows).
//
// psf_generic, the kernel of the first port, kept as it was for every other
// shape (odd widths, other k): one thread per output pixel walking the k^2
// taps with a per-tap rescale.
//
// Element offsets are 64-bit: k2*h*w exceeds 2^31 at a 1080x2048 tile once
// bs >= 3.

#include <cuda.h>  // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_runtime.h>

#include "progressive_splat.cuh"

namespace {

// ------------------------------------------------------------ psf_generic

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int C, typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    psf_generic(const float* __restrict__ data, const T* __restrict__ logits,
                const float* __restrict__ sum_r,
                const float* __restrict__ sum_w,
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
void launch_generic(const float* data, const void* logits, const float* sum_r,
                    const float* sum_w, const float* max_w, float* out_r,
                    float* out_w, float* out_m, int bs, int h, int w, int k,
                    cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, bs);
  psf_generic<C, T><<<grid, block, 0, stream>>>(
      data, static_cast<const T*>(logits), sum_r, sum_w, max_w, out_r, out_w,
      out_m, h, w, k);
}

// ---------------------------------------------------------------- psf_tma

constexpr int kTileW = 32;
constexpr int kConsumers = 256;  // eight warps, 32 pixels of a tile row each
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemBudget = 110 * 1024;    // two blocks per SM

// The halo holds one vector of the C data values per pixel.
template <int C>
struct HaloVec;
template <>
struct HaloVec<2> {
  using type = float2;
};
template <>
struct HaloVec<3> {
  using type = float4;
};

// The data at the source pixels of one tap row: halo row (py + dy), from
// column px on.
template <int C>
struct HaloRow {
  const typename HaloVec<C>::type* row;
  __host__ __device__ void get(int dx, float (&d)[C]) const {
    const auto q = row[dx];
    d[0] = q.x;
    d[1] = q.y;
    if constexpr (C > 2) d[2] = q.z;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

// Waits until the phase of `bar` with this parity has completed. A wait of
// more than 2^34 cycles (about 10 s) can only be a lost transaction: it
// traps, which fails the launch, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// One box of the [bs*k*k, h, w] logits into shared memory; completes
// transaction bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "r"(plane)
      : "memory");
}

// Shared memory of one block: 2*S mbarriers, the ring of S stages of K
// boxes (128-byte aligned, as TMA wants), then the halo.
template <int C, typename T, int K, int TH>
struct TmaLayout {
  // A box starts on a 16-byte boundary of its row (kAlign elements), so it
  // is kAlign wider than the tile (see the note on box starts below).
  static constexpr int kAlign = 16 / static_cast<int>(sizeof(T));
  static constexpr int kBoxW = kTileW + kAlign;
  static constexpr int kBoxElems = TH * kBoxW;
  static constexpr int kHaloH = TH + K - 1;
  static constexpr int kHaloW = kTileW + K - 1;
  static constexpr int kRingOffset = 512;  // room for 2 x 32 barriers
  static constexpr int kStageBytes =
      K * kBoxElems * static_cast<int>(sizeof(T));
  static constexpr int kHaloBytes =
      kHaloH * kHaloW * static_cast<int>(sizeof(typename HaloVec<C>::type));
  static __host__ __device__ int stages() {
    int s = (kSmemBudget - kRingOffset - kHaloBytes) / kStageBytes;
    s = s < 2 ? 2 : s;
    return s > K ? K : s;
  }
  static __host__ __device__ int bytes() {
    return kRingOffset + stages() * kStageBytes + kHaloBytes;
  }
};

template <int C, typename T, int K, int TH>
__global__ void __launch_bounds__(kThreads)
    psf_tma(const __grid_constant__ CUtensorMap logits_map,
            const float* __restrict__ data, const float* __restrict__ sum_r,
            const float* __restrict__ sum_w, const float* __restrict__ max_w,
            float* __restrict__ out_r, float* __restrict__ out_w,
            float* __restrict__ out_m, int h, int w, int tiles_x) {
  using L = TmaLayout<C, T, K, TH>;
  using Vec = typename HaloVec<C>::type;
  constexpr int kO = (K - 1) / 2;
  constexpr int kPix = TH / 8;  // pixels per consumer thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int stages = L::stages();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  T* ring = reinterpret_cast<T*>(smem + L::kRingOffset);
  Vec* halo =
      reinterpret_cast<Vec*>(smem + L::kRingOffset + stages * L::kStageBytes);

  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    // The initialised barriers, visible to the async proxy (TMA) too.
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: row dy of taps into stage dy % S, once its previous row has
    // been released by all eight consumer warps.
    if (threadIdx.x == kConsumers) {
      const int plane0 = n * K * K;
      for (int dy = 0; dy < K; ++dy) {
        const int s = dy % stages;
        if (dy >= stages) mbar_wait(&empty[s], ((dy / stages) - 1) & 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        T* dst = ring + static_cast<int64_t>(s) * K * L::kBoxElems;
        for (int dx = 0; dx < K; ++dx)
          tma_load_3d(dst + dx * L::kBoxElems, &logits_map, &full[s],
                      psf_box_x<L::kAlign>(x0 + dx - kO, w),
                      psf_clamp(y0 + dy - kO, h),
                      plane0 + (K - 1 - dy) * K + (K - 1 - dx));
      }
    }
    return;
  }

  // Consumers. The data halo first (zero outside the image), while the
  // producer's first rows are in flight.
  const int64_t hw = static_cast<int64_t>(h) * w;
  const float* dn = data + static_cast<int64_t>(n) * C * hw;
  for (int i = threadIdx.x; i < L::kHaloH * L::kHaloW; i += kConsumers) {
    const int gy = y0 - kO + i / L::kHaloW;
    const int gx = x0 - kO + i % L::kHaloW;
    float d[C];
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
    for (int c = 0; c < C; ++c)
      d[c] = in ? dn[c * hw + static_cast<int64_t>(gy) * w + gx] : 0.f;
    Vec v;
    v.x = d[0];
    v.y = d[1];
    if constexpr (C > 2) {
      v.z = d[2];
      v.w = 0.f;
    }
    halo[i] = v;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

  const int px = threadIdx.x % kTileW;
  const int py = threadIdx.x / kTileW;
  const int lane = threadIdx.x % 32;
  const int64_t nhw = static_cast<int64_t>(n) * hw;
  PsfState<C> st[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = y0 + py + 8 * j, x = x0 + px;
    st[j] = psf_state_at<C>(
        y < h && x < w ? max_w[nhw + static_cast<int64_t>(y) * w + x] : 0.f);
  }

  // Box starts: TMA refuses (an illegal-instruction trap on the card) a box
  // whose first column is not on a 16-byte boundary, which a tap's shift
  // by dx - o makes the rule, and which the negative start of a halo tap
  // before the image breaks too. So the producer clamps every start into
  // the image and aligns its column down (psf_box_x); TMA zero-fills what
  // runs past the right or bottom edge. Tiles whose halo taps start outside
  // the image (within o of an edge) read their boxes shifted and masked;
  // every other tile reads them at a constant column offset per tap. The
  // host build reads its emulated boxes the same way
  // (progressive_splat_host.cpp).
  const bool edge = x0 < kO || y0 < kO || x0 + kO >= w || y0 + kO >= h;
  for (int dy = 0; dy < K; ++dy) {
    const int s = dy % stages;
    mbar_wait(&full[s], (dy / stages) & 1);
    const T* row = ring + static_cast<int64_t>(s) * K * L::kBoxElems;
    float v[kPix][K];
    if (!edge) {
      // x0 is a multiple of kAlign: tap dx's box starts (dx - o) mod kAlign
      // columns before the tile's first source pixel, a constant.
#pragma unroll
      for (int j = 0; j < kPix; ++j)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          v[j][dx] = psf_load(
              row, dx * L::kBoxElems + (py + 8 * j) * L::kBoxW + px +
                       ((dx - kO) % L::kAlign + L::kAlign) % L::kAlign);
    } else {
      // The box of tap (dy, dx) starts at the clamped (and aligned) source
      // pixel of the tile's first pixel, gy = y0 + dy - o, gx = x0 + dx - o:
      // the wanted element sits gy - box row and gx - box column off, and a
      // source pixel outside the image is logit 0.
      const int gy = y0 + dy - kO;
      const int ry = gy - psf_clamp(gy, h);
#pragma unroll
      for (int j = 0; j < kPix; ++j)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int gx = x0 + dx - kO;
          const int yy = gy + py + 8 * j, xx = gx + px;
          v[j][dx] = yy >= 0 && yy < h && xx >= 0 && xx < w
                         ? psf_load(row, dx * L::kBoxElems +
                                             (py + 8 * j + ry) * L::kBoxW +
                                             px + gx -
                                             psf_box_x<L::kAlign>(gx, w))
                         : 0.f;
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      psf_row_update<C, K>(
          st[j], v[j], HaloRow<C>{halo + (py + 8 * j + dy) * L::kHaloW + px});
  }

  // The old state merged with the new taps.
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = y0 + py + 8 * j, x = x0 + px;
    if (y >= h || x >= w) continue;
    const int64_t p = static_cast<int64_t>(y) * w + x;
    PsfState<C> out;
    out.m = max_w[nhw + p];
    out.w = sum_w[nhw + p];
#pragma unroll
    for (int c = 0; c < C; ++c) out.r[c] = sum_r[(n * C + c) * hw + p];
    psf_merge(out, st[j]);
    out_m[nhw + p] = out.m;
    out_w[nhw + p] = out.w;
#pragma unroll
    for (int c = 0; c < C; ++c) out_r[(n * C + c) * hw + p] = out.r[c];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library needs no -lcuda); null if the driver does not have it.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int C, typename T, int K, int TH>
int launch_tma(const float* data, const void* logits, const float* sum_r,
               const float* sum_w, const float* max_w, float* out_r,
               float* out_w, float* out_m, int bs, int h, int w,
               cudaStream_t stream) {
  using L = TmaLayout<C, T, K, TH>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t item = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(bs) * K * K};
  const cuuint64_t strides[2] = {w * item,
                                 static_cast<cuuint64_t>(h) * w * item};
  const cuuint32_t box[3] = {L::kBoxW, TH, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = enc(
      &map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(logits), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = psf_tma<C, T, K, TH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes());
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + TH - 1) / TH;
  kernel<<<dim3(tiles_x * tiles_y, bs), kThreads, L::bytes(), stream>>>(
      map, data, sum_r, sum_w, max_w, out_r, out_w, out_m, h, w, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename T, int K>
int tma_th(const float* data, const void* logits, const float* sum_r,
           const float* sum_w, const float* max_w, float* out_r, float* out_w,
           float* out_m, int bs, int h, int w, int tile_h,
           cudaStream_t stream) {
  if (tile_h == 16)
    return launch_tma<C, T, K, 16>(data, logits, sum_r, sum_w, max_w, out_r,
                                   out_w, out_m, bs, h, w, stream);
  if (tile_h == 8)
    return launch_tma<C, T, K, 8>(data, logits, sum_r, sum_w, max_w, out_r,
                                  out_w, out_m, bs, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int C, typename T>
int tma_k(const float* data, const void* logits, const float* sum_r,
          const float* sum_w, const float* max_w, float* out_r, float* out_w,
          float* out_m, int bs, int h, int w, int k, int tile_h,
          cudaStream_t stream) {
  switch (k) {
    case 3:
      return tma_th<C, T, 3>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                             out_m, bs, h, w, tile_h, stream);
    case 5:
      return tma_th<C, T, 5>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                             out_m, bs, h, w, tile_h, stream);
    case 21:
      return tma_th<C, T, 21>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                              out_m, bs, h, w, tile_h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int C>
int tma_c(const float* data, const void* logits, int logits_bf16,
          const float* sum_r, const float* sum_w, const float* max_w,
          float* out_r, float* out_w, float* out_m, int bs, int h, int w,
          int k, int tile_h, cudaStream_t stream) {
  if (logits_bf16)
    return tma_k<C, uint16_t>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                              out_m, bs, h, w, k, tile_h, stream);
  return tma_k<C, float>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                         out_m, bs, h, w, k, tile_h, stream);
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (a
// refused launch is reported here, not by a later synchronise), or
// cudaErrorInvalidValue for arguments outside the kernel's set: a channel
// count other than 2 or 3 (radiance has 3; the tests also use 2), and for
// the tiled kernel k outside {3, 5, 21}, tile_h other than 8 or 16, logits
// not 16-byte aligned or w * itemsize not a multiple of 16. The caller
// checks shapes, dtypes, contiguity and the device.

extern "C" int sbmc_progressive_splat(const float* data, const void* logits,
                                      int logits_bf16, const float* sum_r,
                                      const float* sum_w, const float* max_w,
                                      float* out_r, float* out_w, float* out_m,
                                      int bs, int c, int h, int w, int k,
                                      int tile_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int item = logits_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(logits) % 16 != 0 ||
      (static_cast<int64_t>(w) * item) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 2:
      return tma_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                      out_w, out_m, bs, h, w, k, tile_h, s);
    case 3:
      return tma_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                      out_w, out_m, bs, h, w, k, tile_h, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sbmc_progressive_splat_generic(
    const float* data, const void* logits, int logits_bf16, const float* sum_r,
    const float* sum_w, const float* max_w, float* out_r, float* out_w,
    float* out_m, int bs, int c, int h, int w, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c != 2 && c != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (logits_bf16) {
    if (c == 2)
      launch_generic<2, uint16_t>(data, logits, sum_r, sum_w, max_w, out_r,
                                  out_w, out_m, bs, h, w, k, s);
    else
      launch_generic<3, uint16_t>(data, logits, sum_r, sum_w, max_w, out_r,
                                  out_w, out_m, bs, h, w, k, s);
  } else {
    if (c == 2)
      launch_generic<2, float>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                               out_m, bs, h, w, k, s);
    else
      launch_generic<3, float>(data, logits, sum_r, sum_w, max_w, out_r, out_w,
                               out_m, bs, h, w, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
