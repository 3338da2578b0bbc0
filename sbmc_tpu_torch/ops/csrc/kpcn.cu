// The passes at the two ends of KPCN's conv chains (models/kpcn.py:
// KPCN.forward_channels_last) for Hopper, at inference, around cuDNN's
// channels-last (NHWC) bf16 convolutions, whose channel counts are padded
// with zeros to aligned widths (27 -> 32, 100 -> 128, 441 -> 448):
//
// - kpcn_entry: a chain's input [bs, c, h, w], NCHW, float32, bf16 or
//   float16, to a dense channels-last bf16 tensor at the padded width, the
//   pad channels zero; the cast rounds as x.to(torch.bfloat16) rounds.
// - kpcn_exit: the prediction convolution's channels-last output at the
//   padded width, run without its bias, to the normalised gather kernels that
//   kernel weighting (B4, kw_fwd) reads, [bs, k2, h, w] NCHW bf16. For each
//   pixel: the bias added and rounded to bf16, as WNConv2D.forward rounds it;
//   then the softmax over the first k2 channels in float32 (the max, the sum
//   of exp(v - max), each exp(v - max) times 1 / sum rounded once to bf16),
//   as torch.softmax computes it on a bf16 tensor, within one bf16 unit: the
//   exponential is the hardware's exp2 of (v - max) log2(e), and the sum is
//   taken in another order.
//
// They replace no Pallas kernel: on the TPU, XLA fused the cast, the bias,
// the softmax and the layouts into the convolutions' neighbours. On the card
// the NCHW chains spent about a third of a frame around their convolutions:
// cuDNN transposed every activation into and out of its NHWC kernels, the
// bias add and the ReLU each read and wrote the activations once more, and
// the softmax read and wrote every pixel's 441 logits again. Between the
// convolutions unet_epilogue (unet.cu) adds the bias and applies the ReLU in
// place; these two passes are the chain's ends. The softmax is in the exit
// because a pixel's logits are contiguous only there: layout and softmax
// are one pass over the same bytes.
//
// What bounds them on this card: bytes (a few operations a value). Each
// value is read once and written once:
//
// - kpcn_entry: a thread writes one 16-byte vector (8 channels of one
//   pixel), threads along a pixel's vectors, then along pixels: at the
//   32-channel width a warp covers 8 pixels, so each NCHW plane is read in
//   runs of 8 pixels (32 bytes of float32: whole sectors), and the warp's
//   writes are one 512-byte run.
// - kpcn_exit: a block takes 64 pixels of one batch item at a time. Their
//   channels (a contiguous run: 64 x 896 bytes at 448 channels) are copied
//   by consecutive threads in 16-byte pieces (cp.async) into shared memory,
//   a row a pixel, rows an odd number of vectors apart, so that a quarter
//   warp's 16-byte reads of 8 pixels' rows fall on 32 distinct banks. Each
//   lane owns a pixel and each pair of warps an eighth of the channels: a
//   pass adds the bias into the staged logits and takes their max, a pass
//   sums the exps, a pass writes the weights (the exps computed again: no
//   register arrays, so three blocks of 16 warps fit on a multiprocessor);
//   the max and the sum are reduced across the warps through shared memory.
//   Each warp writes its channels' planes in runs of 32 pixels, the other
//   half's warp the next 32 (64 + 64 bytes). The NCHW writes bound it: on an
//   H100, writes alone in runs of 64 bytes a plane reach 2.0 TB/s, of 128
//   bytes 2.5, of 512 bytes 3.0; longer runs need more pixels a block than
//   its shared memory holds beside the logits.
//
// Any batch, any size. kpcn_entry: up to 4096 channels in and out;
// kpcn_exit: a padded width that is a multiple of 8 up to 512, k2 up to it.
// Every output value has one writer. No backward: the wrappers
// (nn/kpcn_layout.py) run these under inference only.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // kpcn_entry's block
constexpr int kExitThreads = 512;   // kpcn_exit's block: 16 warps
constexpr int kExitTile = 64;       // pixels of an exit tile: two halves of 32
constexpr int kGroups = kExitThreads / kExitTile;  // channel groups: 8
// Exit blocks a multiprocessor holds: 40 registers a thread, at most 66.5 KB
// of staged logits (512 channels) and 5 KB more a block.
constexpr int kExitBlocksPerSm = 3;
constexpr int kMaxExitVecs = 64;    // 512 channels
constexpr int kMaxEntryVecs = 512;  // 4096 channels

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float as_float(__half v) { return __half2float(v); }

// x [bs, c, P] (P pixels) -> out [bs, P, cv] vectors of 8 bf16 channels, the
// channels from c on zero. Threads: x over a pixel's vectors, y over pixels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    kpcn_entry(const T* __restrict__ x, uint4* __restrict__ out, int c,
               int cv, long long pixels, long long total) {
  for (long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       p < total; p += (long long)gridDim.x * blockDim.y) {
    const long long n = p / pixels;
    const T* src = x + n * c * pixels + (p - n * pixels);
    for (int v = threadIdx.x; v < cv; v += blockDim.x) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ch = 8 * v + i;
        f[i] = ch < c ? as_float(src[(long long)ch * pixels]) : 0.f;
      }
      uint4 o;
      __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        po[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      out[p * cv + v] = o;
    }
  }
}

// 16 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// bf16(y + b) for eight channels, as WNConv2D.forward adds its bias.
__device__ __forceinline__ uint4 add_bias8(uint4 v, uint4 b) {
  const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fv = __bfloat1622float2(pv[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    po[i] = __floats2bfloat162_rn(fv.x + fb.x, fv.y + fb.y);
  }
  return o;
}

__device__ __forceinline__ void unpack8(uint4 a, float* f) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(pa[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// y [bs, P, cv] vectors (channels-last, dense: the prediction without its
// bias), bias [k2] bf16 -> out [bs, k2, P] bf16, the softmax over the first
// k2 channels of bf16(y + bias). A block walks tiles of kExitTile pixels of
// one batch item; warp w owns pixel half w % 2 (a lane each) and channel
// group w / 2 (a run of vectors) of every tile.
__global__ void __launch_bounds__(kExitThreads, kExitBlocksPerSm)
    kpcn_exit(const uint4* __restrict__ y,
              const __nv_bfloat16* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, int bs, long long pixels,
              int cv, int k2) {
  extern __shared__ uint4 logits[];  // kExitTile rows of `ld` vectors
  __shared__ uint4 sb[kMaxExitVecs];
  __shared__ float red_max[kGroups][kExitTile], red_sum[kGroups][kExitTile];
  const int ld = cv | 1;
  __nv_bfloat16* sbh = reinterpret_cast<__nv_bfloat16*>(sb);
  for (int i = threadIdx.x; i < cv * 8; i += kExitThreads)
    sbh[i] = i < k2 ? bias[i] : __float2bfloat16_rn(0.f);
  const int warp = threadIdx.x >> 5, g = warp >> 1;
  const int px = (warp & 1) * 32 + (threadIdx.x & 31);  // pixel in a tile
  const int vpg = (cv + kGroups - 1) / kGroups;
  const int va = g * vpg, vb = min(cv, va + vpg);
  // The staging loop's step in (pixel, vector) without a division.
  const int step_p = kExitThreads / cv, step_v = kExitThreads - step_p * cv;
  const long long per_item = (pixels + kExitTile - 1) / kExitTile;
  constexpr float kLog2e = 1.4426950408889634f;
  uint4* row = logits + px * ld;
  for (long long t = blockIdx.x; t < bs * per_item; t += gridDim.x) {
    const long long n = t / per_item, p0 = (t - n * per_item) * kExitTile;
    const int np = (int)min((long long)kExitTile, pixels - p0);
    __syncthreads();  // the previous tile's readers are done
    const uint4* src = y + (n * pixels + p0) * cv;
    int p = threadIdx.x / cv, v = threadIdx.x - p * cv;
    for (int i = threadIdx.x; i < np * cv; i += kExitThreads) {
      cp_async16(logits + p * ld + v, src + i);
      p += step_p;
      v += step_v;
      if (v >= cv) {
        v -= cv;
        ++p;
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();

    // The bias, once, into the staged logits; the max.
    float m = -INFINITY;
    for (int vec = va; vec < vb; ++vec) {
      const uint4 a = add_bias8(row[vec], sb[vec]);
      row[vec] = a;
      float f[8];
      unpack8(a, f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * vec + i < k2) m = fmaxf(m, f[i]);
    }
    red_max[g][px] = m;
    __syncthreads();
    m = red_max[0][px];
#pragma unroll
    for (int w = 1; w < kGroups; ++w) m = fmaxf(m, red_max[w][px]);
    // exp(v - m) as exp2(v log2(e) - m log2(e)): one multiply-add and the
    // hardware's exp2.
    const float ms = m * kLog2e;
    float s = 0.f;
    for (int vec = va; vec < vb; ++vec) {
      float f[8];
      unpack8(row[vec], f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * vec + i < k2) s += exp2f(fmaf(f[i], kLog2e, -ms));
    }
    red_sum[g][px] = s;
    __syncthreads();
    s = red_sum[0][px];
#pragma unroll
    for (int w = 1; w < kGroups; ++w) s += red_sum[w][px];
    const float inv = 1.f / s;
    if (px < np) {
      __nv_bfloat16* dst = out + (n * k2 + 8 * va) * pixels + p0 + px;
      for (int vec = va; vec < vb; ++vec, dst += 8 * pixels) {
        float f[8];
        unpack8(row[vec], f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * vec + i < k2)
            dst[i * pixels] =
                __float2bfloat16_rn(exp2f(fmaf(f[i], kLog2e, -ms)) * inv);
      }
    }
  }
}

}  // namespace

extern "C" {

// x [bs, c, h, w] NCHW, dense (dtype 0 float32, 1 bf16, 2 float16), to out
// [bs, h, w, width] bf16, dense channels-last, channels c..width-1 zero.
// `sms`: the card's multiprocessors. Returns a CUDA error code.
int sbmc_kpcn_entry(const void* x, int dtype, void* out, int bs, int c,
                    int h, int w, int width, int sms, void* stream) {
  if (c <= 0 || width < c || width % 8 != 0 || width / 8 > kMaxEntryVecs ||
      bs <= 0 || h <= 0 || w <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int cv = width / 8;
  const int bx = cv < 32 ? cv : 32;
  const dim3 block(bx, kThreads / bx);
  const long long pixels = (long long)h * w, total = (long long)bs * pixels;
  const long long blocks = (total + block.y - 1) / block.y;
  const long long cap = (long long)sms * (2048 / kThreads);
  const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    kpcn_entry<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), o,
                                             c, cv, pixels, total);
  else if (dtype == 1)
    kpcn_entry<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, c, cv, pixels, total);
  else
    kpcn_entry<__half><<<grid, block, 0, s>>>(static_cast<const __half*>(x),
                                              o, c, cv, pixels, total);
  return (int)cudaGetLastError();
}

// y [bs, h, w, c] bf16, dense channels-last (the prediction convolution's
// output without its bias), bias [k2] bf16 -> out [bs, k2, h, w] bf16, NCHW
// dense: out[n, :, p] = softmax(bf16(y[n, p, :k2] + bias)). `sms`: the card's
// multiprocessors. Returns a CUDA error code.
int sbmc_kpcn_exit(const void* y, const void* bias, void* out, int bs, int h,
                   int w, int c, int k2, int sms, void* stream) {
  if (c <= 0 || c % 8 != 0 || c / 8 > kMaxExitVecs || k2 <= 0 || k2 > c ||
      bs <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const int smem = kExitTile * (cv | 1) * (int)sizeof(uint4);
  const cudaError_t err = cudaFuncSetAttribute(
      kpcn_exit, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)h * w;
  const long long tiles = (long long)bs * ((pixels + kExitTile - 1) / kExitTile);
  const long long cap = (long long)sms * kExitBlocksPerSm;
  kpcn_exit<<<(unsigned)(tiles < cap ? tiles : cap), kExitThreads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), bs, pixels, cv, k2);
  return (int)cudaGetLastError();
}

}  // extern "C"
