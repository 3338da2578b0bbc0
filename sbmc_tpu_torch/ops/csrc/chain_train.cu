// SBMC's per-sample 1x1 chains (the embedding steps and the kernel
// regressor of models/multisteps.py) in the train step, for Hopper, bf16.
//
// Under gradients the chains run on pixel-major matrices: a row a sample
// and pixel, ordered [spp, bs, h * w], its channels contiguous. Each 1x1
// layer is one cuBLAS product on them (run by nn/chain_train.py); these
// kernels do the passes around the products, and their backward:
//
// - chain_entry: the reservoir's features ([bs, spp, cf, h, w], float16,
//   bf16 or float32, each sample's planes contiguous) cast to bf16 and laid
//   out pixel-major, with the batch item's global features appended to
//   every row and zeros up to a multiple of 8 channels: the first product's
//   input, as cat([features, global features]) rounds it.
// - chain_epilogue: after a layer's product z, act(bf16(z + b)) as
//   WNConv2D.forward and ConvChain round it. z is the bf16 product, or the
//   float32 product of a split first layer with the per-pixel term e (the
//   product of the input every sample shares, float32, read once a pixel)
//   added first and rounded once, where the convolution on
//   cat([feats, extra]) rounds its sum once. With a mask it also writes the
//   masked mean over the samples (bf16(bf16(sum_s m_s r_s) / n_valid), as
//   the plain embedding step rounds it), in the same pass: a thread walks
//   one pixel's samples.
// - chain_epilogue_backward: from the gradient of the layer's output and
//   the saved output, the product's gradient dz (the activation's
//   derivative, rounded as autograd rounds it) and the bias gradient (float32
//   partial rows, summed in a fixed order and rounded once to bf16, as
//   unet_epilogue_backward sums them); with the mean's gradient, each
//   sample's share m_s bf16(d_reduced / n_valid) joins its gradient first
//   (one rounding, as autograd adds two gradients of one tensor); with
//   `dsum`, the float32 sum of dz over the samples, rounded once: the
//   gradient of the per-pixel term's product.
// - chain_logits: the regressor's last product, written by cuBLAS as each
//   sample's [bs, k2, h, w] logits (the layout the splat kernels read), gets
//   its bias and the +-3e4 clamp in place (bf16(z + b), then the clamp to
//   bf16(3e4), as regress_ref rounds it).
// - chain_logits_backward: one sample's logits gradient to dz, zero where
//   the saved logit reached the clamp (|logit| >= bf16(3e4), or NaN), and a
//   float32 bias sum a row; the last sample's call sums the rows in a fixed
//   order and rounds once.
//
// No Pallas counterpart: on the TPU XLA fused these passes into the 1x1
// convolutions. On the card the NCHW modules spent more time around the
// products than in them: cuDNN changed every activation's layout into and
// out of its kernels, and the broadcast bias add, the bias gradient's
// reduction, the masked mean and torch.cat each read and wrote the
// activations once more.
//
// What bounds them: bytes (a handful of operations a value). Each value is
// read once and written once, 16 bytes a thread (eight channels), with the
// thread layout of unet.cu's epilogues (x over channel vectors, y over
// pixels); the per-sample passes walk a pixel's samples in one thread, so
// the per-pixel term is read once a pixel and the mean and the sums over
// samples never leave registers. No atomics: results do not depend on the
// schedule.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

// --- Entry ----------------------------------------------------------------

constexpr int kEntryPixels = 64;  // pixels a tile
constexpr int kEntryMaxK = 256;   // row width (channels) the tile holds
constexpr int kEntryLoads = 4;    // 8-pixel loads a thread has in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight consecutive values at p (16-byte aligned), as float32.
__device__ __forceinline__ void load_run8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load_run8(const __half* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load_run8(const __nv_bfloat16* p,
                                          float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

// A block takes tiles of 64 pixels of one sample. Each thread loads runs
// of 8 pixels of a feature plane (16 bytes of 16-bit input; VEC: the
// planes' starts and hw a multiple of 8 values, 16-byte aligned), up to 4
// runs in flight, and stores them transposed into shared memory; then the
// tile's rows leave as 32-bit words. The tile's rows are k + 2 channels
// apart (an odd number of words), so the transposing stores spread over
// the banks.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    chain_entry(const T* __restrict__ x, long long x_bs, long long x_ss,
                int cf, const float* __restrict__ gf, int cg,
                __nv_bfloat16* __restrict__ out, int k, int bs, int spp,
                long long hw) {
  __shared__ __align__(16)
      __nv_bfloat16 tile[kEntryPixels * (kEntryMaxK + 2)];
  const int kp = k + 2;
  const long long tiles = (hw + kEntryPixels - 1) / kEntryPixels;
  const long long total = (long long)spp * bs * tiles;
  const int tid = threadIdx.x;
  const int runs = cf * (kEntryPixels / 8);
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const long long n = t / tiles;  // s * bs + b
    const long long p0 = (t - n * tiles) * kEntryPixels;
    const int s = (int)(n / bs), b = (int)(n - (long long)s * bs);
    const long long left = hw - p0;
    const int np = left < kEntryPixels ? (int)left : kEntryPixels;
    const T* src = x + b * x_bs + s * x_ss + p0;
    for (int r0 = tid; r0 < runs; r0 += kEntryLoads * kThreads) {
      float f[kEntryLoads][8];
#pragma unroll
      for (int u = 0; u < kEntryLoads; ++u) {
        const int r = r0 + u * kThreads;
        const int c = r >> 3, p = (r & 7) * 8;
        if (r >= runs || p >= np) continue;
        const T* q = src + (long long)c * hw + p;
        if (VEC && p + 8 <= np) {
          load_run8(q, f[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            f[u][j] = p + j < np ? to_float(q[j]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kEntryLoads; ++u) {
        const int r = r0 + u * kThreads;
        const int c = r >> 3, p = (r & 7) * 8;
        if (r >= runs || p >= np) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (p + j < np)
            tile[(p + j) * kp + c] = __float2bfloat16_rn(f[u][j]);
      }
    }
    // The global features and the zero channels.
    for (int i = tid; i < (k - cf) * kEntryPixels; i += kThreads) {
      const int c = cf + i / kEntryPixels, p = i % kEntryPixels;
      if (p < np)
        tile[p * kp + c] = __float2bfloat16_rn(
            c < cf + cg ? gf[b * cg + (c - cf)] : 0.f);
    }
    __syncthreads();
    // The tile's np rows are contiguous in the output: np * k / 2 words.
    const int words = k / 2;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (n * hw + p0) * k);
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(tile);
    for (int i = tid; i < np * words; i += kThreads) {
      const int p = i / words, j = i - p * words;
      dst[i] = tw[p * (kp / 2) + j];
    }
    __syncthreads();
  }
}

// --- Per-sample epilogue ----------------------------------------------------

// Eight float32 values of a float32 or bf16 row at vector index v.
template <bool F32>
__device__ __forceinline__ void load8(const void* z, long long v, float* f) {
  if (F32) {
    const float4* p = static_cast<const float4*>(z) + 2 * v;
    const float4 a = p[0], b = p[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    const uint4 u = static_cast<const uint4*>(z)[v];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return o;
}

// Pixels q of [bs, hw] (rows of a sample), each thread one pixel's channel
// vector across the samples; out may be z when z is bf16.
template <int ACT, bool ZF32>
__global__ void __launch_bounds__(kThreads)
    chain_epilogue(const void* z, const float* __restrict__ e,
                   const uint4* __restrict__ bias, uint4* out,
                   const float* __restrict__ mask,
                   const float* __restrict__ nvalid,
                   uint4* __restrict__ reduced, int bs, int spp, long long hw,
                   int cv) {
  __shared__ uint4 sb[kMaxVecs];
  stage_bias(sb, bias, cv);
  const long long pixels = (long long)bs * hw, plane = pixels * cv;
  for (long long q = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       q < pixels; q += (long long)gridDim.x * blockDim.y) {
    const int b = (int)(q / hw);
    for (int c = threadIdx.x; c < cv; c += blockDim.x) {
      const long long v0 = q * cv + c;
      float ev[8];
      if (e != nullptr)
        load8<true>(e, v0, ev);
      float bv[8], acc[8];
      load8<false>(sb, c, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int s = 0; s < spp; ++s) {
        const long long v = s * plane + v0;
        float f[8];
        load8<ZF32>(z, v, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float y = f[i];
          if (e != nullptr) y += ev[i];
          if (ZF32 || e != nullptr) y = round_bf16(y);
          f[i] = round_bf16(bias_act<ACT>(y, bv[i]));
        }
        out[v] = pack8(f);
        if (mask != nullptr) {
          const float m = mask[b * spp + s];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += round_bf16(f[i] * m);
        }
      }
      if (mask != nullptr) {
        const float nv = nvalid[b];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = round_bf16(acc[i]) / nv;
        reduced[v0] = pack8(acc);
      }
    }
  }
}

// The per-sample epilogue's backward: dy and the saved output (read only
// for an activation with a derivative) as [spp, bs, hw] rows, dz dense;
// dred ([bs, hw], nullable) the mean's gradient; dsum ([bs, hw], nullable)
// the sum of dz over the samples. One partial row of bias sums a block;
// the channel vectors are the outer loop, as in unet_epilogue_bwd.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    chain_epilogue_bwd(const uint4* __restrict__ dy,
                       const uint4* __restrict__ out,
                       const uint4* __restrict__ dred,
                       const float* __restrict__ mask,
                       const float* __restrict__ nvalid,
                       uint4* __restrict__ dz, uint4* __restrict__ dsum,
                       float* __restrict__ partials, int bs, int spp,
                       long long hw, int cv) {
  const long long pixels = (long long)bs * hw, plane = pixels * cv;
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (int c0 = 0; c0 < cv; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool active = c < cv;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (long long q = (long long)blockIdx.x * blockDim.y + threadIdx.y;
         active && q < pixels; q += stride) {
      const int b = (int)(q / hw);
      const long long v0 = q * cv + c;
      float dm[8];
      if (dred != nullptr) {
        load8<false>(dred, v0, dm);
        const float nv = nvalid[b];
#pragma unroll
        for (int i = 0; i < 8; ++i) dm[i] = round_bf16(dm[i] / nv);
      }
      float ssum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int s = 0; s < spp; ++s) {
        const long long v = s * plane + v0;
        uint4 g = dy[v];
        if (dred != nullptr) {
          const float m = mask[b * spp + s];
          float f[8];
          load8<false>(&g, 0, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] += round_bf16(dm[i] * m);
          g = pack8(f);
        }
        const uint4 o = ACT == kLinear ? g : out[v];
        const uint4 d = act_grad8<ACT>(g, o, acc);
        dz[v] = d;
        if (dsum != nullptr) {
          float f[8];
          load8<false>(&d, 0, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) ssum[i] += f[i];
        }
      }
      if (dsum != nullptr) dsum[v0] = pack8(ssum);
    }
    block_partial(acc, active, c, partials + (long long)blockIdx.x * cv * 8);
  }
}

// --- Logits -----------------------------------------------------------------

// The sum of a block's per-thread values, in a fixed order (warps by
// shuffles, then the warps in order); the result in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t += warps[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float clamp_logit(float y, float b, float lim) {
  const float r = round_bf16(y + b);
  return isnan(r) ? r : fminf(fmaxf(r, -lim), lim);
}

// Rows [n, k2] of hw logits, a block a row (its channel's bias uniform);
// VEC: hw a multiple of 8, eight values a thread.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    chain_logits(__nv_bfloat16* z, const __nv_bfloat16* __restrict__ bias,
                 float lim, long long rows, int k2, long long hw) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float b = __bfloat162float(bias[r % k2]);
    __nv_bfloat16* row = z + r * hw;
    if (VEC) {
      uint4* rv = reinterpret_cast<uint4*>(row);
      for (long long v = threadIdx.x; v < hw / 8; v += kThreads) {
        float f[8];
        load8<false>(rv, v, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = clamp_logit(f[i], b, lim);
        rv[v] = pack8(f);
      }
    } else {
      for (long long i = threadIdx.x; i < hw; i += kThreads)
        row[i] = __float2bfloat16_rn(
            clamp_logit(__bfloat162float(row[i]), b, lim));
    }
  }
}

__device__ __forceinline__ float logit_grad(float g, float o, float lim) {
  return fabsf(o) < lim ? g : 0.f;
}

// One sample's rows [bs, k2] of hw: dz and each row's float32 sum of dz
// into part[row].
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    chain_logits_bwd(const __nv_bfloat16* __restrict__ g,
                     const __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ dz, float* __restrict__ part,
                     float lim, long long rows, long long hw) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long base = r * hw;
    float acc = 0.f;
    if (VEC) {
      const uint4* gv = reinterpret_cast<const uint4*>(g + base);
      const uint4* ov = reinterpret_cast<const uint4*>(out + base);
      uint4* dv = reinterpret_cast<uint4*>(dz + base);
      for (long long v = threadIdx.x; v < hw / 8; v += kThreads) {
        float fg[8], fo[8];
        load8<false>(gv, v, fg);
        load8<false>(ov, v, fo);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          fg[i] = logit_grad(fg[i], fo[i], lim);
          acc += fg[i];
        }
        dv[v] = pack8(fg);
      }
    } else {
      for (long long i = threadIdx.x; i < hw; i += kThreads) {
        const float d = logit_grad(__bfloat162float(g[base + i]),
                                   __bfloat162float(out[base + i]), lim);
        acc += d;
        dz[base + i] = __float2bfloat16_rn(d);
      }
    }
    const float t = block_sum(acc);
    if (threadIdx.x == 0) part[r] = t;
  }
}

unsigned grid_of(long long blocks, int sms) {
  const long long cap = (long long)sms * kBlocksPerSm;
  return (unsigned)(blocks < 1 ? 1 : blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// features x ([bs, spp, cf, hw]: batch item b, sample s at b * x_bs + s *
// x_ss elements, its cf planes of hw contiguous; x_dtype 0 float32, 1
// float16, 2 bf16) and gf ([bs, cg] float32, nullable when cg is 0) to out
// ([spp, bs, hw, k] bf16: the features, the global features, zeros). k a
// multiple of 8, at least cf + cg, at most 256. Returns a CUDA error code.
int sbmc_chain_entry(const void* x, int x_dtype, long long x_bs,
                     long long x_ss, int cf, const void* gf, int cg,
                     void* out, int k, int bs, int spp, long long hw, int sms,
                     void* stream) {
  if (cf <= 0 || cg < 0 || (cg > 0 && gf == nullptr) || k % 8 != 0 ||
      k < cf + cg || k > kEntryMaxK || bs <= 0 || spp <= 0 || hw <= 0 ||
      x_dtype < 0 || x_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles =
      (long long)spp * bs * ((hw + kEntryPixels - 1) / kEntryPixels);
  const unsigned grid = grid_of(tiles, sms);
  const float* g = static_cast<const float*>(gf);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  // Runs of 8 values start on 16 bytes where every plane does.
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && hw % 8 == 0 &&
                   x_bs % 8 == 0 && x_ss % 8 == 0;
#define SBMC_CHAIN_ENTRY(T, V)                                            \
  chain_entry<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),   \
                                              x_bs, x_ss, cf, g, cg, o, k, \
                                              bs, spp, hw)
  if (x_dtype == 0) {
    if (vec) SBMC_CHAIN_ENTRY(float, true);
    else SBMC_CHAIN_ENTRY(float, false);
  } else if (x_dtype == 1) {
    if (vec) SBMC_CHAIN_ENTRY(__half, true);
    else SBMC_CHAIN_ENTRY(__half, false);
  } else {
    if (vec) SBMC_CHAIN_ENTRY(__nv_bfloat16, true);
    else SBMC_CHAIN_ENTRY(__nv_bfloat16, false);
  }
#undef SBMC_CHAIN_ENTRY
  return (int)cudaGetLastError();
}

// The epilogue of a per-sample layer's product z ([spp, bs, hw, c], bf16, or
// float32 with z_f32) into out (the same rows, bf16; may be z when bf16):
// out = act(bf16(bf16(z + e) + bias)), e ([bs, hw, c] float32, nullable)
// added to every sample's row of its pixel. With mask ([bs, spp] float32,
// nullable) and nvalid ([bs] float32) also reduced ([bs, hw, c] bf16), the
// masked mean over the samples. act: 0 linear, 1 ReLU, 2 leaky ReLU.
// Returns a CUDA error code.
int sbmc_chain_epilogue(const void* z, int z_f32, const void* e,
                        const void* bias, int act, void* out,
                        const void* mask, const void* nvalid, void* reduced,
                        int bs, int spp, long long hw, int c, int sms,
                        void* stream) {
  if (c <= 0 || c % 8 != 0 || c / 8 > kMaxVecs || act < 0 || act > 2 ||
      bs <= 0 || spp <= 0 || hw <= 0 ||
      (mask != nullptr && (nvalid == nullptr || reduced == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(((long long)bs * hw + block.y - 1) / block.y,
                                sms);
  const float* ev = static_cast<const float*>(e);
  const uint4* bv = static_cast<const uint4*>(bias);
  uint4* ov = static_cast<uint4*>(out);
  const float* mv = static_cast<const float*>(mask);
  const float* nv = static_cast<const float*>(nvalid);
  uint4* rv = static_cast<uint4*>(reduced);
#define SBMC_CHAIN_EPI(A, F)                                            \
  chain_epilogue<A, F><<<grid, block, 0, s>>>(z, ev, bv, ov, mv, nv, rv, \
                                              bs, spp, hw, cv)
  if (z_f32) {
    if (act == kRelu) SBMC_CHAIN_EPI(kRelu, true);
    else if (act == kLeaky) SBMC_CHAIN_EPI(kLeaky, true);
    else SBMC_CHAIN_EPI(kLinear, true);
  } else {
    if (act == kRelu) SBMC_CHAIN_EPI(kRelu, false);
    else if (act == kLeaky) SBMC_CHAIN_EPI(kLeaky, false);
    else SBMC_CHAIN_EPI(kLinear, false);
  }
#undef SBMC_CHAIN_EPI
  return (int)cudaGetLastError();
}

// The per-sample epilogue's backward: dy (the gradient of its output,
// [spp, bs, hw, c] bf16) and out (the saved output, nullable for act 0)
// give dz (the same rows) and dbias ([c] float32, each a bf16 value); with
// dred ([bs, hw, c] bf16, nullable; mask and nvalid as the forward's) the
// mean's gradient joins dy first; with dsum ([bs, hw, c] bf16, nullable)
// also the sum of dz over the samples. `partials`: a float32 workspace of
// `nparts` rows of c values. Returns a CUDA error code.
int sbmc_chain_epilogue_backward(const void* dy, const void* out, int act,
                                 const void* dred, const void* mask,
                                 const void* nvalid, void* dz, void* dsum,
                                 void* partials, int nparts, void* dbias,
                                 int bs, int spp, long long hw, int c, int sms,
                                 void* stream) {
  if (c <= 0 || c % 8 != 0 || act < 0 || act > 2 || bs <= 0 || spp <= 0 ||
      hw <= 0 || nparts <= 0 || (act != kLinear && out == nullptr) ||
      (dred != nullptr && (mask == nullptr || nvalid == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = ((long long)bs * hw + block.y - 1) / block.y;
  long long cap = (long long)sms * kBlocksPerSm;
  if (cap > nparts) cap = nparts;
  const int used = (int)(blocks < cap ? blocks : cap);
  const uint4* gv = static_cast<const uint4*>(dy);
  const uint4* ov = static_cast<const uint4*>(out);
  const uint4* rv = static_cast<const uint4*>(dred);
  const float* mv = static_cast<const float*>(mask);
  const float* nv = static_cast<const float*>(nvalid);
  uint4* zv = static_cast<uint4*>(dz);
  uint4* sv = static_cast<uint4*>(dsum);
  float* pv = static_cast<float*>(partials);
  if (act == kRelu)
    chain_epilogue_bwd<kRelu><<<used, block, 0, s>>>(gv, ov, rv, mv, nv, zv,
                                                     sv, pv, bs, spp, hw, cv);
  else if (act == kLeaky)
    chain_epilogue_bwd<kLeaky><<<used, block, 0, s>>>(gv, ov, rv, mv, nv, zv,
                                                      sv, pv, bs, spp, hw, cv);
  else
    chain_epilogue_bwd<kLinear><<<used, block, 0, s>>>(
        gv, ov, rv, mv, nv, zv, sv, pv, bs, spp, hw, cv);
  unet_bias_sum<<<(c + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      pv, used, c, static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

// The regressor's logits z ([n, k2, hw] bf16, in place): clamp(bf16(z +
// bias), -lim, lim), bias [k2] bf16. Returns a CUDA error code.
int sbmc_chain_logits(void* z, const void* bias, float lim, int n, int k2,
                      long long hw, int sms, void* stream) {
  if (n <= 0 || k2 <= 0 || hw <= 0 || !(lim > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)n * k2;
  const unsigned grid = grid_of(rows, sms);
  __nv_bfloat16* zv = static_cast<__nv_bfloat16*>(z);
  const __nv_bfloat16* bv = static_cast<const __nv_bfloat16*>(bias);
  if (hw % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0)
    chain_logits<true><<<grid, kThreads, 0, s>>>(zv, bv, lim, rows, k2, hw);
  else
    chain_logits<false><<<grid, kThreads, 0, s>>>(zv, bv, lim, rows, k2, hw);
  return (int)cudaGetLastError();
}

// One sample's logits gradient g ([n, k2, hw] bf16) and saved logits out to
// dz (the same shape): g where |out| < lim, else 0; each row's float32 sum
// into partials row row0 + r (partials: [nparts, k2] float32). With dbias
// non-null (the last sample's call) the nparts rows are then summed into
// dbias ([k2] float32, each a bf16 value). Returns a CUDA error code.
int sbmc_chain_logits_backward(const void* g, const void* out, void* dz,
                               void* partials, int row0, int n, int nparts,
                               void* dbias, float lim, int k2, long long hw,
                               int sms, void* stream) {
  if (n <= 0 || k2 <= 0 || hw <= 0 || row0 < 0 || row0 + n > nparts ||
      !(lim > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)n * k2;
  const unsigned grid = grid_of(rows, sms);
  const __nv_bfloat16* gv = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* ov = static_cast<const __nv_bfloat16*>(out);
  __nv_bfloat16* zv = static_cast<__nv_bfloat16*>(dz);
  float* pv = static_cast<float*>(partials);
  float* part = pv + (long long)row0 * k2;
  const bool vec = hw % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  if (vec)
    chain_logits_bwd<true><<<grid, kThreads, 0, s>>>(gv, ov, zv, part, lim,
                                                     rows, hw);
  else
    chain_logits_bwd<false><<<grid, kThreads, 0, s>>>(gv, ov, zv, part, lim,
                                                      rows, hw);
  if (dbias != nullptr)
    unet_bias_sum<<<(k2 + 31) / 32, dim3(32, kSumRows), 0, s>>>(
        pv, nparts, k2, static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

}  // extern "C"
