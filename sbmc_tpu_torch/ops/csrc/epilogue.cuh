// Helpers of the hand-written epilogues after cuBLAS and cuDNN products on
// channels-last (pixel-major) bf16 tensors, and of their backward, shared by
// unet.cu (the U-Net's convolutions) and chain_train.cu (the per-sample 1x1
// chains of the train step): the rounding of a bias and an activation as
// WNConv2D.forward and ConvChain round them, the activation's gradient as
// PyTorch's autograd rounds it, the thread layout, and the bias gradient as
// float32 partial rows summed in a fixed order. Include at file scope.

#ifndef SBMC_EPILOGUE_CUH_
#define SBMC_EPILOGUE_CUH_

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecs = 512;  // channel vectors (8 channels) a pixel
constexpr int kUnroll = 4;     // pixels a thread has in flight (plain pass)
constexpr int kMaxGridY = 65535;

enum Act { kLinear = 0, kRelu = 1, kLeaky = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(y + b), then the activation as PyTorch computes it for bf16 tensors
// (in float32, one rounding).
template <int ACT>
__device__ __forceinline__ float bias_act(float y, float b) {
  const float r = round_bf16(y + b);
  if (ACT == kRelu) return r < 0.f ? 0.f : r;
  if (ACT == kLeaky) return r > 0.f ? r : r * 0.01f;
  return r;
}

__device__ __forceinline__ void stage_bias(uint4* sb, const uint4* bias,
                                           int cv) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < cv; i += blockDim.x * blockDim.y) sb[i] = bias[i];
  __syncthreads();
}

// Threads of a block: x over the channel vectors (at most a warp), y over
// pixels.
dim3 block_of(int cv) {
  const int bx = cv < 32 ? cv : 32;
  return dim3(bx, kThreads / bx);
}

// Blocks an SM of the backward kernels' grids: the bias partials' rows.
constexpr int kBlocksPerSm = 2048 / kThreads;

// dz of eight channels from the epilogue output's gradient g and the saved
// output o, as PyTorch's backward of F.relu (threshold_backward on the
// result: o <= 0 gives 0), F.leaky_relu (o > 0 passes, else g * 0.01, one
// rounding) and the identity compute it in bf16; adds dz to acc.
template <int ACT>
__device__ __forceinline__ uint4 act_grad8(uint4 g, uint4 o, float* acc) {
  const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&g);
  const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&o);
  uint4 d;
  __nv_bfloat162* pd = reinterpret_cast<__nv_bfloat162*>(&d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fg = __bfloat1622float2(pg[i]);
    const float2 fo = __bfloat1622float2(po[i]);
    float d0 = fg.x, d1 = fg.y;
    if (ACT == kRelu) {
      d0 = fo.x <= 0.f ? 0.f : d0;
      d1 = fo.y <= 0.f ? 0.f : d1;
    } else if (ACT == kLeaky) {
      d0 = fo.x > 0.f ? d0 : round_bf16(d0 * 0.01f);
      d1 = fo.y > 0.f ? d1 : round_bf16(d1 * 0.01f);
    }
    acc[2 * i] += d0;
    acc[2 * i + 1] += d1;
    pd[i] = __floats2bfloat162_rn(d0, d1);
  }
  return d;
}

// The block's float32 sums of eight channels (thread column x, channel
// vector cvec) over its rows of threads, in row order, as one partial row
// of `c` values at `part`. Every thread of the block calls it.
__device__ __forceinline__ void block_partial(const float* acc, bool active,
                                              int cvec, float* part) {
  __shared__ float red[kThreads][8];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) red[tid][i] = active ? acc[i] : 0.f;
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int r = 0; r < (int)blockDim.y; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += red[r * blockDim.x + threadIdx.x][i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) part[cvec * 8 + i] = s[i];
  }
  __syncthreads();
}

// The bias gradient from `nparts` partial rows of `c` sums: a thread sums a
// channel's rows r, r + 32, ... (r its row of threads) into four running
// sums (rows 4k + j into sum j, so four loads are in flight: the pass is
// bound by their latency), and the block adds the rows' sums in order; each
// channel is rounded once to bf16 and stored as float32. The order is fixed
// by nparts alone.
constexpr int kSumRows = 32;
__global__ void __launch_bounds__(32 * kSumRows)
    unet_bias_sum(const float* __restrict__ partials, int nparts, int c,
                  float* __restrict__ dbias) {
  __shared__ float red[kSumRows][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (ch < c) {
    int r = threadIdx.y;
    for (; r + 3 * kSumRows < nparts; r += 4 * kSumRows) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] += partials[(long long)(r + j * kSumRows) * c + ch];
    }
    for (; r < nparts; r += kSumRows) s[0] += partials[(long long)r * c + ch];
  }
  red[threadIdx.y][threadIdx.x] = (s[0] + s[1]) + (s[2] + s[3]);
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    float t = 0.f;
    for (int r = 0; r < kSumRows; ++r) t += red[r][threadIdx.x];
    dbias[ch] = round_bf16(t);
  }
}

}  // namespace

#endif  // SBMC_EPILOGUE_CUH_
