// The passes around the 3x3 convolutions of SBMC's propagation U-Net
// (nn/layers.py: Autoencoder) for Hopper, at inference and in the train
// step, in channels-last (NHWC) bf16:
//
// - unet_epilogue: after each cuDNN convolution (run without its bias), the
//   bias and the activation, rounded as WNConv2D.forward and ConvChain round
//   them (the product to bf16, then bf16(y + b), then the activation in
//   float32 and one more rounding), written in place, or into a channel slot
//   of a wider NHWC tensor (the skip's slot of the U-Net's concatenation
//   buffer); optionally the 2x2 max-pool of the result (floor on odd sizes,
//   as F.max_pool2d(x, 2)) in the same pass, the next level's input.
// - unet_upsample: the bilinear upsample of a coarse NHWC tensor to the
//   skip's exact size (F.interpolate(mode="bilinear", align_corners=False):
//   the same float arithmetic as PyTorch's CUDA kernel, one rounding to
//   bf16), written straight into the upsampled slot of the concatenation
//   buffer.
// - unet_layout: the U-Net's input from NCHW to channels-last and its output
//   back, once each a call (the per-sample chains around it read and write
//   NCHW).
//
// They replace no Pallas kernel: on the TPU, XLA fused the bias, the
// activation, the pooling, the resize and the concatenation into the
// convolutions' neighbours. On the card the NCHW U-Net spent more time
// around its convolutions than in them: cuDNN transposed every activation
// into and out of its NHWC kernels, and the broadcast bias add, the
// activation, the max-pool, the upsample and torch.cat each read and wrote
// the activations once more. (PyTorch's own strided copy to channels-last
// moves a 1080x2048x128 tensor at a tenth of the bandwidth, hence
// unet_layout.)
//
// What bounds them on this card: bytes (a handful of operations a value).
// So each value is read once and written once, 16 bytes a thread (eight
// channels of one pixel: the channel count is a multiple of 8), and
// nothing else reaches device memory:
//
// - A block is a 2D grid of threads: x over the pixel's channel vectors, y
//   over pixels (or pooling cells, or output columns), so a warp's loads and
//   stores are runs of whole pixels. The bias is staged once a block in
//   shared memory. No division runs per element: pixels are walked
//   linearly, and the pooled and upsampled passes walk rows (blockIdx.y)
//   and columns.
// - The pooled epilogue walks 2x2 cells: each thread rounds and stores the
//   cell's four pixels (three, two or one at an odd edge) and writes their
//   max, so the skip and the pool leave in one pass.
// - The upsample's source rows and weights are computed once a row pair,
//   its columns once a column pair: a thread writes a 2x2 block of outputs
//   from the 3x3 source pixels they share (the U-Net's upsamples at least
//   double), 2.25 reads an output instead of 4, which the L2 would otherwise
//   serve at more than the memory's bandwidth.
// - The layout change transposes 8 channels x 16 (to channels-last) or 8
//   pixels (back) in a thread's registers (byte permutes); its writes are
//   runs of whole 32-byte sectors across a warp.
//
// Any batch, any size; the channel count a multiple of 8 up to 4096, the
// output's pixel stride a multiple of 8 channels. Every output value has
// one writer.
//
// The train step's backward of the same passes (the convolutions' own
// gradients are cuDNN's NHWC dgrad and wgrad, run by the wrapper):
//
// - unet_epilogue_backward: from the gradient of one epilogue's output (a
//   dense tensor, or the skip's slot of the concatenation buffer's
//   gradient) and its saved output, the gradient of the convolution's
//   output, dz = act'(out) * dy, rounded as PyTorch's autograd rounds it
//   (ReLU passes or zeroes, the leaky slope one rounding of dy * 0.01), and
//   the bias gradient, the float32 sum of dz over the pixels rounded once to
//   bf16. For each level's last left convolution the 2x2 max-pool's
//   gradient joins dy first: each window's argmax is recomputed from the
//   saved output as F.max_pool2d picks it (the first maximum in row-major
//   window order, a NaN wins), and dy + dpool is rounded once there, as
//   autograd adds two gradients of one tensor; an odd last row or column
//   gets none.
// - unet_upsample_backward: the transpose of unet_upsample, from the
//   upsampled slot of the concatenation buffer's gradient to the coarse
//   tensor, in gather form: each coarse pixel sums in float32 the fine
//   pixels that read it, weighted as the forward weighs them, and rounds
//   once. PyTorch's NCHW backward scatters with atomics instead.
//
// Both are bound by bytes too, and keep the forward's layout of threads.
// The epilogue's backward reads dy and the saved output once and writes dz
// once, 16 bytes a thread; its bias sums stay in registers along the
// thread's pixels, are summed over the block's rows in shared memory in a
// fixed order, and leave as one float32 partial a block; a second small
// pass sums the partials in a fixed order. No atomics: the result does not
// depend on the schedule. The upsample's backward writes each coarse pixel
// once; it reads each fine pixel four times at a doubling (2x2 coarse
// pixels read it), from neighbouring threads and blocks, so the L2 serves
// the repeats and device memory sees each value about once. (A thread
// taking a 2x2 block of coarse pixels and loading the fine pixels they
// share once, 36 loads for 4 outputs where this takes 64, measured slower
// on an H100: 84 against 68 us at the train cell's second level.)

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

template <int ACT>
__device__ __forceinline__ uint4 epilogue8(uint4 v, uint4 b) {
  const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fv = __bfloat1622float2(pv[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    po[i] = __floats2bfloat162_rn(bias_act<ACT>(fv.x, fb.x),
                                  bias_act<ACT>(fv.y, fb.y));
  }
  return o;
}

// F.max_pool2d's comparison: a NaN wins, then the larger value, in window
// order.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// The max of a 2x2 cell's four vectors, in window order.
__device__ __forceinline__ uint4 max8(const uint4* v) {
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(&v[j])[i]);
      m0 = max_nan(m0, f.x);
      m1 = max_nan(m1, f.y);
    }
    po[i] = __floats2bfloat162_rn(m0, m1);
  }
  return o;
}

__device__ __forceinline__ void stage_bias(uint4* sb, const uint4* bias,
                                           int cv) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < cv; i += blockDim.x * blockDim.y) sb[i] = bias[i];
  __syncthreads();
}

// The plain epilogue: `pixels` pixels of `cv` vectors, y dense, out at a
// pixel stride of `ldo` vectors (y and out may be the same tensor).
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    unet_epilogue(const uint4* y, const uint4* __restrict__ bias, uint4* out,
                  long long ldo, long long pixels, int cv) {
  __shared__ uint4 sb[kMaxVecs];
  stage_bias(sb, bias, cv);
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long p0 = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       p0 < pixels; p0 += stride * kUnroll) {
    for (int c = threadIdx.x; c < cv; c += blockDim.x) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long p = p0 + u * stride;
        if (p < pixels) v[u] = y[p * cv + c];
      }
      const uint4 b = sb[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long p = p0 + u * stride;
        if (p < pixels) out[p * ldo + c] = epilogue8<ACT>(v[u], b);
      }
    }
  }
}

// The pooled epilogue: 2x2 cells of a [bs, h, w] grid, ceil(h/2) x ceil(w/2)
// a batch item; full cells also write their max to `pool`
// ([bs, h/2, w/2, cv], dense).
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    unet_epilogue_pool(const uint4* y, const uint4* __restrict__ bias,
                       uint4* out, long long ldo, uint4* __restrict__ pool,
                       int bs, int h, int w, int cv) {
  __shared__ uint4 sb[kMaxVecs];
  stage_bias(sb, bias, cv);
  const int hc = (h + 1) / 2, wc = (w + 1) / 2, hp = h / 2, wp = w / 2;
  for (long long row = blockIdx.y; row < (long long)bs * hc;
       row += gridDim.y) {
    const long long n = row / hc;
    const int oy = (int)(row - n * hc);
    const int y0 = 2 * oy;
    const bool has_y1 = y0 + 1 < h;
    for (int ox = blockIdx.x * blockDim.y + threadIdx.y; ox < wc;
         ox += gridDim.x * blockDim.y) {
      const int x0 = 2 * ox;
      const bool has_x1 = x0 + 1 < w;
      const long long p00 = (n * h + y0) * w + x0;
      const long long pix[4] = {p00, p00 + 1, p00 + w, p00 + w + 1};
      const bool here[4] = {true, has_x1, has_y1, has_x1 && has_y1};
      for (int c = threadIdx.x; c < cv; c += blockDim.x) {
        uint4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (here[j]) v[j] = y[pix[j] * cv + c];
        const uint4 b = sb[c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (here[j]) {
            v[j] = epilogue8<ACT>(v[j], b);
            out[pix[j] * ldo + c] = v[j];
          }
        }
        if (has_x1 && has_y1)
          pool[((n * hp + oy) * wp + ox) * cv + c] = max8(v);
      }
    }
  }
}

// A source index of upsample_bilinear2d (align_corners=False): i0 and its
// neighbour i1 (clamped to the last), and their weights.
struct Tap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Tap tap(float scale, int dst, int in) {
  float r = scale * (dst + 0.5f) - 0.5f;
  r = r < 0.f ? 0.f : r;
  Tap t;
  t.i0 = (int)r;
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.l1 = r - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// upsample_bilinear2d's expression for eight channels, one rounding.
__device__ __forceinline__ uint4 lerp8(uint4 v00, uint4 v01, uint4 v10,
                                       uint4 v11, Tap y, Tap x) {
  const __nv_bfloat162* p00 = reinterpret_cast<const __nv_bfloat162*>(&v00);
  const __nv_bfloat162* p01 = reinterpret_cast<const __nv_bfloat162*>(&v01);
  const __nv_bfloat162* p10 = reinterpret_cast<const __nv_bfloat162*>(&v10);
  const __nv_bfloat162* p11 = reinterpret_cast<const __nv_bfloat162*>(&v11);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f00 = __bfloat1622float2(p00[i]);
    const float2 f01 = __bfloat1622float2(p01[i]);
    const float2 f10 = __bfloat1622float2(p10[i]);
    const float2 f11 = __bfloat1622float2(p11[i]);
    po[i] = __floats2bfloat162_rn(
        y.l0 * (x.l0 * f00.x + x.l1 * f01.x) +
            y.l1 * (x.l0 * f10.x + x.l1 * f11.x),
        y.l0 * (x.l0 * f00.y + x.l1 * f01.y) +
            y.l1 * (x.l0 * f10.y + x.l1 * f11.y));
  }
  return o;
}

// F.interpolate(x, (ho, wo), mode="bilinear", align_corners=False) of x
// [bs, hi, wi, cv] into out [bs, ho, wo] at a pixel stride of `ldo` vectors,
// in upsample_bilinear2d's arithmetic: source index (dst + 0.5) * in / out
// - 0.5 clamped at 0, float32 weights, one rounding. At least a doubling
// (2 hi <= ho, 2 wi <= wo), so two neighbouring outputs' source indices
// differ by at most one: a thread computes a 2x2 block of outputs from the
// 3x3 source pixels around it (nine 16-byte reads for four outputs, not
// sixteen).
__global__ void __launch_bounds__(kThreads)
    unet_upsample(const uint4* __restrict__ x, uint4* __restrict__ out,
                  long long ldo, int bs, int hi, int wi, int ho, int wo,
                  int cv) {
  const float rh = (float)hi / ho, rw = (float)wi / wo;
  const int hb = (ho + 1) / 2, wb = (wo + 1) / 2;
  for (long long row = blockIdx.y; row < (long long)bs * hb;
       row += gridDim.y) {
    const long long n = row / hb;
    const int oy = 2 * (int)(row - n * hb);
    const bool has_y1 = oy + 1 < ho;
    const Tap ty0 = tap(rh, oy, hi), ty1 = tap(rh, oy + 1, hi);
    // Source rows ty0.i0, +1, +2 (clamped); the second output row starts
    // at the first's or the next.
    const long long rstride = (long long)wi * cv;
    const uint4* r0 = x + (n * hi + ty0.i0) * rstride;
    const uint4* r1 = x + (n * hi + ty0.i1) * rstride;
    const uint4* r2 =
        x + (n * hi + (ty0.i1 < hi - 1 ? ty0.i1 + 1 : ty0.i1)) * rstride;
    const bool dy = ty1.i0 != ty0.i0;
    uint4* o0 = out + (n * ho + oy) * wo * ldo;
    uint4* o1 = o0 + (long long)wo * ldo;
    for (int ox = 2 * (blockIdx.x * blockDim.y + threadIdx.y); ox < wo;
         ox += 2 * gridDim.x * blockDim.y) {
      const bool has_x1 = ox + 1 < wo;
      const Tap tx0 = tap(rw, ox, wi), tx1 = tap(rw, ox + 1, wi);
      const long long c0 = (long long)tx0.i0 * cv, c1 = (long long)tx0.i1 * cv,
                      c2 = (long long)(tx0.i1 < wi - 1 ? tx0.i1 + 1 : tx0.i1) *
                           cv;
      const bool dx = tx1.i0 != tx0.i0;
      for (int c = threadIdx.x; c < cv; c += blockDim.x) {
        const uint4 a0 = r0[c0 + c], a1 = r0[c1 + c], a2 = r0[c2 + c];
        const uint4 b0 = r1[c0 + c], b1 = r1[c1 + c], b2 = r1[c2 + c];
        const uint4 e0 = r2[c0 + c], e1 = r2[c1 + c], e2 = r2[c2 + c];
        o0[ox * ldo + c] = lerp8(a0, a1, b0, b1, ty0, tx0);
        if (has_x1)
          o0[(ox + 1) * ldo + c] = dx ? lerp8(a1, a2, b1, b2, ty0, tx1)
                                      : lerp8(a0, a1, b0, b1, ty0, tx1);
        if (has_y1) {
          const uint4 t0 = dy ? b0 : a0, t1 = dy ? b1 : a1, t2 = dy ? b2 : a2;
          const uint4 u0 = dy ? e0 : b0, u1 = dy ? e1 : b1, u2 = dy ? e2 : b2;
          o1[ox * ldo + c] = lerp8(t0, t1, u0, u1, ty1, tx0);
          if (has_x1)
            o1[(ox + 1) * ldo + c] = dx ? lerp8(t1, t2, u1, u2, ty1, tx1)
                                        : lerp8(t0, t1, u0, u1, ty1, tx1);
        }
      }
    }
  }
}

// Eight channels of 16 pixels (NCHW: eight rows of 32 bytes) to 16 pixels
// of eight channels (NHWC: sixteen 16-byte vectors), or back: a transpose
// in registers, two bf16 of a 32-bit word at a time.
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int half) {
  return __byte_perm(lo, hi, half ? 0x7632 : 0x5410);
}

// [bs, c, P] -> [bs, P, c] bf16 (P = h * w pixels, a multiple of 16), a
// thread 8 channels x 16 pixels, threads along the channels: each NCHW
// row's 32 bytes are a whole sector, and a warp's NHWC writes runs of whole
// pixels.
__global__ void __launch_bounds__(kThreads)
    unet_layout_nhwc(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     int bs, long long pixels, int cv) {
  const long long groups = pixels / 16, total = (long long)bs * groups;
  const long long rowv = pixels / 8;  // vectors of an NCHW row
  for (long long g = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       g < total; g += (long long)gridDim.x * blockDim.y) {
    const long long n = g / groups, p0 = (g - n * groups) * 16;
    for (int c = threadIdx.x; c < cv; c += blockDim.x) {
      const long long nchw = ((n * cv + c) * 8) * rowv + p0 / 8;
      const long long nhwc = (n * pixels + p0) * cv + c;
      // in[2i + j / 8][(j % 8) / 2]: channel i, pixels j and j ^ 1.
      uint32_t in[16][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 a = src[nchw + i * rowv], b = src[nchw + i * rowv + 1];
        in[2 * i][0] = a.x, in[2 * i][1] = a.y, in[2 * i][2] = a.z,
        in[2 * i][3] = a.w;
        in[2 * i + 1][0] = b.x, in[2 * i + 1][1] = b.y,
        in[2 * i + 1][2] = b.z, in[2 * i + 1][3] = b.w;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = pair(in[4 * k + j / 8][(j % 8) / 2],
                      in[4 * k + 2 + j / 8][(j % 8) / 2], j & 1);
        dst[nhwc + j * cv] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// [bs, P, c] -> [bs, c, P] bf16 (P a multiple of 8), a thread 8 pixels x 8
// channels, a block 32 pixel groups x 8 channel vectors, threads along the
// pixels: a warp's writes are 512-byte runs of an NCHW row.
constexpr int kNchwGroups = 32, kNchwVecs = 8;
__global__ void __launch_bounds__(kThreads)
    unet_layout_nchw(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     int bs, long long pixels, int cv) {
  const long long rowv = pixels / 8;  // pixel groups, vectors of a row
  const long long gblocks = (rowv + kNchwGroups - 1) / kNchwGroups;
  const int cblocks = (cv + kNchwVecs - 1) / kNchwVecs;
  for (long long t = blockIdx.x; t < (long long)bs * gblocks * cblocks;
       t += gridDim.x) {
    const long long rest = t / cblocks, n = rest / gblocks;
    const long long g = (rest - n * gblocks) * kNchwGroups + threadIdx.x;
    const int c = (int)(t - rest * cblocks) * kNchwVecs + threadIdx.y;
    if (g >= rowv || c >= cv) continue;
    // in[j][i / 2]: pixel j, channels i and i ^ 1.
    uint32_t in[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 a = src[(n * pixels + 8 * g + j) * cv + c];
      in[j][0] = a.x, in[j][1] = a.y, in[j][2] = a.z, in[j][3] = a.w;
    }
    const long long row = (n * cv + c) * 8 * rowv + g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        w[m] = pair(in[2 * m][i / 2], in[2 * m + 1][i / 2], i & 1);
      dst[row + i * rowv] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The same for any number of pixels, a value a thread.
template <bool TO_NHWC>
__global__ void __launch_bounds__(kThreads)
    unet_layout_any(const __nv_bfloat16* __restrict__ src,
                    __nv_bfloat16* __restrict__ dst, long long pixels, int c,
                    long long total) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    // i runs over the destination.
    if (TO_NHWC) {
      const long long ch = i % c, np = i / c, n = np / pixels;
      dst[i] = src[(n * c + ch) * pixels + (np - n * pixels)];
    } else {
      const long long p = i % pixels, nc = i / pixels, n = nc / c;
      dst[i] = src[(n * pixels + p) * c + (nc - n * c)];
    }
  }
}

// Threads of a block: x over the channel vectors (at most a warp), y over
// pixels.
dim3 block_of(int cv) {
  const int bx = cv < 32 ? cv : 32;
  return dim3(bx, kThreads / bx);
}

// --- Backward -------------------------------------------------------------

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

// The plain epilogue's backward: `pixels` pixels, dy at a pixel stride of
// `ldy` vectors, the saved output at `ldo`, dz dense; one partial row of
// bias sums a block. The channel vectors are the outer loop, so a thread
// keeps one vector's sums while it walks its pixels.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    unet_epilogue_bwd(const uint4* __restrict__ dy, long long ldy,
                      const uint4* __restrict__ out, long long ldo,
                      uint4* __restrict__ dz, float* __restrict__ partials,
                      long long pixels, int cv) {
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (int c0 = 0; c0 < cv; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool active = c < cv;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (active) {
      for (long long p0 = (long long)blockIdx.x * blockDim.y + threadIdx.y;
           p0 < pixels; p0 += stride * kUnroll) {
        uint4 g[kUnroll], o[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long p = p0 + u * stride;
          if (p < pixels) {
            g[u] = dy[p * ldy + c];
            o[u] = out[p * ldo + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long p = p0 + u * stride;
          if (p < pixels) dz[p * cv + c] = act_grad8<ACT>(g[u], o[u], acc);
        }
      }
    }
    block_partial(acc, active, c, partials + (long long)blockIdx.x * cv * 8);
  }
}

// bf16(a + b) of eight channels where lane i's window argmax is pixel j
// (`arg` holds each lane's argmax), else a: the pool's gradient joins the
// argmax's.
__device__ __forceinline__ uint4 add_at(uint4 a, uint4 b, const int* arg,
                                        int j) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 o;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    po[i] = __floats2bfloat162_rn(arg[2 * i] == j ? fa.x + fb.x : fa.x,
                                  arg[2 * i + 1] == j ? fa.y + fb.y : fa.y);
  }
  return o;
}

// Each lane's argmax over a full 2x2 window's four vectors, in window order
// with max8's comparison (F.max_pool2d's: the first maximum, a NaN wins).
__device__ __forceinline__ void argmax8(const uint4* v, int* arg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m0 = -INFINITY, m1 = -INFINITY;
    int a0 = 0, a1 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(&v[j])[i]);
      if (f.x > m0 || isnan(f.x)) m0 = f.x, a0 = j;
      if (f.y > m1 || isnan(f.y)) m1 = f.y, a1 = j;
    }
    arg[2 * i] = a0;
    arg[2 * i + 1] = a1;
  }
}

// The pooled epilogue's backward: 2x2 cells of a [bs, h, w] grid as the
// forward walks them; a full cell adds dpool ([bs, h/2, w/2, cv], dense) to
// each lane's argmax before the activation's gradient.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    unet_epilogue_pool_bwd(const uint4* __restrict__ dy, long long ldy,
                           const uint4* __restrict__ out, long long ldo,
                           const uint4* __restrict__ dpool,
                           uint4* __restrict__ dz, float* __restrict__ partials,
                           int bs, int h, int w, int cv) {
  const int hc = (h + 1) / 2, wc = (w + 1) / 2, hp = h / 2, wp = w / 2;
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int c0 = 0; c0 < cv; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool active = c < cv;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (long long row = blockIdx.y; active && row < (long long)bs * hc;
         row += gridDim.y) {
      const long long n = row / hc;
      const int oy = (int)(row - n * hc);
      const int y0 = 2 * oy;
      const bool has_y1 = y0 + 1 < h;
      for (int ox = blockIdx.x * blockDim.y + threadIdx.y; ox < wc;
           ox += gridDim.x * blockDim.y) {
        const int x0 = 2 * ox;
        const bool has_x1 = x0 + 1 < w;
        const long long p00 = (n * h + y0) * w + x0;
        const long long pix[4] = {p00, p00 + 1, p00 + w, p00 + w + 1};
        const bool here[4] = {true, has_x1, has_y1, has_x1 && has_y1};
        uint4 g[4], o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (here[j]) {
            g[j] = dy[pix[j] * ldy + c];
            o[j] = out[pix[j] * ldo + c];
          }
        }
        if (has_x1 && has_y1) {
          const uint4 dp = dpool[((n * hp + oy) * wp + ox) * cv + c];
          int arg[8];
          argmax8(o, arg);
#pragma unroll
          for (int j = 0; j < 4; ++j) g[j] = add_at(g[j], dp, arg, j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (here[j]) dz[pix[j] * cv + c] = act_grad8<ACT>(g[j], o[j], acc);
      }
    }
    block_partial(acc, active, c, partials + blk * cv * 8);
  }
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

// The first output index (a row or a column) whose source index i0 may be
// `i` - 1, less a margin for rounding: outputs before it read only sources
// below i - 1.
__device__ __forceinline__ int first_reader(int i, int in, int outn) {
  const int d = (int)floorf((i - 0.5f) * ((float)outn / in) - 0.5f) - 2;
  return d < 0 ? 0 : d;
}

// Source i's weight in output dst's interpolation (tap t of dst): l0 where
// it is i0, l1 where it is i1 (both at the clamped last source).
__device__ __forceinline__ float weight_of(Tap t, int i) {
  return (t.i0 == i ? t.l0 : 0.f) + (t.i1 == i ? t.l1 : 0.f);
}

// The transpose of unet_upsample: g ([bs, ho, wo] pixels at a stride of
// `ldg` vectors, cv of them read) to dx ([bs, hi, wi, cv], dense). A thread
// writes one coarse pixel's channel vector: the float32 sum over the fine
// pixels that read it (rows and columns whose source index i0 is its index
// or the one before), each weighted by the product of its row and column
// weights, rounded once.
__global__ void __launch_bounds__(kThreads)
    unet_upsample_bwd(const uint4* __restrict__ g, long long ldg,
                      uint4* __restrict__ dx, int bs, int hi, int wi, int ho,
                      int wo, int cv) {
  const float rh = (float)hi / ho, rw = (float)wi / wo;
  for (long long row = blockIdx.y; row < (long long)bs * hi;
       row += gridDim.y) {
    const long long n = row / hi;
    const int iy = (int)(row - n * hi);
    const int oy0 = first_reader(iy, hi, ho);
    for (int ix = blockIdx.x * blockDim.y + threadIdx.y; ix < wi;
         ix += gridDim.x * blockDim.y) {
      const int ox0 = first_reader(ix, wi, wo);
      for (int c = threadIdx.x; c < cv; c += blockDim.x) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int oy = oy0; oy < ho; ++oy) {
          const Tap ty = tap(rh, oy, hi);
          if (ty.i0 > iy) break;
          if (ty.i1 < iy) continue;
          const float wy = weight_of(ty, iy);
          const uint4* grow = g + (n * ho + oy) * wo * ldg + c;
          for (int ox = ox0; ox < wo; ++ox) {
            const Tap tx = tap(rw, ox, wi);
            if (tx.i0 > ix) break;
            if (tx.i1 < ix) continue;
            const float wt = wy * weight_of(tx, ix);
            const uint4 v = grow[ox * ldg];
            const __nv_bfloat162* pv =
                reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f = __bfloat1622float2(pv[i]);
              acc[2 * i] += wt * f.x;
              acc[2 * i + 1] += wt * f.y;
            }
          }
        }
        uint4 o;
        __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          po[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
        dx[((n * hi + iy) * wi + ix) * cv + c] = o;
      }
    }
  }
}

}  // namespace

extern "C" {

// The epilogue of one convolution's output y ([bs, h, w, c] bf16, dense):
// out[p, :c] = act(bf16(y[p] + bias)) at a pixel stride of `ldo` channels
// (out may be y); with `pool` non-null also the 2x2 max-pool of the result
// into pool ([bs, h/2, w/2, c], dense). act: 0 linear, 1 ReLU, 2 leaky ReLU
// (slope 0.01). `sms`: the card's multiprocessors. Returns a CUDA error code.
int sbmc_unet_epilogue(const void* y, const void* bias, void* out,
                       long long ldo, void* pool, int act, int bs, int h,
                       int w, int c, int sms, void* stream) {
  if (c <= 0 || c % 8 != 0 || c / 8 > kMaxVecs || ldo % 8 != 0 || ldo < c ||
      act < 0 || act > 2 || bs <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* yv = static_cast<const uint4*>(y);
  const uint4* bv = static_cast<const uint4*>(bias);
  uint4* ov = static_cast<uint4*>(out);
  if (pool == nullptr) {
    const long long pixels = (long long)bs * h * w;
    long long blocks = (pixels + block.y * kUnroll - 1) / (block.y * kUnroll);
    const long long cap = (long long)sms * (2048 / kThreads);
    const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
    if (act == kRelu)
      unet_epilogue<kRelu><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8, pixels,
                                                 cv);
    else if (act == kLeaky)
      unet_epilogue<kLeaky><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8,
                                                  pixels, cv);
    else
      unet_epilogue<kLinear><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8,
                                                   pixels, cv);
  } else {
    const long long rows = (long long)bs * ((h + 1) / 2);
    const int wc = (w + 1) / 2;
    const dim3 grid((wc + block.y - 1) / block.y,
                    (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
    uint4* pv = static_cast<uint4*>(pool);
    if (act == kRelu)
      unet_epilogue_pool<kRelu><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8,
                                                      pv, bs, h, w, cv);
    else if (act == kLeaky)
      unet_epilogue_pool<kLeaky><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8,
                                                       pv, bs, h, w, cv);
    else
      unet_epilogue_pool<kLinear><<<grid, block, 0, s>>>(yv, bv, ov, ldo / 8,
                                                        pv, bs, h, w, cv);
  }
  return (int)cudaGetLastError();
}

// The bilinear upsample of x ([bs, hi, wi, c] bf16, dense) to (ho, wo),
// at least doubling each side, into out ([bs, ho, wo] pixels at a stride of
// `ldo` channels). Returns a CUDA error code.
int sbmc_unet_upsample(const void* x, void* out, long long ldo, int bs,
                       int hi, int wi, int ho, int wo, int c, void* stream) {
  if (c <= 0 || c % 8 != 0 || ldo % 8 != 0 || ldo < c || bs <= 0 ||
      hi <= 0 || wi <= 0 || 2 * hi > ho || 2 * wi > wo)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  const long long rows = (long long)bs * ((ho + 1) / 2);
  const int wb = (wo + 1) / 2;
  const dim3 grid((wb + block.y - 1) / block.y,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  unet_upsample<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), ldo / 8, bs,
      hi, wi, ho, wo, cv);
  return (int)cudaGetLastError();
}

// x [bs, c, h, w] NCHW to channels-last (to_nhwc 1), or back (0), bf16,
// both dense. Returns a CUDA error code.
int sbmc_unet_layout(const void* src, void* dst, int to_nhwc, int bs, int c,
                     int h, int w, int sms, void* stream) {
  if (c <= 0 || c % 8 != 0 || bs <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)h * w;
  const long long cap = (long long)sms * (2048 / kThreads);
  const int cv = c / 8;
  const uint4* a = static_cast<const uint4*>(src);
  uint4* b = static_cast<uint4*>(dst);
  if (to_nhwc && pixels % 16 == 0) {
    const dim3 block = block_of(cv);
    const long long blocks = (bs * (pixels / 16) + block.y - 1) / block.y;
    unet_layout_nhwc<<<(unsigned)(blocks < cap ? blocks : cap), block, 0,
                       s>>>(a, b, bs, pixels, cv);
  } else if (!to_nhwc && pixels % 8 == 0) {
    const long long blocks =
        bs * ((pixels / 8 + kNchwGroups - 1) / kNchwGroups) *
        ((cv + kNchwVecs - 1) / kNchwVecs);
    unet_layout_nchw<<<(unsigned)(blocks < cap ? blocks : cap),
                       dim3(kNchwGroups, kNchwVecs), 0, s>>>(a, b, bs,
                                                             pixels, cv);
  } else {
    const long long total = (long long)bs * c * pixels;
    const long long blocks = (total + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src);
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(dst);
    if (to_nhwc)
      unet_layout_any<true><<<grid, kThreads, 0, s>>>(x, y, pixels, c, total);
    else
      unet_layout_any<false><<<grid, kThreads, 0, s>>>(x, y, pixels, c,
                                                       total);
  }
  return (int)cudaGetLastError();
}

// The epilogue's backward for one convolution of c channels over [bs, h, w]
// pixels: dy (the gradient of the epilogue's output, at a pixel stride of
// `ldy` channels), out (the saved output, at `ldo`) and, with `dpool`
// non-null, the pool's gradient ([bs, h/2, w/2, c], dense) give dz ([bs, h,
// w, c], dense) and dbias ([c] float32, each a bf16 value). `partials`: a
// float32 workspace of `nparts` rows of c values (the grid has at most
// `nparts` blocks; sms * 8 is enough for the widest). Returns a CUDA error
// code.
int sbmc_unet_epilogue_backward(const void* dy, long long ldy,
                                const void* out, long long ldo,
                                const void* dpool, int act, void* dz,
                                void* partials, int nparts, void* dbias,
                                int bs, int h, int w, int c, int sms,
                                void* stream) {
  if (c <= 0 || c % 8 != 0 || ldy % 8 != 0 || ldy < c || ldo % 8 != 0 ||
      ldo < c || act < 0 || act > 2 || bs <= 0 || h <= 0 || w <= 0 ||
      nparts <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* gv = static_cast<const uint4*>(dy);
  const uint4* ov = static_cast<const uint4*>(out);
  uint4* zv = static_cast<uint4*>(dz);
  float* pv = static_cast<float*>(partials);
  long long cap = (long long)sms * kBlocksPerSm;
  if (cap > nparts) cap = nparts;
  int used;
  if (dpool == nullptr) {
    const long long pixels = (long long)bs * h * w;
    const long long blocks =
        (pixels + block.y * kUnroll - 1) / (block.y * kUnroll);
    used = (int)(blocks < cap ? blocks : cap);
    if (act == kRelu)
      unet_epilogue_bwd<kRelu><<<used, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, zv, pv, pixels, cv);
    else if (act == kLeaky)
      unet_epilogue_bwd<kLeaky><<<used, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, zv, pv, pixels, cv);
    else
      unet_epilogue_bwd<kLinear><<<used, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, zv, pv, pixels, cv);
  } else {
    const long long rows = (long long)bs * ((h + 1) / 2);
    const long long wblocks = ((w + 1) / 2 + block.y - 1) / block.y;
    const long long gx = wblocks < cap ? wblocks : cap;
    long long gy = cap / gx;
    gy = gy < rows ? gy : rows;
    gy = gy < kMaxGridY ? gy : kMaxGridY;
    const dim3 grid((unsigned)gx, (unsigned)gy);
    used = (int)(gx * gy);
    const uint4* dp = static_cast<const uint4*>(dpool);
    if (act == kRelu)
      unet_epilogue_pool_bwd<kRelu><<<grid, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, dp, zv, pv, bs, h, w, cv);
    else if (act == kLeaky)
      unet_epilogue_pool_bwd<kLeaky><<<grid, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, dp, zv, pv, bs, h, w, cv);
    else
      unet_epilogue_pool_bwd<kLinear><<<grid, block, 0, s>>>(
          gv, ldy / 8, ov, ldo / 8, dp, zv, pv, bs, h, w, cv);
  }
  unet_bias_sum<<<(c + 31) / 32, dim3(32, kSumRows), 0, s>>>(
      pv, used, c, static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

// The upsample's backward: g (the gradient of the upsampled slot, [bs, ho,
// wo] pixels at a stride of `ldg` channels, c of them read) to dx ([bs, hi,
// wi, c] bf16, dense), for an upsample that at least doubled each side.
// Returns a CUDA error code.
int sbmc_unet_upsample_backward(const void* g, long long ldg, void* dx,
                                int bs, int hi, int wi, int ho, int wo, int c,
                                void* stream) {
  if (c <= 0 || c % 8 != 0 || ldg % 8 != 0 || ldg < c || bs <= 0 ||
      hi <= 0 || wi <= 0 || 2 * hi > ho || 2 * wi > wo)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 8;
  const dim3 block = block_of(cv);
  const long long rows = (long long)bs * hi;
  const dim3 grid((wi + block.y - 1) / block.y,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  unet_upsample_bwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), ldg / 8, static_cast<uint4*>(dx), bs, hi,
      wi, ho, wo, cv);
  return (int)cudaGetLastError();
}

}  // extern "C"
