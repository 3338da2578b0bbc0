// The per-sample 1x1 chains of the SBMC model (models/multisteps.py) for
// Hopper (sm_90a), for inference: one embedding step over every sample of a
// batch (sample_embed), and the kernel regressor on one sample
// (sample_regress). Each is a ConvChain of depth 3 with ksize 1, a small
// MLP applied to every sample's channel vector.
//
// It replaces no Pallas kernel: on the TPU, XLA fused this chain (the cat
// with the step's extra features, three 1x1 convs, their bias and
// activation, the masked mean over samples, the logit clamp and cast). On
// the card the unfused chain spent most of its time outside its GEMMs: the
// 256-channel cat over every sample (half of it a copy of the pixel's
// extra features), layout transposes around each conv, separate bias,
// activation, clamp and cast passes, and a second read of the features for
// the mean.
//
// What bounds it on this card: bytes. A sample moves its 128 input and 128
// output bf16 channels (512 bytes) for 3 x 128 x 128 x 2 FLOPs, about 190
// FLOP/byte, below the H100's ~295 (989 TFLOP/s over 3.35 TB/s). So each
// byte is read and written once, nothing between the layers reaches device
// memory, and the MMAs, the roundings and the memory traffic overlap:
//
// - A warpgroup (4 warps) owns a group tile of 64 pixels, each warp 16 of
//   them (a warp tile), and runs the whole chain for them with wgmma
//   m64nNk16: A (bf16) in registers, B (the weights) in shared memory,
//   float32 sums. A layer's float32 result, rounded as the JAX package
//   rounds it (the product to bf16, then the bias added and rounded again,
//   then the activation, two outputs a conversion), is packed straight
//   into the next layer's A fragments (the accumulator's layout is the A
//   operand's): the hidden activations never leave registers. The hidden
//   width is held at 128 (narrower chains are zero-padded by the wrapper).
// - The block's two warpgroups take turns issuing their MMAs, so that one
//   group's MMAs run while the other rounds, stores and loads.
// - The weights are resident in shared memory, copied once a block by the
//   bulk-copy engine, laid out by the wrapper as the MMAs' descriptors read
//   them (blocks of 64 input channels, 128-byte rows, the 128-byte swizzle).
//   Blocks are persistent: one a multiprocessor.
// - The input planes are NCHW as they lie: a warp tile reads 32 contiguous
//   bytes of each channel plane with cp.async into the warp's stage
//   [channel][16 pixels] (the two 16-byte halves of a row swapped every 4
//   rows, against bank conflicts), and ldmatrix.trans makes the A
//   fragments. No 64-bit division runs per element or chunk.
// - Outputs leave through a staging tile [channel][64 pixels] a warpgroup
//   (stmatrix.trans from the accumulators, 128-byte swizzled rows): each
//   thread stores 16 bytes, a warp four 128-byte runs of four planes. In
//   step 0, where W_e takes no shared memory, the staging tiles are their
//   own and the next sample loads while a sample computes; in later steps
//   the warpgroup's four stages are its staging tile and the next sample
//   loads once the outputs have left.
// - The first layer's input is cat([feats, extra]). Its product is split as
//   W_f . feats + W_e . extra, and W_e . extra, which depends only on the
//   pixel, is computed once a warp tile in float32 (E, kept in shared
//   memory in the accumulator's own layout) and starts each sample's sum.
//   In step 0 the extra features are the batch's global features and E a
//   per-batch vector the wrapper computes. Rounding sees one float32 sum,
//   as with the cat: only the order of the terms differs.
// - The embedding's epilogue accumulates the masked mean over samples in
//   float32 in registers, written once a group tile in bf16 (the sum
//   rounded, then divided by the valid count and rounded, as the unfused
//   code rounds it).
// - The regressor's 441 (any number of) outputs are produced 64 at a time
//   from the register-held second activations, their weights streamed
//   through a two-slot ring of shared memory by the bulk-copy engine (the
//   whole prediction layer does not fit beside the first two). The ±3e4
//   logit clamp is folded into the epilogue and the logits are written
//   once, in bf16.
//
// Ragged tiles (any h*w, any batch, any sample count) load zeros past the
// plane's end and store nothing there; a warp past the last tile computes
// with its warpgroup and stores nothing. Planes that are not a multiple of
// 8 pixels load and store element by element. No atomics: every output
// element has one writer. The kernels have no backward: the wrapper refuses
// inputs or weights that require grad.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                // pixels of a warp tile
constexpr int kHid = 128;                // hidden width held by the kernel
constexpr int kHidTiles = kHid / 8;      // n-tiles of a hidden layer
constexpr int kChunk = 64;               // regressor outputs a ring slot
constexpr int kChunkTiles = kChunk / 8;  // n-tiles of a ring slot
constexpr int kRing = 2;                 // ring slots
constexpr int kMaxKx = 128;              // padded feature channels, embedding
constexpr int kMaxKe = 128;              // padded extra channels, embedding
constexpr int kMaxK0 = 256;              // padded input channels, regressor
constexpr int kSmemMax = 232448;         // a block's shared memory, sm_90
constexpr int kBulkPiece = 32768;        // bytes of one bulk copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// Waits for the phase of `bar` with this parity. A wait of more than 2^34
// cycles (about 10 s) can only be a lost transaction: it traps, which fails
// the launch, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk-copy
// engine, in pieces; completes transaction bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
    const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to registers an asynchronous
// wgmma reads or writes across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The shared-memory descriptor of a K-major bf16 operand with the 128-byte
// swizzle: 8-row groups of 128-byte rows 1024 bytes apart (the stride
// offset); the leading offset is unused in this mode. `saddr` is the
// shared address of the k-tile's first 32 bytes in an atom whose base is
// 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d = (scale_d ? d : 0) + a . B, one warpgroup: m64n128k16, A (bf16) in
// registers, B (bf16, K-major, 128-byte swizzle) by its descriptor, float32
// sums. Asynchronous: see wg_mma.
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// d = (scale_d ? d : 0) + a . B, one warpgroup: m64n64k16, A (bf16) in
// registers, B (bf16, K-major, 128-byte swizzle) by its descriptor, float32
// sums. Asynchronous: see wg_mma.
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// (lo, hi) rounded to the nearest bf16 and packed, lo in the low half: one
// conversion instruction for two values.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The halves of a packed pair, as floats (exact).
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Keeps the halves of `a` where `lo` / `hi` hold, those of `b` elsewhere.
__device__ __forceinline__ uint32_t select2(bool lo, bool hi, uint32_t a,
                                           uint32_t b) {
  const uint32_t m = (lo ? 0xffffu : 0u) | (hi ? 0xffff0000u : 0u);
  return (a & m) | (b & ~m);
}

// A layer's rounding, as WNConv2D in bf16 rounds it, on two neighbouring
// outputs: the product rounded to bf16, the bias added and rounded again.
__device__ __forceinline__ uint32_t biased(float a0, float a1, float2 b) {
  const uint32_t y = pack_rn(a0, a1);
  return pack_rn(lo_f(y) + b.x, hi_f(y) + b.y);
}

// The logit clamp on two bf16 logits: torch.clamp(-3e4, 3e4) of a bf16
// value rounds 3e4 back to 29952, and every bf16 value above 29952 is above
// 3e4, so it is a clamp to ±29952 in bf16; NaN stays NaN.
__device__ __forceinline__ float clamp1(float v) {
  return v != v ? v : fminf(fmaxf(v, -29952.f), 29952.f);
}

__device__ __forceinline__ uint32_t clamp2(uint32_t z) {
  return (__float_as_uint(clamp1(lo_f(z))) >> 16) |
         (__float_as_uint(clamp1(hi_f(z))) & 0xffff0000u);
}

// A hidden layer: biased, then ReLU (clamp_min(0): NaN and -0 kept) or leaky
// ReLU (x > 0 ? x : x * 0.01 in float32, rounded).
template <bool kLeaky>
__device__ __forceinline__ uint32_t hidden2(float a0, float a1, float2 b) {
  const uint32_t z = biased(a0, a1, b);
  const float z0 = lo_f(z), z1 = hi_f(z);
  if (kLeaky) return select2(z0 > 0.f, z1 > 0.f, z,
                             pack_rn(z0 * 0.01f, z1 * 0.01f));
  return select2(!(z0 < 0.f), !(z1 < 0.f), z, 0u);
}

// The lane's constant parts of the fragment layouts.
struct Lanes {
  int g, t;        // the accumulator's row group and column pair
  uint32_t a_off;  // A (ldmatrix.trans) offset in a stage k-tile
  __device__ explicit Lanes(int lane) {
    g = lane >> 2;
    t = lane & 3;
    const int r = lane & 7, jm = lane >> 3;
    a_off = static_cast<uint32_t>((r + 8 * (jm >> 1)) * 32 +
                                  (((jm & 1) ^ ((r >> 2) & 1)) << 4));
  }
};

// Shared address of k-tile kt of a weight matrix of `rows` rows laid out by
// the wrapper: blocks of 64 k (one 128-byte swizzle atom wide) of `rows`
// rows each, one after the other.
__device__ __forceinline__ uint32_t ktile_addr(uint32_t w, int rows, int kt) {
  return w + (kt >> 2) * rows * 128 + (kt & 3) * 32;
}

template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT][4],
                                      const uint32_t (&a)[4], uint32_t w,
                                      int kt, int scale_d) {
  const uint64_t desc = desc_sw128(ktile_addr(w, NT * 8, kt));
  if constexpr (NT == 16)
    wgmma_n128(d, a, desc, scale_d);
  else
    wgmma_n64(d, a, desc, scale_d);
}

// The block's two warpgroups take turns on the tensor cores (named
// barriers 3 and 4): a warpgroup issues a layer's MMAs only in its turn and
// passes the turn when they are done, so that one group's MMAs run while
// the other rounds, stores and loads. Warpgroup 1 gives warpgroup 0 the
// first turn; both run the same number of layers, and warpgroup 0 takes
// the last pass at the end.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
}

// acc = (scale ? acc : 0) + A . W^T for the warpgroup's 64 rows (this
// warp's 16), A in registers, over the first `ktiles` of KT k-tiles. The
// MMAs are issued in the warpgroup's turn, which passes as soon as they
// are committed (the other group's MMAs queue behind them), then waited
// for.
template <int NT, int KT>
__device__ __forceinline__ void wg_mma(float (&acc)[NT][4],
                                       uint32_t (&a)[KT][4], uint32_t w,
                                       int scale, int wg, int ktiles = KT) {
  fence_regs(acc);
  fence_regs(a);
  turn_wait(wg);
  wg_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    if (kt < ktiles) wgmma(acc, a[kt], w, kt, kt > 0 ? 1 : scale);
  wg_commit();
  turn_pass(wg);
  wg_wait_all();
  fence_regs(acc);
  fence_regs(a);
}

// The A fragments of the first `ktiles` (of at most KT) k-tiles of a stage
// ([channel][16 pixels], halves swapped every 4 rows), by ldmatrix.trans.
template <int KT>
__device__ __forceinline__ void stage_frags(uint32_t (&a)[KT][4],
                                            uint32_t stage, int ktiles,
                                            const Lanes& ln) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < ktiles)
      ldsm_x4_trans(a[kt], stage + kt * 512 + ln.a_off);
    else
      a[kt][0] = a[kt][1] = a[kt][2] = a[kt][3] = 0u;
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// A hidden layer's accumulators, rounded and activated, as the next
// layer's A fragments: n-tiles 2kt and 2kt+1 are k-tile kt.
template <bool kLeaky>
__device__ __forceinline__ void to_a(const float (&acc)[kHidTiles][4],
                                     const float* bias, const Lanes& ln,
                                     uint32_t (&a)[kHid / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kHidTiles; ++nt) {
    const float2 b =
        *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * ln.t);
    a[nt >> 1][(nt & 1) * 2] = hidden2<kLeaky>(acc[nt][0], acc[nt][1], b);
    a[nt >> 1][(nt & 1) * 2 + 1] = hidden2<kLeaky>(acc[nt][2], acc[nt][3], b);
  }
}

// Rows [row0, row0 + c) of a stage <- channels [0, c) of `src` (planes of
// `hw` pixels), pixels [p0, p0 + 16), zero past the plane's end; then rows
// [row0 + c, zero_to) zero. One commit group is the caller's.
__device__ __forceinline__ void load_rows(uint32_t stage, int row0,
                                          const uint16_t* src, int c,
                                          long long hw, long long p0,
                                          int zero_to, int lane) {
  for (int i = lane; i < 2 * c; i += 32) {
    const int row = row0 + (i >> 1);
    const int half = i & 1;
    const uint32_t dst =
        stage + row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
    const long long px = p0 + 8 * half;
    const uint16_t* gp = src + static_cast<long long>(i >> 1) * hw + px;
    if (px + 8 <= hw && (reinterpret_cast<uintptr_t>(gp) & 15) == 0) {
      cp_async16(dst, gp);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = px + 2 * e < hw ? gp[2 * e] : 0;
        const uint32_t hi = px + 2 * e + 1 < hw ? gp[2 * e + 1] : 0;
        v[e] = lo | (hi << 16);
      }
      st_shared16(dst, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
  for (int i = lane; i < 2 * (zero_to - row0 - c); i += 32) {
    const int row = row0 + c + (i >> 1);
    st_shared16(stage + row * 32 + (((i & 1) ^ ((row >> 2) & 1)) << 4),
                make_uint4(0, 0, 0, 0));
  }
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0,
                                              uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Synchronises the four warps of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Outputs leave through a warpgroup's staging tile in shared memory:
// [channel][64 pixels] bf16, 128-byte rows, the warp tile of quarter q in
// 16-byte chunks 2q and 2q + 1, each chunk c of row r at c ^ (r & 7) (no
// bank conflicts on either side). Each warp writes its accumulators'
// n-tiles 2i and 2i + 1 (packed bf16 pairs: `lo` at pixel g, `hi` at g + 8)
// with one stmatrix.trans, which turns them into pixel-contiguous rows.
__device__ __forceinline__ void stage_out(uint32_t staging, int nt, int quarter,
                                          int lane, uint32_t lo0,
                                          uint32_t hi0, uint32_t lo1,
                                          uint32_t hi1) {
  const int j = lane >> 3, i = lane & 7;
  const int row = 8 * (nt + (j >> 1)) + i;
  const int chunk = 2 * quarter + (j & 1);
  stsm_x4_trans(staging + row * 128 + ((chunk ^ i) << 4), lo0, hi0, lo1, hi1);
}

// Where a thread's 16-byte chunk of a staging tile goes: thread tg of the
// warpgroup always takes chunk c = tg % 8 of rows tg / 8 + 16 k, which
// belongs to the group's warp tile gt * 4 + c / 2: batch item b, pixels
// px .. px + n - 1 (n = 0: no tile or past the plane's end). Computed once
// a group tile, so that the stores divide nothing.
struct OutChunk {
  long long b, px;
  int n;
};

__device__ __forceinline__ OutChunk out_chunk(long long gt, int tg,
                                              long long tpb, long long total,
                                              long long hw) {
  OutChunk o{0, 0, 0};
  const int c = tg & 7;
  const long long wt = gt * 4 + (c >> 1);
  if (wt < total) {
    o.b = wt / tpb;
    o.px = (wt - o.b * tpb) * kRows + 8 * (c & 1);
    const long long left = hw - o.px;
    o.n = left <= 0 ? 0 : (left < 8 ? static_cast<int>(left) : 8);
  }
  return o;
}

// Writes rows [0, rows) of a warpgroup's staging tile as channels ch0 + row
// (those below cout) of the planes at `base` (batch item stride `item`),
// 16 bytes a thread where the chunk is whole and aligned: a warp writes
// four 128-byte runs. Other chunks are written element by element.
__device__ __forceinline__ void store_staged(uint32_t staging, int rows,
                                             int ch0, int cout,
                                             uint16_t* base, long long item,
                                             long long hw, const OutChunk& o,
                                             int tg) {
  if (o.n == 0) return;
  const int c = tg & 7;
  uint16_t* p = base + o.b * item + o.px;
  for (int row = tg >> 3; row < rows && ch0 + row < cout; row += 16) {
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(staging + row * 128 + ((c ^ (row & 7)) << 4)));
    uint16_t* dst = p + static_cast<long long>(ch0 + row) * hw;
    if (o.n == 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < o.n)
          dst[e] = static_cast<uint16_t>(w4[e >> 1] >> (16 * (e & 1)));
    }
  }
}

struct EmbedArgs {
  const uint16_t* x;  // features: (b, s, c) plane at b*x_bs + s*x_ss + c*hw
  long long x_bs, x_ss;
  int cx, kx;          // feature channels; padded (a multiple of 64)
  const uint16_t* e;   // extra [bs, ce, hw], or null
  int ce, ke;          // extra channels; padded (0 without e)
  const float* ebias;  // [bs, kHid] float32 without e: W_e . global
  const void* wx;      // [kHid x kx] bf16, laid out for wgmma
  const void* we;      // [kHid x ke]
  const void* w1;      // [kHid x kHid]
  const void* w2;      // [kHid x kHid]
  const uint16_t* bias;  // [3][kHid] bf16
  const float* mask;     // [bs, spp] 0 or 1
  const float* nvalid;   // [bs]
  uint16_t* out;         // [bs, spp, cout, hw]
  uint16_t* reduced;     // [bs, cout, hw]
  int cout, bs, spp;
  long long hw;
};

// The blocks' shared memory is laid out from the first 1024-byte boundary
// of the dynamic allocation (the swizzle atoms of the weights need it), so
// each kernel asks for kAlign bytes more than its layout.
constexpr int kAlign = 1024;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// A warp's stage holds its input planes; the warpgroup's four stages are
// also its staging tile for outputs ([kHid][64 pixels]).
__host__ __device__ inline int embed_stage_rows(int kx, int ke) {
  const int k = kx > ke ? kx : ke;
  return k > kHid ? k : kHid;
}

// Weights, then E, the stages, the staging tiles of step 0 (where W_e
// takes no room, outputs leave through tiles of their own, and the next
// sample loads while a sample computes), the biases and the barrier.
__host__ __device__ inline int embed_smem(int kx, int ke) {
  return kAlign + kHid * (kx + ke + 2 * kHid) * 2 +
         kWarps * kHidTiles * 32 * 16 +
         kWarps * embed_stage_rows(kx, ke) * 32 +
         (ke == 0 ? 2 * kHid * 128 : 0) + 3 * kHid * 4 + 16;
}

// One embedding step. kPixE: the extra features are per pixel (steps >= 1);
// else E is the per-batch ebias (step 0). The block's two warpgroups each
// own a group tile of 64 pixels, four warp tiles, and step through their
// samples together.
template <bool kPixE>
__global__ void __launch_bounds__(kThreads, 1)
    sample_embed(const EmbedArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = aligned_smem(smem_raw);
  const int ks = embed_stage_rows(a.kx, a.ke);
  unsigned char* wx = p;
  p += kHid * a.kx * 2;
  unsigned char* we = p;
  p += kHid * a.ke * 2;
  unsigned char* w1 = p;
  p += kHid * kHid * 2;
  unsigned char* w2 = p;
  p += kHid * kHid * 2;
  float4* e_all = reinterpret_cast<float4*>(p);
  p += kWarps * kHidTiles * 32 * 16;
  unsigned char* stage_all = p;
  p += kWarps * ks * 32;
  // Step 0 has room for staging tiles apart from the stages; later steps
  // stage their outputs in the warpgroup's four stages.
  constexpr bool kOwnStaging = !kPixE;
  unsigned char* staging_all = kOwnStaging ? p : stage_all;
  if (kOwnStaging) p += 2 * kHid * 128;
  float* bias = reinterpret_cast<float*>(p);
  p += 3 * kHid * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(p);

  // The warp index from lane 0, so that the compiler knows it is the same
  // across the warp (the warpgroup MMAs are issued in uniform code).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const Lanes ln(lane);
  const int wg = warp >> 2, tg = threadIdx.x & 127;
  const uint32_t stage = smem_u32(stage_all + warp * ks * 32);
  const uint32_t staging = smem_u32(
      staging_all + wg * (kOwnStaging ? kHid * 128 : 4 * ks * 32));
  float4* ew = e_all + warp * kHidTiles * 32;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kHid * (a.kx + a.ke + 2 * kHid) * 2);
    bulk_copy(wx, a.wx, kHid * a.kx * 2, bar);
    if (kPixE) bulk_copy(we, a.we, kHid * a.ke * 2, bar);
    bulk_copy(w1, a.w1, kHid * kHid * 2, bar);
    bulk_copy(w2, a.w2, kHid * kHid * 2, bar);
  }
  for (int i = threadIdx.x; i < 3 * kHid; i += kThreads)
    bias[i] = lo_f(a.bias[i]);
  for (int i = threadIdx.x; i < kWarps * ks * 2; i += kThreads)
    st_shared16(smem_u32(stage_all) + i * 16, make_uint4(0, 0, 0, 0));
  __syncthreads();
  mbar_wait(bar, 0);

  const long long tpb = (a.hw + kRows - 1) / kRows;  // warp tiles an item
  const long long total = tpb * a.bs;
  const long long groups = (total + 3) / 4;           // group tiles
  const long long gstride = static_cast<long long>(gridDim.x) * 2;
  const int quarter = warp & 3;
  const uint32_t wx_s = smem_u32(wx), we_s = smem_u32(we);
  const uint32_t w1_s = smem_u32(w1), w2_s = smem_u32(w2);

  // Item k of the warp tile at batch item b, pixel p0 into the stage: the
  // extra features (k < 0) or sample k's features, their padding rows
  // zeroed (the staging tile has been there).
  auto load = [&](long long b, long long p0, int k) {
    if (k < 0)
      load_rows(stage, 0, a.e + b * a.ce * a.hw, a.ce, a.hw, p0, a.ke, lane);
    else
      load_rows(stage, 0, a.x + b * a.x_bs + k * a.x_ss, a.cx, a.hw, p0,
                a.kx, lane);
    cp_async_commit();
  };
  constexpr int kFirst = kPixE ? -1 : 0;

  // Both warpgroups run warpgroup 0's number of group tiles; a warp past
  // the last warp tile computes on its stale stage with the others (the
  // warpgroup's instructions need all four, the turns both groups) and
  // stores nothing.
  const long long first = static_cast<long long>(blockIdx.x) * 2;
  const long long iters =
      groups > first ? (groups - 1 - first) / gstride + 1 : 0;
  long long wt = (first + wg) * 4 + quarter;
  long long b = wt < total ? wt / tpb : 0;
  long long p0 = (wt - b * tpb) * kRows;
  if (first + wg < groups && wt < total) load(b, p0, kFirst);
  if (wg == 1) turn_pass(1);
  for (long long it = 0; it < iters; ++it) {
    const long long gt = first + wg + it * gstride;
    const bool valid = wt < total;
    const OutChunk oc = out_chunk(gt, tg, tpb, total, a.hw);
    const long long next = (gt + gstride) * 4 + quarter;
    const long long nb = next < total ? next / tpb : 0;
    const long long np0 = (next - nb * tpb) * kRows;
    float acc[kHidTiles][4];
    if (kPixE) {
      cp_async_wait_all();
      __syncwarp();
      {
        uint32_t fe[kMaxKe / 16][4];
        stage_frags(fe, stage, (a.ce + 15) / 16, ln);
        wg_mma(acc, fe, we_s, 0, wg, (a.ce + 15) / 16);
      }
      __syncwarp();
      if (valid) load(b, p0, 0);
#pragma unroll
      for (int nt = 0; nt < kHidTiles; ++nt)
        ew[nt * 32 + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    } else {
      const float* eb = a.ebias + b * kHid;
#pragma unroll
      for (int nt = 0; nt < kHidTiles; ++nt) {
        const float2 v =
            *reinterpret_cast<const float2*>(eb + nt * 8 + 2 * ln.t);
        ew[nt * 32 + lane] = make_float4(v.x, v.y, v.x, v.y);
      }
    }
    float red[kHidTiles][4];
    zero(red);
    for (int s = 0; s < a.spp; ++s) {
      const float m = a.mask[b * a.spp + s];
#pragma unroll
      for (int nt = 0; nt < kHidTiles; ++nt) {
        const float4 v = ew[nt * 32 + lane];
        acc[nt][0] = v.x;
        acc[nt][1] = v.y;
        acc[nt][2] = v.z;
        acc[nt][3] = v.w;
      }
      cp_async_wait_all();
      __syncwarp();
      {
        uint32_t fx[kMaxKx / 16][4];
        stage_frags(fx, stage, (a.cx + 15) / 16, ln);
        if (kOwnStaging) {
          // The stage is free: the next item loads during this sample.
          __syncwarp();
          if (s + 1 < a.spp) {
            if (valid) load(b, p0, s + 1);
          } else if (next < total) {
            load(nb, np0, kFirst);
          }
        }
        wg_mma(acc, fx, wx_s, 1, wg, (a.cx + 15) / 16);
      }
      uint32_t fa[kHid / 16][4];
      to_a<false>(acc, bias, ln, fa);
      wg_mma(acc, fa, w1_s, 0, wg);
      to_a<false>(acc, bias + kHid, ln, fa);
      wg_mma(acc, fa, w2_s, 0, wg);
      // Every warp of the group is past its first layer (the group's MMAs
      // need all four): the stages are free for the staging tile.
      wg_barrier(wg);
#pragma unroll
      for (int nt = 0; nt < kHidTiles; nt += 2) {
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 bb = *reinterpret_cast<const float2*>(
              bias + 2 * kHid + (nt + u) * 8 + 2 * ln.t);
          lo[u] = biased(acc[nt + u][0], acc[nt + u][1], bb);
          hi[u] = biased(acc[nt + u][2], acc[nt + u][3], bb);
          red[nt + u][0] += m * lo_f(lo[u]);
          red[nt + u][1] += m * hi_f(lo[u]);
          red[nt + u][2] += m * lo_f(hi[u]);
          red[nt + u][3] += m * hi_f(hi[u]);
        }
        stage_out(staging, nt, quarter, lane, lo[0], hi[0], lo[1], hi[1]);
      }
      wg_barrier(wg);
      store_staged(staging, kHid, 0, a.cout, a.out + s * a.cout * a.hw,
                   a.spp * a.cout * a.hw, a.hw, oc, tg);
      wg_barrier(wg);
      if (!kOwnStaging && s + 1 < a.spp && valid) load(b, p0, s + 1);
    }
    {
      const float nv = a.nvalid[b];
#pragma unroll
      for (int nt = 0; nt < kHidTiles; nt += 2) {
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // The sum rounded to bf16, then divided by the count and rounded.
          const uint32_t l = pack_rn(red[nt + u][0], red[nt + u][1]);
          const uint32_t h = pack_rn(red[nt + u][2], red[nt + u][3]);
          lo[u] = pack_rn(lo_f(l) / nv, hi_f(l) / nv);
          hi[u] = pack_rn(lo_f(h) / nv, hi_f(h) / nv);
        }
        stage_out(staging, nt, quarter, lane, lo[0], hi[0], lo[1], hi[1]);
      }
      wg_barrier(wg);
      store_staged(staging, kHid, 0, a.cout, a.reduced, a.cout * a.hw, a.hw,
                   oc, tg);
      wg_barrier(wg);
      if (!kOwnStaging && next < total) load(nb, np0, kFirst);
    }
    wt = next;
    b = nb;
    p0 = np0;
  }
  if (wg == 0) turn_wait(0);
  cp_async_wait_all();
}

struct RegressArgs {
  const uint16_t* x;  // one sample's features: (b, c) plane at b*x_bs + c*hw
  long long x_bs;
  int cx;
  const uint16_t* e;  // propagated [bs, ce, hw]
  int ce, k0;         // extra channels; cx + ce padded (a multiple of 64)
  const void* w0;     // [kHid x k0] bf16, laid out for wgmma
  const void* w1;     // [kHid x kHid]
  const void* w2;     // nchunks blocks of [kChunk x kHid]
  const uint16_t* bias;  // [2 * kHid + nchunks * kChunk] bf16
  uint16_t* out;         // [bs, nout, hw]
  int nout, nchunks, bs;
  long long hw;
};

// Weights, the ring, the stages, the two warpgroups' staging tiles
// ([kChunk][64 pixels]), the biases and the barriers.
__host__ __device__ inline int regress_smem(int k0, int nchunks) {
  return kAlign + kHid * (k0 + kHid) * 2 + kRing * kChunk * kHid * 2 +
         kWarps * k0 * 32 + 2 * kChunk * 128 +
         (2 * kHid + nchunks * kChunk) * 4 + 8 * (1 + 2 * kRing);
}

__global__ void __launch_bounds__(kThreads, 1)
    sample_regress(const RegressArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr uint32_t kSlot = kChunk * kHid * 2;
  unsigned char* p = aligned_smem(smem_raw);
  unsigned char* w0 = p;
  p += kHid * a.k0 * 2;
  unsigned char* w1 = p;
  p += kHid * kHid * 2;
  unsigned char* ring = p;
  p += kRing * kSlot;
  unsigned char* stage_all = p;
  p += kWarps * a.k0 * 32;
  unsigned char* staging_all = p;
  p += 2 * kChunk * 128;
  float* bias = reinterpret_cast<float*>(p);
  p += (2 * kHid + a.nchunks * kChunk) * 4;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(p);
  uint64_t* full = wbar + 1;       // a ring slot's chunk has landed
  uint64_t* empty = full + kRing;  // every warp is done with a slot

  // The warp index from lane 0, so that the compiler knows it is the same
  // across the warp (the warpgroup MMAs are issued in uniform code).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const Lanes ln(lane);
  const int wg = warp >> 2, quarter = warp & 3, tg = threadIdx.x & 127;
  const uint32_t stage = smem_u32(stage_all + warp * a.k0 * 32);
  const uint32_t staging = smem_u32(staging_all + wg * kChunk * 128);

  const long long tpb = (a.hw + kRows - 1) / kRows;
  const long long total = tpb * a.bs;
  const long long tiles = (total + kWarps - 1) / kWarps;  // block tiles
  const long long iters =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long nq = iters * a.nchunks;  // ring slots this block fills
  const unsigned char* w2 = static_cast<const unsigned char*>(a.w2);

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, kHid * (a.k0 + kHid) * 2);
    bulk_copy(w0, a.w0, kHid * a.k0 * 2, wbar);
    bulk_copy(w1, a.w1, kHid * kHid * 2, wbar);
    for (long long q = 0; q < kRing && q < nq; ++q) {
      mbar_expect_tx(&full[q], kSlot);
      bulk_copy(ring + q * kSlot, w2 + (q % a.nchunks) * kSlot, kSlot,
                &full[q]);
    }
  }
  for (int i = threadIdx.x; i < 2 * kHid + a.nchunks * kChunk; i += kThreads)
    bias[i] = lo_f(a.bias[i]);
  for (int i = threadIdx.x; i < kWarps * a.k0 * 2; i += kThreads)
    st_shared16(smem_u32(stage_all) + i * 16, make_uint4(0, 0, 0, 0));
  __syncthreads();
  mbar_wait(wbar, 0);

  const uint32_t w0_s = smem_u32(w0), w1_s = smem_u32(w1);
  const float* bias2 = bias + 2 * kHid;
  // The warp tile at batch item b, pixel p0 into the stage.
  auto load = [&](long long b, long long p0) {
    load_rows(stage, 0, a.x + b * a.x_bs, a.cx, a.hw, p0, a.cx, lane);
    load_rows(stage, a.cx, a.e + b * a.ce * a.hw, a.ce, a.hw, p0,
              a.cx + a.ce, lane);
    cp_async_commit();
  };

  {
    const long long wt0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (iters > 0 && wt0 < total) {
      const long long b0 = wt0 / tpb;
      load(b0, (wt0 - b0 * tpb) * kRows);
    }
  }
  if (wg == 1) turn_pass(1);
  for (long long it = 0; it < iters; ++it) {
    // A warp past the last warp tile computes on its stale stage with the
    // others and stores nothing.
    const long long bt = blockIdx.x + it * gridDim.x;
    const long long gt = bt * 2 + wg;  // the warpgroup's group tile
    const OutChunk oc = out_chunk(gt, tg, tpb, total, a.hw);
    uint32_t fa[kHid / 16][4];
    {
      float acc[kHidTiles][4];
      cp_async_wait_all();
      __syncwarp();
      {
        uint32_t f0[kMaxK0 / 16][4];
        stage_frags(f0, stage, (a.cx + a.ce + 15) / 16, ln);
        __syncwarp();
        const long long next = (bt + gridDim.x) * kWarps + warp;
        if (it + 1 < iters && next < total) {
          const long long nb = next / tpb;
          load(nb, (next - nb * tpb) * kRows);
        }
        wg_mma(acc, f0, w0_s, 0, wg, (a.cx + a.ce + 15) / 16);
      }
      to_a<true>(acc, bias, ln, fa);
      wg_mma(acc, fa, w1_s, 0, wg);
      to_a<true>(acc, bias + kHid, ln, fa);
    }
    for (int c = 0; c < a.nchunks; ++c) {
      const long long q = it * a.nchunks + c;
      const int slot = static_cast<int>(q % kRing);
      float acc[kChunkTiles][4];
      mbar_wait(&full[slot], static_cast<uint32_t>((q / kRing) & 1));
      wg_mma(acc, fa, smem_u32(ring + slot * kSlot), 0, wg);
      if (lane == 0) mbar_arrive(&empty[slot]);
      // Chunk q - 1's slot takes chunk q + 1 once every warp is done with
      // it (warpgroup 1 went through it before warpgroup 0's turn on chunk
      // q, so this rarely waits).
      if (threadIdx.x == 0 && q >= 1 && q + 1 < nq) {
        const int free_slot = static_cast<int>((q - 1) % kRing);
        mbar_wait(&empty[free_slot],
                  static_cast<uint32_t>(((q - 1) / kRing) & 1));
        mbar_expect_tx(&full[free_slot], kSlot);
        bulk_copy(ring + free_slot * kSlot,
                  w2 + ((q + 1) % a.nchunks) * kSlot, kSlot,
                  &full[free_slot]);
      }
#pragma unroll
      for (int nt = 0; nt < kChunkTiles; nt += 2) {
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 bb = *reinterpret_cast<const float2*>(
              bias2 + c * kChunk + (nt + u) * 8 + 2 * ln.t);
          lo[u] = clamp2(biased(acc[nt + u][0], acc[nt + u][1], bb));
          hi[u] = clamp2(biased(acc[nt + u][2], acc[nt + u][3], bb));
        }
        stage_out(staging, nt, quarter, lane, lo[0], hi[0], lo[1], hi[1]);
      }
      wg_barrier(wg);
      store_staged(staging, kChunk, c * kChunk, a.nout, a.out,
                   a.nout * a.hw, a.hw, oc, tg);
      // The staging tile is free again.
      wg_barrier(wg);
    }
  }
  if (wg == 0) turn_wait(0);
  cp_async_wait_all();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The shapes each kernel holds, on padded channel counts (kx, ke, k0: a
// multiple of 64; ke 0 for a per-batch E). The launches check them, and
// the wrapper asks through the *_fits exports before it lays out weights.
bool embed_holds(int kx, int ke, int cout) {
  return kx >= 64 && kx % 64 == 0 && kx <= kMaxKx && ke >= 0 && ke % 64 == 0 &&
         ke <= kMaxKe && cout >= 1 && cout <= kHid &&
         embed_smem(kx, ke) <= kSmemMax;
}

bool regress_holds(int k0, int nout) {
  return k0 >= 64 && k0 % 64 == 0 && k0 <= kMaxK0 && nout >= 1 &&
         regress_smem(k0, (nout + kChunk - 1) / kChunk) <= kSmemMax;
}

int pad64(int n) { return (n + 63) / 64 * 64; }

}  // namespace

// Whether a chain fits, with its channel counts as the chain has them:
// an embedding step on cx feature channels and ce extra channels a pixel
// (0: the extra features are a vector a batch item), the regressor on k_in
// input channels; hidden width and outputs at most kHid (the regressor's
// outputs any number that fits shared memory).
extern "C" int sbmc_sample_embed_fits(int cx, int ce, int hidden, int cout) {
  return cx >= 1 && ce >= 0 && hidden >= 1 && hidden <= kHid &&
         embed_holds(pad64(cx), pad64(ce), cout);
}

extern "C" int sbmc_sample_regress_fits(int k_in, int hidden, int nout) {
  return k_in >= 2 && hidden >= 1 && hidden <= kHid &&
         regress_holds(pad64(k_in), nout);
}

extern "C" int sbmc_sample_embed(
    const void* x, long long x_bs, long long x_ss, int cx, int kx,
    const void* e, int ce, int ke, const float* ebias, const void* wx,
    const void* we, const void* w1, const void* w2, const void* bias,
    const float* mask, const float* nvalid, void* out, void* reduced,
    int cout, int bs, int spp, long long hw, int grid, void* stream) {
  const bool pix = e != nullptr;
  if (!embed_holds(kx, ke, cout) || cx < 1 || cx > kx || bs < 1 || spp < 1 ||
      hw < 1 || grid < 1 || !aligned16(wx) || !aligned16(w1) ||
      !aligned16(w2) ||
      (pix ? (ke < 64 || ce < 1 || ce > ke || !aligned16(we))
           : (ke != 0 || ebias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = embed_smem(kx, ke);
  EmbedArgs a;
  a.x = static_cast<const uint16_t*>(x);
  a.x_bs = x_bs;
  a.x_ss = x_ss;
  a.cx = cx;
  a.kx = kx;
  a.e = static_cast<const uint16_t*>(e);
  a.ce = pix ? ce : 0;
  a.ke = ke;
  a.ebias = ebias;
  a.wx = wx;
  a.we = we;
  a.w1 = w1;
  a.w2 = w2;
  a.bias = static_cast<const uint16_t*>(bias);
  a.mask = mask;
  a.nvalid = nvalid;
  a.out = static_cast<uint16_t*>(out);
  a.reduced = static_cast<uint16_t*>(reduced);
  a.cout = cout;
  a.bs = bs;
  a.spp = spp;
  a.hw = hw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = pix ? sample_embed<true> : sample_embed<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbmc_sample_regress(const void* x, long long x_bs, int cx,
                                   const void* e, int ce, int k0,
                                   const void* w0, const void* w1,
                                   const void* w2, const void* bias,
                                   void* out, int nout, int bs, long long hw,
                                   int grid, void* stream) {
  const int nchunks = (nout + kChunk - 1) / kChunk;
  if (!regress_holds(k0, nout) || cx < 1 || ce < 1 || cx + ce > k0 || bs < 1 ||
      hw < 1 || grid < 1 || !aligned16(w0) || !aligned16(w1) ||
      !aligned16(w2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = regress_smem(k0, nchunks);
  RegressArgs a;
  a.x = static_cast<const uint16_t*>(x);
  a.x_bs = x_bs;
  a.cx = cx;
  a.e = static_cast<const uint16_t*>(e);
  a.ce = ce;
  a.k0 = k0;
  a.w0 = w0;
  a.w1 = w1;
  a.w2 = w2;
  a.bias = static_cast<const uint16_t*>(bias);
  a.out = static_cast<uint16_t*>(out);
  a.nout = nout;
  a.nchunks = nchunks;
  a.bs = bs;
  a.hw = hw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaFuncSetAttribute(
      sample_regress, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_regress<<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
