// Host build of the fused progressive splat step: the generic kernel's
// per-pixel function, and the tiled kernel's box reads, row update and
// state merge (progressive_splat.cuh), run in plain loops, the tiled one
// tile by tile with its TMA boxes emulated. It exists so the CPU tests can
// check both kernels' index math and online softmax against the plain
// PyTorch version without a GPU:
//
//   g++ -O2 -shared -fPIC -o libpsf_host.so progressive_splat_host.cpp

#include "progressive_splat.cuh"

namespace {

template <int C, typename T>
void run(const float* data, const T* logits, const float* sum_r,
         const float* sum_w, const float* max_w, float* out_r, float* out_w,
         float* out_m, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psf_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                        sum_r + n * C * hw, sum_w + n * hw, max_w + n * hw,
                        out_r + n * C * hw, out_w + n * hw, out_m + n * hw, h,
                        w, k, y, x);
}

template <int C>
void run_c(const float* data, const void* logits, int logits_bf16,
           const float* sum_r, const float* sum_w, const float* max_w,
           float* out_r, float* out_w, float* out_m, int bs, int h, int w,
           int k) {
  if (logits_bf16)
    run<C>(data, static_cast<const uint16_t*>(logits), sum_r, sum_w, max_w,
           out_r, out_w, out_m, bs, h, w, k);
  else
    run<C>(data, static_cast<const float*>(logits), sum_r, sum_w, max_w, out_r,
           out_w, out_m, bs, h, w, k);
}

// The data at the source pixels of one tap row, read from the planes: the
// host's stand-in for the tiled kernel's halo in shared memory.
template <int C>
struct PlaneRow {
  const float* data;
  int64_t hw;
  int h, w, sy, x, o;
  void get(int dx, float (&d)[C]) const {
    const int sx = x + dx - o;
    const bool in = sy >= 0 && sy < h && sx >= 0 && sx < w;
    for (int c = 0; c < C; ++c)
      d[c] = in ? data[c * hw + static_cast<int64_t>(sy) * w + sx] : 0.f;
  }
};

// One tile of TH rows x 32 pixels of one batch item as psf_tma assembles
// it: per tap row, each tap's TMA box emulated (TH x kBoxW logits from the
// kernel's clamped, aligned start, zero past the image's right and bottom
// edges) and read where the kernel's consumers read it (an interior tile at
// a constant column offset per tap, an edge tile shifted and masked); the
// row update of each pixel in order of dy; then the old state merged with
// the new taps. Returns 1 if a read falls outside its box.
template <int C, int K, typename T>
int run_tile(const float* data, const T* logits, const float* sum_r,
             const float* sum_w, const float* max_w, float* out_r,
             float* out_w, float* out_m, int h, int w, int y0, int x0,
             int th) {
  constexpr int kAlign = 16 / static_cast<int>(sizeof(T));
  constexpr int kBoxW = 32 + kAlign;
  constexpr int kO = (K - 1) / 2;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const bool edge = x0 < kO || y0 < kO || x0 + kO >= w || y0 + kO >= h;
  for (int ty = 0; ty < th; ++ty)
    for (int px = 0; px < 32; ++px) {
      const int y = y0 + ty, x = x0 + px;
      if (y >= h || x >= w) continue;
      const int64_t p = static_cast<int64_t>(y) * w + x;
      PsfState<C> st = psf_state_at<C>(max_w[p]);
      for (int dy = 0; dy < K; ++dy) {
        const int gy = y0 + dy - kO;
        const int ry = gy - psf_clamp(gy, h);
        float v[K];
        for (int dx = 0; dx < K; ++dx) {
          const int gx = x0 + dx - kO;
          const int yy = gy + ty, xx = gx + px;
          v[dx] = 0.f;
          int at;
          if (!edge)
            at = ty * kBoxW + px + ((dx - kO) % kAlign + kAlign) % kAlign;
          else if (yy >= 0 && yy < h && xx >= 0 && xx < w)
            at = (ty + ry) * kBoxW + px + gx - psf_box_x<kAlign>(gx, w);
          else
            continue;
          if (at < 0 || at >= th * kBoxW) return 1;
          // The box element at, as TMA filled it.
          const int by = psf_clamp(gy, h) + at / kBoxW;
          const int bx = psf_box_x<kAlign>(gx, w) + at % kBoxW;
          const int64_t plane =
              static_cast<int64_t>(K - 1 - dy) * K + (K - 1 - dx);
          if (by < h && bx < w)
            v[dx] = psf_load(logits,
                             plane * hw + static_cast<int64_t>(by) * w + bx);
        }
        psf_row_update<C, K>(st, v,
                             PlaneRow<C>{data, hw, h, w, y + dy - kO, x, kO});
      }
      PsfState<C> out;
      out.m = max_w[p];
      out.w = sum_w[p];
      for (int c = 0; c < C; ++c) out.r[c] = sum_r[c * hw + p];
      psf_merge(out, st);
      out_m[p] = out.m;
      out_w[p] = out.w;
      for (int c = 0; c < C; ++c) out_r[c * hw + p] = out.r[c];
    }
  return 0;
}

template <int C, int K, typename T>
int run_rows(const float* data, const T* logits, const float* sum_r,
             const float* sum_w, const float* max_w, float* out_r,
             float* out_w, float* out_m, int bs, int h, int w, int th) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y0 = 0; y0 < h; y0 += th)
      for (int x0 = 0; x0 < w; x0 += 32)
        if (run_tile<C, K, T>(data + n * C * hw, logits + n * K * K * hw,
                              sum_r + n * C * hw, sum_w + n * hw,
                              max_w + n * hw, out_r + n * C * hw,
                              out_w + n * hw, out_m + n * hw, h, w, y0, x0,
                              th))
          return 1;
  return 0;
}

template <int C, int K>
int rows_k(const float* data, const void* logits, int logits_bf16,
           const float* sum_r, const float* sum_w, const float* max_w,
           float* out_r, float* out_w, float* out_m, int bs, int h, int w,
           int th) {
  if (logits_bf16)
    return run_rows<C, K>(data, static_cast<const uint16_t*>(logits), sum_r,
                          sum_w, max_w, out_r, out_w, out_m, bs, h, w, th);
  return run_rows<C, K>(data, static_cast<const float*>(logits), sum_r,
                        sum_w, max_w, out_r, out_w, out_m, bs, h, w, th);
}

template <int C>
int rows_c(const float* data, const void* logits, int logits_bf16,
           const float* sum_r, const float* sum_w, const float* max_w,
           float* out_r, float* out_w, float* out_m, int bs, int h, int w,
           int k, int th) {
  switch (k) {
    case 3:
      return rows_k<C, 3>(data, logits, logits_bf16, sum_r, sum_w, max_w,
                          out_r, out_w, out_m, bs, h, w, th);
    case 5:
      return rows_k<C, 5>(data, logits, logits_bf16, sum_r, sum_w, max_w,
                          out_r, out_w, out_m, bs, h, w, th);
    case 21:
      return rows_k<C, 21>(data, logits, logits_bf16, sum_r, sum_w, max_w,
                           out_r, out_w, out_m, bs, h, w, th);
    default:
      return 1;
  }
}

}  // namespace

// The tiled kernel's arithmetic, tile by tile at a tile height of `tile_h`
// rows (8 or 16, ops.splat_tile_rows). Same arguments as
// sbmc_progressive_splat_host plus `tile_h`. Returns 0, or 1 outside the
// tiled kernel's set (c 2 or 3; k 3, 5 or 21; w * itemsize a multiple of
// 16; tile_h 8 or 16) or if a read falls outside its box.
extern "C" int sbmc_progressive_splat_rows_host(
    const float* data, const void* logits, int logits_bf16, const float* sum_r,
    const float* sum_w, const float* max_w, float* out_r, float* out_w,
    float* out_m, int bs, int c, int h, int w, int k, int tile_h) {
  if ((tile_h != 8 && tile_h != 16) || (w * (logits_bf16 ? 2 : 4)) % 16)
    return 1;
  switch (c) {
    case 2:
      return rows_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                       out_w, out_m, bs, h, w, k, tile_h);
    case 3:
      return rows_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                       out_w, out_m, bs, h, w, k, tile_h);
    default:
      return 1;
  }
}

// The generic kernel's arithmetic: same arguments as
// sbmc_progressive_splat_generic, minus the stream. Returns 0, or 1 for a
// channel count other than 2 or 3 (the kernel's template set).
extern "C" int sbmc_progressive_splat_host(
    const float* data, const void* logits, int logits_bf16, const float* sum_r,
    const float* sum_w, const float* max_w, float* out_r, float* out_w,
    float* out_m, int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      run_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
               out_m, bs, h, w, k);
      return 0;
    case 3:
      run_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r, out_w,
               out_m, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}
