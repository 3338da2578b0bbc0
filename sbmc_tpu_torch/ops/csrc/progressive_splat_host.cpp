// Host build of the fused progressive splat step: the generic kernel's
// per-pixel function, and the tiled kernel's row update and state merge
// (progressive_splat.cuh), run in plain loops. It exists so the CPU tests
// can check both kernels' index math and online softmax against the plain
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

// One pixel as the tiled kernel assembles it: tap rows dy = g, g + groups,
// ... into group g's state (rows in order when groups is 1, which is what
// the kernel does), the groups merged in order, then the old state merged
// with the result.
template <int C, int K, typename T>
void rows_pixel(const float* data, const T* logits, const float* sum_r,
                const float* sum_w, const float* max_w, float* out_r,
                float* out_w, float* out_m, int h, int w, int y, int x,
                int groups) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(y) * w + x;
  const int o = (K - 1) / 2;
  PsfState<C> acc = psf_state_at<C>(max_w[p]);
  for (int g = 0; g < groups; ++g) {
    PsfState<C> s = psf_state_at<C>(max_w[p]);
    for (int dy = g; dy < K; dy += groups) {
      const int sy = y + dy - o;
      float v[K];
      for (int dx = 0; dx < K; ++dx) {
        const int sx = x + dx - o;
        const bool in = sy >= 0 && sy < h && sx >= 0 && sx < w;
        const int64_t plane =
            static_cast<int64_t>(K - 1 - dy) * K + (K - 1 - dx);
        v[dx] = in ? psf_load(logits,
                              plane * hw + static_cast<int64_t>(sy) * w + sx)
                   : 0.f;
      }
      psf_row_update<C, K>(s, v, PlaneRow<C>{data, hw, h, w, sy, x, o});
    }
    if (g == 0)
      acc = s;
    else
      psf_merge(acc, s);
  }
  PsfState<C> out;
  out.m = max_w[p];
  out.w = sum_w[p];
  for (int c = 0; c < C; ++c) out.r[c] = sum_r[c * hw + p];
  psf_merge(out, acc);
  out_m[p] = out.m;
  out_w[p] = out.w;
  for (int c = 0; c < C; ++c) out_r[c * hw + p] = out.r[c];
}

template <int C, int K, typename T>
void run_rows(const float* data, const T* logits, const float* sum_r,
              const float* sum_w, const float* max_w, float* out_r,
              float* out_w, float* out_m, int bs, int h, int w, int groups) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        rows_pixel<C, K, T>(data + n * C * hw, logits + n * K * K * hw,
                            sum_r + n * C * hw, sum_w + n * hw,
                            max_w + n * hw, out_r + n * C * hw,
                            out_w + n * hw, out_m + n * hw, h, w, y, x,
                            groups);
}

template <int C, int K>
void rows_k(const float* data, const void* logits, int logits_bf16,
            const float* sum_r, const float* sum_w, const float* max_w,
            float* out_r, float* out_w, float* out_m, int bs, int h, int w,
            int groups) {
  if (logits_bf16)
    run_rows<C, K>(data, static_cast<const uint16_t*>(logits), sum_r, sum_w,
                   max_w, out_r, out_w, out_m, bs, h, w, groups);
  else
    run_rows<C, K>(data, static_cast<const float*>(logits), sum_r, sum_w,
                   max_w, out_r, out_w, out_m, bs, h, w, groups);
}

template <int C>
int rows_c(const float* data, const void* logits, int logits_bf16,
           const float* sum_r, const float* sum_w, const float* max_w,
           float* out_r, float* out_w, float* out_m, int bs, int h, int w,
           int k, int groups) {
  switch (k) {
    case 3:
      rows_k<C, 3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                   out_w, out_m, bs, h, w, groups);
      return 0;
    case 5:
      rows_k<C, 5>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                   out_w, out_m, bs, h, w, groups);
      return 0;
    case 21:
      rows_k<C, 21>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                    out_w, out_m, bs, h, w, groups);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// The tiled kernel's arithmetic with its tap rows split among `groups`
// states (1: as the kernel runs it). Same arguments as
// sbmc_progressive_splat_host plus `groups`. Returns 0, or 1 for a channel
// count or kernel size outside the tiled kernel's template set (c 2 or 3;
// k 3, 5 or 21) or groups < 1.
extern "C" int sbmc_progressive_splat_rows_host(
    const float* data, const void* logits, int logits_bf16, const float* sum_r,
    const float* sum_w, const float* max_w, float* out_r, float* out_w,
    float* out_m, int bs, int c, int h, int w, int k, int groups) {
  if (groups < 1) return 1;
  switch (c) {
    case 2:
      return rows_c<2>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                       out_w, out_m, bs, h, w, k, groups);
    case 3:
      return rows_c<3>(data, logits, logits_bf16, sum_r, sum_w, max_w, out_r,
                       out_w, out_m, bs, h, w, k, groups);
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
