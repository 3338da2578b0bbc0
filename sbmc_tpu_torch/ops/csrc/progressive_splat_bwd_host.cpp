// Host build of the fused progressive splat step's backward: the generic
// kernels' per-pixel functions and the vector kernels' work items
// (progressive_splat_bwd.cuh) run in plain loops. It exists so the CPU tests
// can check the kernels' index math (p + d_t, the image bounds) and the
// bfloat16 rounding against the plain PyTorch version without a GPU:
//
//   g++ -O2 -shared -fPIC -o libpsb_host.so progressive_splat_bwd_host.cpp

#include "progressive_splat_bwd.cuh"

namespace {

template <int C, typename T>
void run_ddata(const T* logits, const float* new_max, const float* d_r,
               float* d_data, int bs, int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psb_ddata_pixel<C, T>(logits + n * k2 * hw, new_max + n * hw,
                              d_r + n * C * hw, d_data + n * C * hw, h, w, k,
                              y, x);
}

template <int C, typename T>
void run_dlogits(const float* data, const T* logits, const float* new_max,
                 const float* d_r, const float* d_w, T* d_logits, int bs,
                 int h, int w, int k) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t k2 = static_cast<int64_t>(k) * k;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        psb_dlogits_pixel<C, T>(data + n * C * hw, logits + n * k2 * hw,
                                new_max + n * hw, d_r + n * C * hw,
                                d_w + n * hw, d_logits + n * k2 * hw, h, w, k,
                                y, x);
}

template <int C>
void ddata_c(const void* logits, int logits_bf16, const float* new_max,
             const float* d_r, float* d_data, int bs, int h, int w, int k) {
  if (logits_bf16)
    run_ddata<C>(static_cast<const uint16_t*>(logits), new_max, d_r, d_data,
                 bs, h, w, k);
  else
    run_ddata<C>(static_cast<const float*>(logits), new_max, d_r, d_data, bs,
                 h, w, k);
}

template <int C>
void dlogits_c(const float* data, const void* logits, int logits_bf16,
               const float* new_max, const float* d_r, const float* d_w,
               void* d_logits, int bs, int h, int w, int k) {
  if (logits_bf16)
    run_dlogits<C>(data, static_cast<const uint16_t*>(logits), new_max, d_r,
                   d_w, static_cast<uint16_t*>(d_logits), bs, h, w, k);
  else
    run_dlogits<C>(data, static_cast<const float*>(logits), new_max, d_r, d_w,
                   static_cast<float*>(d_logits), bs, h, w, k);
}

// The small planes at the shifted pixels of one work item's tap row, read
// from the planes: the host's stand-in for the vector kernel's halo in
// shared memory.
template <int C>
struct PlaneSmall {
  const float* new_max;
  const float* d_r;
  const float* d_w;
  int64_t hw;
  int h, w, sy, x0;  // x0: the item's first column less o
  void get(int col, float& m, float (&a)[C + 1]) const {
    const int sx = x0 + col;
    if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
      m = INFINITY;
      for (int c = 0; c <= C; ++c) a[c] = 0.f;
      return;
    }
    const int64_t q = static_cast<int64_t>(sy) * w + sx;
    m = new_max[q];
    a[0] = d_w[q];
    for (int c = 0; c < C; ++c) a[c + 1] = d_r[c * hw + q];
  }
};

// Every work item (batch item, row, vector of V pixels, tap row) in turn.
template <int C, int K, typename T>
void run_dlogits_rows(const float* data, const T* logits,
                      const float* new_max, const float* d_r,
                      const float* d_w, T* d_logits, int bs, int h, int w) {
  constexpr int V = 16 / sizeof(T);
  constexpr int o = (K - 1) / 2;
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; x += V) {
        const int64_t p = static_cast<int64_t>(y) * w + x;
        float dat[V][C];
        for (int j = 0; j < V; ++j)
          for (int c = 0; c < C; ++c)
            dat[j][c] = data[(n * C + c) * hw + p + j];
        for (int dy = 0; dy < K; ++dy)
          psb_dlogits_row<C, K, V>(
              dat, logits + n * K * K * hw, d_logits + n * K * K * hw, hw, p,
              dy,
              PlaneSmall<C>{new_max + n * hw, d_r + n * C * hw, d_w + n * hw,
                            hw, h, w, y + dy - o, x - o});
      }
}

template <int C, typename T>
int dlogits_rows_k(const float* data, const T* logits, const float* new_max,
                   const float* d_r, const float* d_w, T* d_logits, int bs,
                   int h, int w, int k) {
  switch (k) {
    case 3:
      run_dlogits_rows<C, 3>(data, logits, new_max, d_r, d_w, d_logits, bs,
                             h, w);
      return 0;
    case 5:
      run_dlogits_rows<C, 5>(data, logits, new_max, d_r, d_w, d_logits, bs,
                             h, w);
      return 0;
    case 21:
      run_dlogits_rows<C, 21>(data, logits, new_max, d_r, d_w, d_logits, bs,
                              h, w);
      return 0;
    default:
      return 1;
  }
}

template <int C>
int dlogits_rows_c(const float* data, const void* logits, int logits_bf16,
                   const float* new_max, const float* d_r, const float* d_w,
                   void* d_logits, int bs, int h, int w, int k) {
  if (logits_bf16)
    return dlogits_rows_k<C>(data, static_cast<const uint16_t*>(logits),
                             new_max, d_r, d_w,
                             static_cast<uint16_t*>(d_logits), bs, h, w, k);
  return dlogits_rows_k<C>(data, static_cast<const float*>(logits), new_max,
                           d_r, d_w, static_cast<float*>(d_logits), bs, h, w,
                           k);
}

// The small planes at the shifted pixels of a d_data work item: the host's
// stand-in for the vector kernel's halo (m2 = psb_m2(m), as the kernel
// stages it).
template <int C>
struct PlaneDdSmall {
  const float* new_max;
  const float* d_r;
  int64_t hw;
  int h, w, y0, x0;  // the item's row and first column, less o
  void get(int dy, int col, float& m2, float (&d)[C]) const {
    const int sy = y0 + dy, sx = x0 + col;
    if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
      m2 = INFINITY;
      for (int c = 0; c < C; ++c) d[c] = 0.f;
      return;
    }
    const int64_t q = static_cast<int64_t>(sy) * w + sx;
    m2 = psb_m2(new_max[q]);
    for (int c = 0; c < C; ++c) d[c] = d_r[c * hw + q];
  }
};

// Every d_data work item (batch item, row, vector of V pixels) in turn, as
// psb_ddata_vec assembles it: the sums of each of `groups` groups of tap
// rows (group g: rows g, g + groups, ...), joined in group order, stored.
template <int C, int K, typename T>
void run_ddata_tiles(const T* logits, const float* new_max, const float* d_r,
                     float* d_data, int bs, int h, int w, int groups) {
  constexpr int V = 16 / sizeof(T);
  constexpr int o = (K - 1) / 2;
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t n = 0; n < bs; ++n)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; x += V) {
        const int64_t p = static_cast<int64_t>(y) * w + x;
        const PlaneDdSmall<C> small{new_max + n * hw, d_r + n * C * hw, hw,
                                    h, w, y - o, x - o};
        const T* l0 = logits + n * K * K * hw + p;
        float acc[V][C];
        psb_ddata_group<C, K, V>(l0, hw, 0, groups, small, acc);
        for (int g = 1; g < groups; ++g) {
          float b[V][C];
          psb_ddata_group<C, K, V>(l0, hw, g, groups, small, b);
          psb_ddata_merge(acc, b);
        }
        psb_ddata_store<C, V>(d_data + n * C * hw + p, hw, acc);
      }
}

template <int C, typename T>
int ddata_tiles_k(const T* logits, const float* new_max, const float* d_r,
                  float* d_data, int bs, int h, int w, int k, int groups) {
  if ((groups != 1 && groups != 2 && groups != 4 && groups != 8) ||
      groups > k)
    return 1;
  switch (k) {
    case 3:
      run_ddata_tiles<C, 3>(logits, new_max, d_r, d_data, bs, h, w, groups);
      return 0;
    case 5:
      run_ddata_tiles<C, 5>(logits, new_max, d_r, d_data, bs, h, w, groups);
      return 0;
    case 21:
      run_ddata_tiles<C, 21>(logits, new_max, d_r, d_data, bs, h, w, groups);
      return 0;
    default:
      return 1;
  }
}

template <int C>
int ddata_tiles_c(const void* logits, int logits_bf16, const float* new_max,
                  const float* d_r, float* d_data, int bs, int h, int w,
                  int k, int groups) {
  if (logits_bf16)
    return ddata_tiles_k<C>(static_cast<const uint16_t*>(logits), new_max,
                            d_r, d_data, bs, h, w, k, groups);
  return ddata_tiles_k<C>(static_cast<const float*>(logits), new_max, d_r,
                          d_data, bs, h, w, k, groups);
}

}  // namespace

// The vector d_data kernel's arithmetic, work item by work item, with its
// tap rows in `groups` groups joined in group order. Same arguments as
// sbmc_progressive_splat_ddata_host plus `groups`. Returns 0, or 1
// outside the vector kernel's set: c 2 or 3, k 3, 5 or 21, w a multiple of
// the vector width (4 float32 or 8 bfloat16 logits), groups 1, 2, 4 or 8
// and at most k.
extern "C" int sbmc_progressive_splat_ddata_tiles_host(
    const void* logits, int logits_bf16, const float* new_max,
    const float* d_r, float* d_data, int bs, int c, int h, int w, int k,
    int groups) {
  if (w % (logits_bf16 ? 8 : 4) != 0) return 1;
  switch (c) {
    case 2:
      return ddata_tiles_c<2>(logits, logits_bf16, new_max, d_r, d_data, bs,
                              h, w, k, groups);
    case 3:
      return ddata_tiles_c<3>(logits, logits_bf16, new_max, d_r, d_data, bs,
                              h, w, k, groups);
    default:
      return 1;
  }
}

// The vector d_logits kernel's arithmetic, work item by work item. Same
// arguments as sbmc_progressive_splat_dlogits_host. Returns 0, or 1 outside
// the vector kernel's set: c 2 or 3, k 3, 5 or 21, w a multiple of the
// vector width (4 float32 or 8 bfloat16 logits).
extern "C" int sbmc_progressive_splat_dlogits_rows_host(
    const float* data, const void* logits, int logits_bf16,
    const float* new_max, const float* d_r, const float* d_w, void* d_logits,
    int bs, int c, int h, int w, int k) {
  if (w % (logits_bf16 ? 8 : 4) != 0) return 1;
  switch (c) {
    case 2:
      return dlogits_rows_c<2>(data, logits, logits_bf16, new_max, d_r, d_w,
                               d_logits, bs, h, w, k);
    case 3:
      return dlogits_rows_c<3>(data, logits, logits_bf16, new_max, d_r, d_w,
                               d_logits, bs, h, w, k);
    default:
      return 1;
  }
}

// The generic kernels' arithmetic: same arguments as the CUDA entry points
// sbmc_progressive_splat_ddata_generic and
// sbmc_progressive_splat_dlogits_generic, minus the stream. Both return 0,
// or 1 for a channel count other than 2 or 3 (the kernels' template set).

extern "C" int sbmc_progressive_splat_ddata_host(
    const void* logits, int logits_bf16, const float* new_max,
    const float* d_r, float* d_data, int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      ddata_c<2>(logits, logits_bf16, new_max, d_r, d_data, bs, h, w, k);
      return 0;
    case 3:
      ddata_c<3>(logits, logits_bf16, new_max, d_r, d_data, bs, h, w, k);
      return 0;
    default:
      return 1;
  }
}

extern "C" int sbmc_progressive_splat_dlogits_host(
    const float* data, const void* logits, int logits_bf16,
    const float* new_max, const float* d_r, const float* d_w, void* d_logits,
    int bs, int c, int h, int w, int k) {
  switch (c) {
    case 2:
      dlogits_c<2>(data, logits, logits_bf16, new_max, d_r, d_w, d_logits, bs,
                   h, w, k);
      return 0;
    case 3:
      dlogits_c<3>(data, logits, logits_bf16, new_max, d_r, d_w, d_logits, bs,
                   h, w, k);
      return 0;
    default:
      return 1;
  }
}
