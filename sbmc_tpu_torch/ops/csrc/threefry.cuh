// JAX's threefry2x32 random bits and their float32 uniforms, bit for bit.
//
// Shared by the CUDA kernel (threefry.cu) and a host build
// (threefry_host.cpp) that lets the CPU tests hold the arithmetic against
// the plain PyTorch version and against jax.random without a GPU.
//
// Under jax_threefry_partitionable (jax/_src/prng.py
// _threefry_random_bits_partitionable) element i of a draw of n values from
// the key (k0, k1) has the bits y0 ^ y1 of threefry2x32((k0, k1),
// (i >> 32, i & 0xffffffff)), 20 rounds of Threefry-2x32. jax.random's
// _uniform keeps the top 23 bits as the mantissa of a float in [1, 2),
// subtracts 1, scales to [lo, hi) with one fused multiply-add (XLA's CPU
// backend contracts f * (hi - lo) + lo into one) and clamps below at lo.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define TF_HD __host__ __device__ __forceinline__
#else
#define TF_HD inline
#endif

TF_HD uint32_t tf_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, of the counter pair (x0, x1) in place.
TF_HD void tf_threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                           uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = tf_rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// The 32 random bits of flat element i of a draw from key (k0, k1).
TF_HD uint32_t tf_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  tf_threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float of 32 random bits in [lo, hi); span = hi - lo,
// rounded to float32 by the caller as XLA rounds it.
TF_HD float tf_uniform(uint32_t bits, float lo, float span) {
  const uint32_t fb = (bits >> 9) | 0x3F800000u;
  float f;
#ifdef __CUDA_ARCH__
  f = __uint_as_float(fb) - 1.0f;
  const float r = __fmaf_rn(f, span, lo);
#else
  memcpy(&f, &fb, sizeof f);
  f = f - 1.0f;
  const float r = fmaf(f, span, lo);
#endif
  return r > lo ? r : lo;
}
