// R3: jax.random's threefry2x32 uniforms (or raw bits) for a batch of keys.
//
// The port of the random draws of the JAX renderer
// (sbmc_tpu/render/pathtracer.py: jax.random.uniform / normal in
// render_pass, _cosine_sample, _phong_sample and _sphere_dir). There is no
// Pallas kernel behind it: XLA fused the hash into the tracer. The keys are
// derived on the host (sbmc_tpu_torch/render/prng.py); this kernel expands
// each of n_keys keys into n values, out[b, i] for element i of key b.
//
// Bound: integer issue. One value is ~80 32-bit integer operations (20
// rounds of add, rotate and xor plus 5 key injections) for 4 bytes written,
// so the card's int32 rate, not its memory, limits it. Design: one thread a
// value, the whole cipher in registers, the key pair read once a thread
// (the y grid dimension is the key), a grid-stride loop over the values.

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_kernel(const uint32_t* __restrict__ keys, int n,
                                float lo, float span, int raw,
                                void* __restrict__ out) {
  const int b = blockIdx.y;
  const uint32_t k0 = keys[2 * b], k1 = keys[2 * b + 1];
  const int64_t row = static_cast<int64_t>(b) * n;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const uint32_t bits = tf_bits(k0, k1, static_cast<uint64_t>(i));
    if (raw)
      static_cast<uint32_t*>(out)[row + i] = bits;
    else
      static_cast<float*>(out)[row + i] = tf_uniform(bits, lo, span);
  }
}

}  // namespace

// keys: [n_keys, 2] uint32; out: [n_keys, n] float32 uniforms in [lo, lo +
// span), or uint32 bits with raw != 0.
extern "C" int sbmc_threefry_uniform(const void* keys, int n_keys, int n,
                                     float lo, float span, int raw, void* out,
                                     void* stream) {
  if (n_keys < 1 || n_keys > 65535 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(blocks < 4096 ? blocks : 4096, n_keys);
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, lo, span, raw, out);
  return static_cast<int>(cudaGetLastError());
}
