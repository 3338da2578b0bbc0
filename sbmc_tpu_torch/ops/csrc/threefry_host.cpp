// Host build of the threefry kernel's arithmetic (threefry.cuh) in a plain
// loop, so the CPU tests can hold it bit for bit against the plain PyTorch
// version and jax.random without a GPU:
//
//   g++ -O2 -shared -fPIC -o libthreefry_host.so threefry_host.cpp

#include "threefry.cuh"

extern "C" int sbmc_threefry_uniform_host(const void* keys, int n_keys, int n,
                                          float lo, float span, int raw,
                                          void* out) {
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  for (int b = 0; b < n_keys; ++b)
    for (int i = 0; i < n; ++i) {
      const int64_t j = static_cast<int64_t>(b) * n + i;
      const uint32_t bits = tf_bits(k[2 * b], k[2 * b + 1], i);
      if (raw)
        static_cast<uint32_t*>(out)[j] = bits;
      else
        static_cast<float*>(out)[j] = tf_uniform(bits, lo, span);
    }
  return 0;
}
