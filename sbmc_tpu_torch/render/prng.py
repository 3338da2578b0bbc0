"""JAX's threefry2x32 key arithmetic on the host, bit for bit.

The JAX renderer draws every random number with ``jax.random`` under
``jax_threefry_partitionable`` (the default of the JAX releases the
package runs on). Its keys are a handful of scalars per sample pass, so
the port derives them here in numpy ``uint32`` (no device round trip) and
sends only the bulk bits to the card through ``ops.random_uniform``, the
hand-written threefry kernel. The scheme (``jax/_src/prng.py``):

- a key is two ``uint32`` words; ``threefry2x32(k, (x0, x1))`` is the
  20-round Threefry-2x32 block cipher of the counter pair ``(x0, x1)``;
- ``PRNGKey(seed)`` is ``(seed >> 32, seed & 0xffffffff)``;
- ``split(key, num)[i]`` is ``threefry2x32(key, (0, i))`` (the 64-bit
  counter ``i`` as high and low words);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- the 32 random bits of flat element ``i`` are ``y0 ^ y1`` of
  ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
- ``uniform`` keeps the top 23 bits as the mantissa of a float in
  ``[1, 2)``, subtracts 1, then scales to ``[minval, maxval)`` with one
  fused multiply-add (XLA's CPU backend contracts ``f * (maxval - minval)
  + minval``) and clamps below at ``minval``;
- ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``.
"""

import numpy as np

__all__ = ["PRNGKey", "split", "fold_in", "threefry2x32", "random_bits",
           "uniform", "NORMAL_LO"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
#: ``normal``'s lower bound: the float32 after -1 towards 0.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters ``(x0, x1)`` under the key
    ``(k0, k1)``; all arguments broadcast as ``uint32`` arrays. Returns
    ``(y0, y1)``."""
    with np.errstate(over="ignore"):
        k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
        ks = (k0, k1, k0 ^ k1 ^ _PARITY)
        x = [x0 + ks[0], x1 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
        return x[0], x[1]


def PRNGKey(seed):  # noqa: N802 (jax.random's name)
    """The key of an integer seed: ``[seed >> 32, seed & 0xffffffff]``. A
    seed in the int32 range is taken as a 32-bit integer, as JAX takes it
    without 64-bit mode: its high word is 0 even when it is negative."""
    seed = int(seed)
    if -2 ** 31 <= seed < 2 ** 31:
        seed &= 0xFFFFFFFF
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key, num=2):
    """``jax.random.split``: ``[..., num, 2]`` keys from keys ``[..., 2]``
    (each key split on its own)."""
    key = np.asarray(key, np.uint32)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], -1)


def fold_in(key, data):
    """``jax.random.fold_in``: new keys ``[..., 2]`` from keys ``[..., 2]``
    and a 32-bit integer."""
    key = np.asarray(key, np.uint32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.stack([y0, y1], -1).astype(np.uint32)


def random_bits(key, n):
    """The 32 random bits of each of ``n`` elements (``uint32 [n]``)."""
    key = np.asarray(key, np.uint32)
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key[0], key[1], (i >> np.uint64(32)).astype(
        np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32 (the host version of the kernel)."""
    shape = (shape,) if np.isscalar(shape) else tuple(shape)
    bits = random_bits(key, int(np.prod(shape)))
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # The product is exact in float64, and so is the sum unless the bounds
    # are ~2**29 apart in magnitude: one rounding, as a fused multiply-add.
    out = (f.astype(np.float64) * np.float64(hi - lo) + lo).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)
