"""Plain PyTorch versions of the splat/gather operators.

They are the port's counterpart of ``sbmc_tpu/ops/reference.py``: the
obviously-correct algorithm that the CPU path runs and that the CUDA kernel
is held against on the card.

Conventions (spatial-last, as in the JAX package):

- ``data``:    ``[bs, c, h, w]`` values to be locally averaged.
- ``weights``: ``[bs, k2, h, w]`` per-pixel kernels; the flat tap index
  ``i`` unflattens to ``(dy, dx) = divmod(i, k)``.
- ``output[n, c, y, x] = sum_{dy,dx} weights[n, dy*k+dx, y, x]
  * data[n, c, y+dy-o, x+dx-o]`` with ``o = (k-1)//2`` and zero boundary.
- ``sum_w[n, y, x] = sum_i weights[n, i, y, x]``: every tap counts,
  regardless of image bounds.
- ``scatter2gather`` zero-pads, so a gathered logit from outside the image
  is 0 (not -inf): it adds ``exp(0 - m)`` to ``sum_w`` and nothing to
  ``sum_r``.

Logits may be bfloat16; weighting and accumulation are float32 (float64
inputs stay float64, which is what lets ``torch.autograd.gradcheck`` run on
these versions).
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "extract_patches",
    "kernel_weighting_ref",
    "scatter2gather_ref",
    "scatter2gather_max_ref",
    "kernel_weighting_exp_ref",
    "progressive_splat_update_ref",
    "kernel_weighting_dw_ref",
    "kernel_weighting_bwd_ref",
    "progressive_splat_ddata_ref",
    "progressive_splat_dlogits_ref",
    "progressive_splat_bwd_ref",
    "ksize_of",
    "threefry_uniform_ref",
    "tri_hits_ref",
    "tri_nearest_ref",
    "tri_any_ref",
    "TRI_MISS",
]


def ksize_of(weights):
    """Kernel width ``k`` of a ``[bs, k*k, h, w]`` tensor (odd, square)."""
    k2 = weights.shape[1]
    k = int(round(k2 ** 0.5))
    if k * k != k2:
        raise ValueError(f"weights tap dim {k2} is not a square")
    if k % 2 == 0:
        raise ValueError("kernel size must be odd")
    return k


def _wide(t):
    """``t`` in the accumulation type: float32, or float64 if it is that."""
    return t if t.dtype == torch.float64 else t.float()


def extract_patches(data, k):
    """``[bs, c, k*k, h, w]`` shifted copies of ``data`` (zero padded):
    ``out[n, c, i, y, x] = data_pad[n, c, y + i//k - o, x + i%k - o]``."""
    h, w = data.shape[-2:]
    o = (k - 1) // 2
    dp = F.pad(data, (o, o, o, o))
    return torch.stack([dp[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=2)


def kernel_weighting_ref(data, weights):
    """Forward kernel weighting: ``(output [bs, c, h, w], sum_w [bs, h, w])``
    in float32. A loop over taps keeps memory at one data-sized
    accumulator instead of the ``k^2``-fold patch tensor."""
    k = ksize_of(weights)
    h, w = data.shape[-2:]
    o = (k - 1) // 2
    data = _wide(data)
    weights = _wide(weights)
    dp = F.pad(data, (o, o, o, o))
    out = torch.zeros_like(data)
    for i in range(k * k):
        dy, dx = divmod(i, k)
        out += weights[:, i:i + 1] * dp[:, :, dy:dy + h, dx:dx + w]
    return out, weights.sum(dim=1)


def scatter2gather_ref(weights):
    """Transpose splat kernels into gather kernels (self-adjoint):
    ``out[n, dy*k+dx, y, x] = weights_pad[n, (k-1-dy)*k + (k-1-dx),
    y+dy-o, x+dx-o]``. Keeps the dtype."""
    k = ksize_of(weights)
    bs, k2, h, w = weights.shape
    o = (k - 1) // 2
    wf = weights.reshape(bs, k, k, h, w).flip(1, 2).reshape(bs, k2, h, w)
    wf = F.pad(wf, (o, o, o, o))
    return torch.stack([wf[:, dy * k + dx, dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=1)


def scatter2gather_max_ref(weights):
    """``scatter2gather`` plus the per-pixel tap max in float32:
    ``(gather [bs, k2, h, w], kmax [bs, h, w])``."""
    g = scatter2gather_ref(weights)
    return g, g.float().amax(dim=1)


def kernel_weighting_exp_ref(data, logits, maxes):
    """Kernel weighting of ``exp(logits - maxes)`` (``maxes``:
    ``[bs, h, w]``), in float32."""
    return kernel_weighting_ref(
        data, torch.exp(logits.float() - maxes[:, None]))


def progressive_splat_update_ref(data, klogits, sum_r, sum_w, max_w):
    """One progressive online-softmax splat step, composed from the ops
    above exactly as ``sbmc_tpu.ops`` composes its ``xla`` branch.

    Args:
      data: ``[bs, c, h, w]`` sample radiance.
      klogits: ``[bs, k2, h, w]`` raw splat-kernel logits (f32 or bf16).
      sum_r, sum_w, max_w: running state (``[bs, c, h, w]``,
        ``[bs, 1, h, w]``, ``[bs, 1, h, w]``).

    Returns:
      ``(sum_r', sum_w', max_w')`` in float32.
    """
    g, kmax = scatter2gather_max_ref(klogits)
    new_max = torch.maximum(kmax[:, None], max_w)
    scaler = torch.exp(max_w - new_max)
    r, w = kernel_weighting_exp_ref(data, g, new_max[:, 0])
    return sum_r * scaler + r, sum_w * scaler + w[:, None], new_max


def kernel_weighting_dw_ref(data, d_output, d_sum_w, k):
    """Gradient of kernel weighting to its weights, ``[bs, k*k, h, w]``:
    ``d_w[n, i, y, x] = d_sum_w[n, y, x] + sum_c data_pad[n, c, y+dy-o,
    x+dx-o] * d_output[n, c, y, x]``. A loop over taps, as in
    :func:`kernel_weighting_ref`."""
    bs, _, h, w = data.shape
    o = (k - 1) // 2
    dp = F.pad(_wide(data), (o, o, o, o))
    out = torch.empty((bs, k * k, h, w), dtype=dp.dtype, device=data.device)
    for i in range(k * k):
        dy, dx = divmod(i, k)
        out[:, i] = (dp[:, :, dy:dy + h, dx:dx + w] * d_output).sum(1) \
            + d_sum_w
    return out


def kernel_weighting_bwd_ref(data, weights, d_output, d_sum_w):
    """Backward of :func:`kernel_weighting_ref`, composed exactly as the
    ``xla`` branch of ``sbmc_tpu.ops._kernel_weighting_bwd``: ``d_data`` is
    the forward applied to the cotangent with the kernels transposed, and
    ``d_weights`` (float32) the weights' gradient above.

    Returns:
      ``(d_data [bs, c, h, w], d_weights [bs, k2, h, w])``.
    """
    d_data = kernel_weighting_ref(d_output, scatter2gather_ref(weights))[0]
    return d_data, kernel_weighting_dw_ref(data, d_output, d_sum_w,
                                           ksize_of(weights))


def _splat_weights(klogits, new_max):
    """``exp(g - m)``: the gather-form weights of the forward, float32."""
    return torch.exp(scatter2gather_ref(klogits.float()) - new_max)


def progressive_splat_ddata_ref(klogits, new_max, d_r):
    """Gradient of one progressive splat step to ``data``: the forward
    weighting applied to the cotangent with the weights transposed back to
    splat form, ``kw(d_r, s2g(exp(s2g(L) - m)))``."""
    e = _splat_weights(klogits, new_max)
    return kernel_weighting_ref(d_r, scatter2gather_ref(e))[0]


def progressive_splat_dlogits_ref(data, klogits, new_max, d_r, d_w):
    """Gradient of one progressive splat step to ``klogits`` (in their
    dtype): ``s2g(e * d_e)`` with ``e = exp(s2g(L) - m)`` and ``d_e`` the
    weights' gradient of kernel weighting."""
    e = _splat_weights(klogits, new_max)
    d_e = kernel_weighting_dw_ref(data, d_r, d_w[:, 0], ksize_of(klogits))
    return scatter2gather_ref(e * d_e).to(klogits.dtype)


def progressive_splat_bwd_ref(data, klogits, new_max, d_r, d_w):
    """Backward of :func:`progressive_splat_update_ref` with the running max
    held constant, composed exactly as the ``xla`` branch of
    ``sbmc_tpu.ops._psu_bwd``.

    Autograd through the forward would also differentiate the max; that
    contribution cancels in ``sum_r / sum_w`` (softmax shift invariance), so
    the op drops it.

    Args:
      data: ``[bs, c, h, w]`` sample radiance.
      klogits: ``[bs, k2, h, w]`` splat logits (f32 or bf16).
      new_max: ``[bs, 1, h, w]`` the forward's running max after the update.
      d_r: ``[bs, c, h, w]`` cotangent of the new ``sum_r``.
      d_w: ``[bs, 1, h, w]`` cotangent of the new ``sum_w``.

    Returns:
      ``(d_data [bs, c, h, w] float32, d_klogits [bs, k2, h, w]`` in the
      logits' dtype ``)``.
    """
    return (progressive_splat_ddata_ref(klogits, new_max, d_r),
            progressive_splat_dlogits_ref(data, klogits, new_max, d_r, d_w))


# ---------------------------------------------------------------------------
# The wavefront renderer's kernels (sbmc_tpu_torch/render/pathtracer.py).

#: Distance of a miss (the JAX renderer's ``_INF``).
TRI_MISS = 1e10

_TF_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = 0xFFFFFFFF


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _TF_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) & _U32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def threefry_uniform_ref(keys, n, minval=0.0, maxval=1.0, raw=False):
    """``jax.random.uniform(key, (n,), minval=minval, maxval=maxval)`` for
    each key, under partitionable threefry2x32 (see ``csrc/threefry.cuh``).

    Args:
      keys: ``[b, 2]`` int32 tensor of uint32 key words.
      n: values per key (< 2**31).
      raw: return the 32 random bits (as int32) instead of the floats.

    Returns:
      ``[b, n]`` float32 in ``[minval, maxval)``, or int32 bits.
    """
    k = keys.to(torch.int64) & _U32
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = _threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(i), i)
    bits = y0 ^ y1
    if raw:
        return ((bits ^ 0x80000000) - 0x80000000).to(torch.int32)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # f * (hi - lo) + lo rounded once, as XLA's fused multiply-add: the
    # product is exact in float64 and so is the sum for bounds within ~2**29
    # of each other in magnitude.
    r = (f.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(r, float(lo))


def tri_hits_ref(org, dirs, time, tris):
    """Every ray against every triangle: ``sbmc_tpu/render/pathtracer.py``
    ``_tri_ts`` on packed constants (``csrc/trace_hits.cuh``), the dot
    products summed x, y, z.

    Args:
      org, dirs: ``[n, 3]`` float32 rays; time: ``[n]`` shutter times.
      tris: ``[t, 16]`` packed triangle constants.

    Returns:
      ``(ts [n, t], back [n, t])``: hit distances (``TRI_MISS`` on a miss)
      and back-face flags.
    """
    c = tris.t()

    def dot(v, a):
        return v[:, 0:1] * c[a] + v[:, 1:2] * c[a + 1] + v[:, 2:3] * c[a + 2]

    o_n, o_g1, o_g2 = dot(org, 0), dot(org, 3), dot(org, 6)
    den, d_g1, d_g2 = dot(dirs, 0), dot(dirs, 3), dot(dirs, 6)
    tt = time[:, None]
    valid = den.abs() > 1e-9
    ts = (c[9] + tt * c[12] - o_n) / torch.where(valid, den, 1.0)
    u = o_g1 - c[10] - tt * c[13] + ts * d_g1
    v = o_g2 - c[11] - tt * c[14] + ts * d_g2
    ok = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (ts > 1e-3)
    return torch.where(ok, ts, TRI_MISS), ok & (den > 0)


def tri_nearest_ref(org, dirs, time, tris):
    """Nearest triangle per ray: ``(t [n], idx [n] int32, back [n] bool)``,
    the first triangle winning ties (``jnp.argmin``); a ray that hits none
    gets ``(TRI_MISS, 0, False)``."""
    n = org.shape[0]
    if tris.shape[0] == 0:
        return (torch.full((n,), TRI_MISS, device=org.device),
                torch.zeros(n, dtype=torch.int32, device=org.device),
                torch.zeros(n, dtype=torch.bool, device=org.device))
    ts, back = tri_hits_ref(org, dirs, time, tris)
    idx = torch.argmin(ts, 1, keepdim=True)
    return (ts.gather(1, idx)[:, 0], idx[:, 0].to(torch.int32),
            back.gather(1, idx)[:, 0])


def tri_any_ref(org, dirs, dist, tris):
    """Whether any triangle lies closer than ``dist - 1e-3`` along each ray,
    the geometry at time 0 (the JAX renderer's shadow rays): ``[n]`` bool."""
    if tris.shape[0] == 0:
        return torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
    ts, _ = tri_hits_ref(org, dirs, torch.zeros_like(dist), tris)
    return (ts < (dist - 1e-3)[:, None]).any(1)
