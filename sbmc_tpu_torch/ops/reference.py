"""Plain PyTorch versions of the splat/gather operators (forward only).

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

Logits may be bfloat16; weighting and accumulation are float32.
"""

import torch
import torch.nn.functional as F

__all__ = [
    "extract_patches",
    "kernel_weighting_ref",
    "scatter2gather_ref",
    "scatter2gather_max_ref",
    "kernel_weighting_exp_ref",
    "progressive_splat_update_ref",
    "ksize_of",
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
    data = data.float()
    weights = weights.float()
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
