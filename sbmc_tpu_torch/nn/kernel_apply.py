"""Progressive kernel accumulation (counterpart of
``sbmc_tpu/nn/kernel_apply.py``).

``progressive_kernel_apply`` adds one sample's splat contribution to the
running online-softmax state ``(sum_r, sum_w, max_w)``, so the SBMC model's
memory stays O(1) in the sample count. A state starting at
``max_w = -1e30`` makes the first update reproduce the reference's separate
initialisation step exactly.
"""

from typing import NamedTuple

import torch

from sbmc_tpu_torch import ops

__all__ = ["ProgressiveState", "progressive_init", "progressive_kernel_apply"]

_NEG_INF = -1e30  # finite stand-in for -inf: exp(x - _NEG_INF) == 0 in f32


class ProgressiveState(NamedTuple):
    """Running accumulators of the progressive (online softmax) apply."""
    sum_r: torch.Tensor  # [bs, c, h, w]
    sum_w: torch.Tensor  # [bs, 1, h, w]
    max_w: torch.Tensor  # [bs, 1, h, w]


def progressive_init(bs, c, h, w, device=None):
    """Zero-initialised float32 state (``max_w = -1e30``)."""
    return ProgressiveState(
        sum_r=torch.zeros((bs, c, h, w), device=device),
        sum_w=torch.zeros((bs, 1, h, w), device=device),
        max_w=torch.full((bs, 1, h, w), _NEG_INF, device=device),
    )


def progressive_kernel_apply(data, kernels, state, splat=True, valid=None):
    """Add one sample's kernel-weighted contribution to the running sums.

    Args:
      data: ``[bs, c, h, w]`` this sample's values.
      kernels: ``[bs, k2, h, w]`` raw splat-kernel logits.
      state: ``ProgressiveState`` (start from :func:`progressive_init`).
      splat: must be True: the kernels are splat kernels, applied through
        the fused splat step.
      valid: optional ``[bs]`` bool; an invalid sample leaves its batch
        item's state whole.

    Returns:
      The updated ``ProgressiveState``.
    """
    if not splat:
        raise NotImplementedError(
            "splat=False (gather kernels) needs the kernel-weighting and "
            "scatter2gather kernels, which come with slice 3")
    new_state = ProgressiveState(*ops.progressive_splat_update(
        data, kernels, state.sum_r, state.sum_w, state.max_w))
    if valid is None:
        return new_state
    v = valid.reshape(-1, 1, 1, 1)
    return ProgressiveState(*(torch.where(v, new, old)
                              for new, old in zip(new_state, state)))
