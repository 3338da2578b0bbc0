"""Kernel application operators (counterpart of
``sbmc_tpu/nn/kernel_apply.py``).

``kernel_apply`` is the one-shot version (used by KPCN): optional
splat-to-gather transpose, optional softmax over the taps, then kernel
weighting. ``progressive_kernel_apply`` adds one sample's contribution to
the running online-softmax state ``(sum_r, sum_w, max_w)``, so the SBMC model's
memory stays O(1) in the sample count. A state starting at
``max_w = -1e30`` makes the first update reproduce the reference's separate
initialisation step exactly. Splat kernels go through the fused splat step;
gather kernels (``splat=False``), or ``fused=False``, through the composed
ops: transpose, tap max, rescale, ``exp``, kernel weighting. The update is
differentiable: gradients flow to the sample's data and kernels and to the
incoming sums; the fused step gives none to the running max.
"""

from typing import NamedTuple

import torch

from sbmc_tpu_torch import ops

__all__ = ["KernelApply", "ProgressiveKernelApply", "ProgressiveState",
           "kernel_apply", "progressive_init", "progressive_kernel_apply"]

_NEG_INF = -1e30  # finite stand-in for -inf: exp(x - _NEG_INF) == 0 in f32


class ProgressiveState(NamedTuple):
    """Running accumulators of the progressive (online softmax) apply."""
    sum_r: torch.Tensor  # [bs, c, h, w]
    sum_w: torch.Tensor  # [bs, 1, h, w]
    max_w: torch.Tensor  # [bs, 1, h, w]


def kernel_apply(data, kernels, softmax=True, splat=True):
    """Apply per-pixel kernels to data.

    Args:
      data: ``[bs, c, h, w]``.
      kernels: ``[bs, k2, h, w]`` flat kernels.
      softmax: softmax-normalise the contributions per output pixel.
      splat: if True the kernels are splat kernels; they are transposed to
        gather form before application.

    Returns:
      ``(output [bs, c, h, w], sum_w [bs, 1, h, w])``.
    """
    kernels = kernels.contiguous()
    if splat:
        kernels = ops.scatter2gather(kernels)
    if softmax:
        kernels = torch.softmax(kernels, dim=1)
    output, sum_w = ops.kernel_weighting(data.contiguous(), kernels)
    return output, sum_w[:, None]


def progressive_init(bs, c, h, w, device=None):
    """Zero-initialised float32 state (``max_w = -1e30``)."""
    return ProgressiveState(
        sum_r=torch.zeros((bs, c, h, w), device=device),
        sum_w=torch.zeros((bs, 1, h, w), device=device),
        max_w=torch.full((bs, 1, h, w), _NEG_INF, device=device),
    )


def progressive_kernel_apply(data, kernels, state, splat=True, valid=None,
                             fused=True):
    """Add one sample's kernel-weighted contribution to the running sums.

    The final reconstruction is ``state.sum_r / state.sum_w``; kernels are
    softmax-normalised across all taps of all samples through the running
    max.

    Args:
      data: ``[bs, c, h, w]`` this sample's values.
      kernels: ``[bs, k2, h, w]`` raw kernel logits.
      state: ``ProgressiveState`` (start from :func:`progressive_init`).
      splat: the kernels are splat kernels (transposed to gather form
        first); False: they are gather kernels already.
      valid: optional ``[bs]`` bool; an invalid sample contributes exactly
        zero and leaves its batch item's state whole.
      fused: with ``splat``, take the fused splat step (one pass over the
        kernels) instead of the composed ops.

    Returns:
      The updated ``ProgressiveState``.
    """
    if splat and fused:
        new_state = ProgressiveState(*ops.progressive_splat_update(
            data, kernels, state.sum_r, state.sum_w, state.max_w))
        if valid is None:
            return new_state
        v = valid.reshape(-1, 1, 1, 1)
        return ProgressiveState(*(torch.where(v, new, old)
                                  for new, old in zip(new_state, state)))

    if splat:
        kernels = ops.scatter2gather(kernels)
    if valid is not None:
        kernels = torch.where(valid.reshape(-1, 1, 1, 1), kernels, _NEG_INF)
    kmax = kernels.amax(dim=1, keepdim=True)  # [bs, 1, h, w]
    new_max = torch.maximum(kmax, state.max_w)
    scaler = torch.exp(state.max_w - new_max)
    kexp = torch.exp(kernels - new_max)
    new_r, new_w = ops.kernel_weighting(data, kexp)
    return ProgressiveState(sum_r=state.sum_r * scaler + new_r,
                            sum_w=state.sum_w * scaler + new_w[:, None],
                            max_w=new_max)


class KernelApply:
    """Object-style wrapper of :func:`kernel_apply`."""

    def __init__(self, softmax=True, splat=True):
        self.softmax = softmax
        self.splat = splat

    def __call__(self, data, kernels):
        return kernel_apply(data, kernels, softmax=self.softmax,
                            splat=self.splat)


class ProgressiveKernelApply:
    """Object-style wrapper of :func:`progressive_kernel_apply`.

    Call with ``state=None`` for the first sample (initialisation), then
    thread the returned state through the next calls.
    """

    def __init__(self, splat=False):
        self.splat = splat

    def __call__(self, data, kernels, state=None, valid=None):
        if state is None:
            bs, c, h, w = data.shape
            state = progressive_init(bs, c, h, w, data.device)
        return progressive_kernel_apply(data, kernels, state,
                                        splat=self.splat, valid=valid)
