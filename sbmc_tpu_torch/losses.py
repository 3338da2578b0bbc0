"""Loss functions and metrics (counterpart of ``sbmc_tpu/losses.py``).

All losses are plain functions over tensors; class-style wrappers mirror
the JAX package's names.
"""

import torch

from sbmc_tpu_torch.utils.image import tonemap

__all__ = ["relative_mse", "smape", "tonemapped_mse",
           "tonemapped_relative_mse",
           "RelativeMSE", "SMAPE", "TonemappedMSE", "TonemappedRelativeMSE"]


def relative_mse(im, ref, eps=1e-2):
    """0.5 * mean((im - ref)^2 / (ref^2 + eps))."""
    mse = (im - ref) ** 2
    return 0.5 * torch.mean(mse / (ref ** 2 + eps))


def smape(im, ref, eps=1e-2):
    """Symmetric mean absolute error; the denominator only scales the loss
    and contributes no gradient."""
    denom = eps + im.abs().detach() + ref.abs().detach()
    return torch.mean((im - ref).abs() / denom)


def tonemapped_mse(im, ref, eps=1e-2):
    im = tonemap(im)
    ref = tonemap(ref)
    return 0.5 * torch.mean((im - ref) ** 2)


def tonemapped_relative_mse(im, ref, eps=1e-2):
    """The training loss: relative MSE of the tonemapped images."""
    im = tonemap(im)
    ref = tonemap(ref)
    mse = (im - ref) ** 2
    return 0.5 * torch.mean(mse / (ref ** 2 + eps))


def _cls(fn):
    class _Loss:
        def __init__(self, eps=1e-2):
            self.eps = eps

        def __call__(self, im, ref):
            return fn(im, ref, eps=self.eps)
    return _Loss


RelativeMSE = _cls(relative_mse)
SMAPE = _cls(smape)
TonemappedMSE = _cls(tonemapped_mse)
TonemappedRelativeMSE = _cls(tonemapped_relative_mse)
