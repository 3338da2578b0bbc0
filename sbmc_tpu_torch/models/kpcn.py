"""KPCN per-pixel baseline denoiser (counterpart of
``sbmc_tpu/models/kpcn.py``; Bako et al. 2017).

Two independent 9-layer, width-100, 5x5 valid-conv chains predict 21x21
gather kernels for the diffuse and specular streams; the kernels are
softmax-normalised and applied as gathers, then the streams are recombined
as ``albedo * diffuse + (exp(specular) - 1)``.

While tracing is on (:mod:`sbmc_tpu_torch.tracing`) a call is the span
``kpcn.forward``, with ``kpcn.diffuse``, ``kpcn.specular`` (the chains) and
``kpcn.apply`` (the gathers and the recombination) under it.
"""

import torch
import torch.nn as nn

from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.models.multisteps import dtype_of
from sbmc_tpu_torch.nn.kernel_apply import kernel_apply
from sbmc_tpu_torch.nn.layers import ConvChain
from sbmc_tpu_torch.utils.image import crop_like

__all__ = ["KPCN"]


class KPCN(nn.Module):
    """Kernel-Predicting Convolutional Network baseline.

    Args:
      n_in: input channels of each stream.
      ksize: spatial extent of the predicted gather kernels (odd).
      depth: valid 5x5 convs per chain; they consume a ``2 * depth`` pixel
        border on every side.
      width: channels per conv layer.
      conv_dtype: compute dtype of the conv stacks (e.g. "bfloat16"); the
        parameters stay float32 and the kernels are applied in float32.

    Call with a dict (all CHW):
      "kpcn_diffuse_in":  ``[bs, n_in, h, w]``
      "kpcn_specular_in": ``[bs, n_in, h, w]``
      "kpcn_diffuse_buffer": ``[bs, 3, h, w]``
      "kpcn_specular_buffer": ``[bs, 3, h, w]``
      "kpcn_albedo": ``[bs, 3, h, w]``

    Returns a dict with "radiance", "diffuse", "specular" (all cropped to
    the valid conv output size).
    """

    def __init__(self, n_in=27, ksize=21, depth=9, width=100,
                 conv_dtype=None):
        super().__init__()
        self.ksize = ksize
        self.depth = depth
        self.conv_dtype = dtype_of(conv_dtype)
        for name in ("diffuse", "specular"):
            self.add_module(name, ConvChain(
                n_in, ksize * ksize, depth=depth, width=width, ksize=5,
                activation="relu", weight_norm=False, pad=False,
                output_type="linear", dtype=self.conv_dtype))

    def forward(self, data):
        h, w = data["kpcn_diffuse_in"].shape[-2:]
        shrink = self.depth * 4  # depth valid 5x5 convs
        if h - shrink <= 0 or w - shrink <= 0:
            raise ValueError(
                "KPCN with depth=%d needs inputs larger than %dx%d "
                "(got %dx%d): the valid convolutions consume a %d-pixel "
                "border." % (self.depth, shrink, shrink, h, w, shrink // 2))

        with tracing.span("kpcn.forward", data["kpcn_diffuse_in"]):
            # The inputs may arrive float16 (halved host->device transfer).
            dt = self.conv_dtype or torch.float32
            with tracing.span("kpcn.diffuse"):
                k_diffuse = self.diffuse(data["kpcn_diffuse_in"].to(dt))
            with tracing.span("kpcn.specular"):
                k_specular = self.specular(data["kpcn_specular_in"].to(dt))

            with tracing.span("kpcn.apply"):
                b_diffuse = crop_like(data["kpcn_diffuse_buffer"].float(),
                                      k_diffuse)
                b_specular = crop_like(data["kpcn_specular_buffer"].float(),
                                       k_specular)
                r_diffuse, _ = kernel_apply(b_diffuse, k_diffuse,
                                            softmax=True, splat=False)
                r_specular, _ = kernel_apply(b_specular, k_specular,
                                             softmax=True, splat=False)
                albedo = crop_like(data["kpcn_albedo"], r_diffuse)
                final_radiance = (albedo * r_diffuse
                                  + (torch.exp(r_specular) - 1))
        return {"radiance": final_radiance, "diffuse": r_diffuse,
                "specular": r_specular}
