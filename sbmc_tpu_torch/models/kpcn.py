"""KPCN per-pixel baseline denoiser (counterpart of
``sbmc_tpu/models/kpcn.py``; Bako et al. 2017).

Two independent 9-layer, width-100, 5x5 valid-conv chains predict 21x21
gather kernels for the diffuse and specular streams; the kernels are
softmax-normalised and applied as gathers, then the streams are recombined
as ``albedo * diffuse + (exp(specular) - 1)``.

At inference on the card a bf16 KPCN runs its chains channels-last
(:meth:`KPCN.forward_channels_last`): every tensor between the input and
the normalised kernels is a dense channels-last bf16 tensor whose channels
are padded with zeros to an aligned width (:func:`padded_width`), each
convolution is cuDNN's on weights padded with zeros, and the hand-written
kernels of :mod:`sbmc_tpu_torch.nn.kpcn_layout` and
:func:`sbmc_tpu_torch.nn.unet.epilogue` do the rest, softmax included.

While tracing is on (:mod:`sbmc_tpu_torch.tracing`) a call is the span
``kpcn.forward``, with ``kpcn.diffuse``, ``kpcn.specular`` (the chains; on
the channels-last path with the softmax) and ``kpcn.apply`` (the gathers
and the recombination; on the NCHW path with the softmax) under it.
"""

import torch
import torch.nn as nn

from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.nn import kpcn_layout, layers, unet
from sbmc_tpu_torch.nn.kernel_apply import kernel_apply
from sbmc_tpu_torch.nn.layers import ConvChain, dtype_of
from sbmc_tpu_torch.utils.image import crop_like

__all__ = ["KPCN", "padded_width"]


def padded_width(c):
    """The channel count a tensor of ``c`` channels is padded to on the
    channels-last path: the next multiple of 32 (27 -> 32, 100 -> 128,
    441 -> 448). On an H100, cuDNN's channels-last convolutions at KPCN's
    1160x2000 tile ran a chain 2.1x faster at width 128 than at 104 and
    1.7x faster than at 112 (``PERF.md``, the width table)."""
    return -(-c // 32) * 32


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

    Where :func:`~sbmc_tpu_torch.nn.layers.kernel_path` says so
    (``kernels_fit``: a padded prediction the exit kernel holds),
    :meth:`forward` runs :meth:`forward_channels_last`, which launches the
    entry kernel and the exit kernel once a chain and the epilogue kernel
    once a convolution but the prediction (2, 2 and 16 a call at depth 9).
    """

    #: The entry and exit kernels have no backward: inference only.
    kernels_backward = False

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
        self.kernels_fit = (
            padded_width(ksize * ksize) <= kpcn_layout.MAX_EXIT_CHANNELS
            and all(c.activation in unet.ACTIVATIONS
                    and c.output_type == "linear"
                    for c in (self.diffuse, self.specular)))

    def forward(self, data):
        if layers.kernel_path(self, data["kpcn_diffuse_in"]):
            return self.forward_channels_last(data)
        # The inputs may arrive float16 (halved host->device transfer).
        dt = self.conv_dtype or torch.float32
        return self._forward(data, lambda chain, x: chain(x.to(dt)),
                             softmax=True)

    def forward_channels_last(self, data):
        """:meth:`forward` without gradients, each chain channels-last
        (:meth:`chain_channels_last`) up to its normalised kernels. The same
        arithmetic and roundings as :meth:`forward`, up to the order of the
        convolutions' and the softmax's sums."""
        return self._forward(data, self.chain_channels_last, softmax=False)

    def chain_channels_last(self, chain, x):
        """``chain`` on its NCHW input ``x`` without gradients: ``x`` laid
        out channels-last in the compute dtype (``kpcn_layout.kpcn_entry``),
        each hidden layer as ``ConvChain``'s channels-last step
        (``WNConv2D.forward_channels_last``), the prediction's convolution,
        then its bias and the softmax over its ``k2`` taps, laid out NCHW
        (``kpcn_layout.kpcn_exit``); every width padded. Pad channels stay
        exactly zero: their weights and biases are zero."""
        x = kpcn_layout.kpcn_entry(x, padded_width(x.shape[1]),
                                   self.conv_dtype or torch.float32)
        for layer in chain.layers()[:-1]:
            x = layer.forward_channels_last(x, chain.activation,
                                            padded_width(layer.v.shape[1]),
                                            padded_width(layer.v.shape[0]))
        pred = chain.prediction
        k2 = pred.v.shape[0]
        return kpcn_layout.kpcn_exit(
            pred.conv_channels_last(x, padded_width(pred.v.shape[1]),
                                    padded_width(k2)), pred.bias, k2)

    def _forward(self, data, run_chain, softmax):
        h, w = data["kpcn_diffuse_in"].shape[-2:]
        shrink = self.depth * 4  # depth valid 5x5 convs
        if h - shrink <= 0 or w - shrink <= 0:
            raise ValueError(
                "KPCN with depth=%d needs inputs larger than %dx%d "
                "(got %dx%d): the valid convolutions consume a %d-pixel "
                "border." % (self.depth, shrink, shrink, h, w, shrink // 2))

        with tracing.span("kpcn.forward", data["kpcn_diffuse_in"]):
            with tracing.span("kpcn.diffuse"):
                k_diffuse = run_chain(self.diffuse, data["kpcn_diffuse_in"])
            with tracing.span("kpcn.specular"):
                k_specular = run_chain(self.specular,
                                       data["kpcn_specular_in"])

            with tracing.span("kpcn.apply"):
                b_diffuse = crop_like(data["kpcn_diffuse_buffer"].float(),
                                      k_diffuse)
                b_specular = crop_like(data["kpcn_specular_buffer"].float(),
                                       k_specular)
                r_diffuse, _ = kernel_apply(b_diffuse, k_diffuse,
                                            softmax=softmax, splat=False)
                r_specular, _ = kernel_apply(b_specular, k_specular,
                                             softmax=softmax, splat=False)
                albedo = crop_like(data["kpcn_albedo"], r_diffuse)
                final_radiance = (albedo * r_diffuse
                                  + (torch.exp(r_specular) - 1))
        return {"radiance": final_radiance, "diffuse": r_diffuse,
                "specular": r_specular}
