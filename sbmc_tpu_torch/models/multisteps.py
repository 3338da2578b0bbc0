"""The SBMC sample-based denoiser (counterpart of
``sbmc_tpu/models/multisteps.py``).

``Multisteps`` alternates per-sample 1x1-conv embeddings with a pixel-space
U-Net for ``nsteps`` rounds, then regresses a ``ksize x ksize`` splat kernel
per sample and accumulates the samples with the fused progressive splat
(or, with ``splat=False``, a gather kernel per sample, accumulated through
the composed kernel-weighting op).
A Python loop over samples takes the place of ``nn.scan``: the state
``(sum_r, sum_w, max_w)`` stays O(1) in the sample count.

The model trains as well as infers: the splat op is differentiable (its
backward runs the hand-written backward kernels on the card). With
``remat`` the embedding and propagation stacks recompute their activations
in the backward pass (``torch.utils.checkpoint``), as ``nn.remat`` does in
the JAX model.

Where :func:`~sbmc_tpu_torch.nn.layers.kernel_path` says so (on the card,
bf16 convs, ``kernels_fit``), the per-sample chains take hand-written
kernels. With gradients off each embedding step and each sample's kernel
regressor is one launch of the per-sample chain kernel
(:mod:`sbmc_tpu_torch.nn.sample_chain`): 3 + ``spp`` launches a call at
three steps. With gradients on they run on pixel-major matrices
(:mod:`sbmc_tpu_torch.nn.chain_train`): each embedding step is one autograd
Function of cuBLAS products and hand-written epilogues, the regressor one
over all samples, and the U-Nets read and write the chains' layout
(channels-last). With ``remat`` an embedding step's Function recomputes its
activations in the backward pass, as the plain stack does. Otherwise the
unfused modules run.

While tracing is on (:mod:`sbmc_tpu_torch.tracing`) a call is the span
``sbmc.forward``, with ``sbmc.embedding`` (the chain and the masked mean
over samples) and ``sbmc.propagation`` (the U-Net) a step and
``sbmc.regress`` and ``sbmc.splat`` a sample under it.
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.nn import chain_train, layers, sample_chain
from sbmc_tpu_torch.nn.kernel_apply import (progressive_init,
                                            progressive_kernel_apply)
from sbmc_tpu_torch.nn.layers import Autoencoder, ConvChain, dtype_of
from sbmc_tpu_torch.utils.image import crop_like

__all__ = ["Multisteps"]


class _KernelStage(nn.Module):
    """Holds the per-sample kernel regressor (flax path
    ``kernel_stage/kernel_regressor``)."""

    def __init__(self, in_features, k2, width, dtype):
        super().__init__()
        self.kernel_regressor = ConvChain(
            in_features, k2, depth=3, width=width, ksize=1,
            activation="leaky_relu", output_type="linear", dtype=dtype)


class Multisteps(nn.Module):
    """Sample-based kernel-splatting denoiser.

    Args:
      n_features: per-sample input feature count.
      n_global_features: global (per-scene) feature count.
      width: channels per conv layer.
      embedding_width: per-sample embedding channels.
      ksize: spatial extent of the square splat kernel (odd, >= 3).
      splat: if False, predicts gather kernels instead (ablation).
      nsteps: number of sample/pixel coordination steps.
      pixel: average the samples into a 1-spp image first (ablation).
      eps: normaliser epsilon of ``sum_r / (sum_w + eps)``.
      return_kernels: also return the per-sample kernel logits.
      conv_dtype: compute dtype of the conv stacks (e.g. "bfloat16"); the
        parameters stay float32 and the splat accumulates in float32.
      remat: recompute each embedding and propagation stack's activations
        in the backward pass instead of keeping them (less training memory
        for more compute; no effect without gradients).
      kernel_dtype: dtype of the logits fed to the splat (e.g. "bfloat16").

    Call with a dict:
      "radiance": ``[bs, spp, 3, h, w]``
      "features": ``[bs, spp, n_features, h, w]``
      "global_features": ``[bs, n_global_features, 1, 1]`` (or ``[bs, ngf]``)
      "sample_mask" (optional): ``[bs, spp]`` bool validity mask.

    Returns a dict with "radiance": ``[bs, 3, h - 2*o, w - 2*o]``,
    ``o = (ksize - 1) // 2``, and with ``return_kernels`` also "kernels":
    ``[bs, spp, ksize**2, h, w]``.
    """

    #: The per-sample chains have a training path (``nn/chain_train.py``).
    kernels_backward = True

    def __init__(self, n_features, n_global_features, width=128,
                 embedding_width=128, ksize=21, splat=True, nsteps=3,
                 pixel=False, eps=1e-8, return_kernels=False,
                 conv_dtype=None, remat=False, kernel_dtype=None):
        super().__init__()
        if ksize < 3 or ksize % 2 == 0:
            raise ValueError("Kernel size should be odd and > 3.")
        if nsteps < 1:
            raise ValueError("Multisteps requires at least one sample/pixel "
                             "step.")
        self.ksize = ksize
        self.splat = splat
        self.nsteps = nsteps
        self.pixel = pixel
        self.eps = eps
        self.return_kernels = return_kernels
        self.conv_dtype = dtype_of(conv_dtype)
        self.kernel_dtype = dtype_of(kernel_dtype)
        self.remat = remat
        # (features, global features, embedding width, width): the channels
        # the per-sample chains take.
        self._chain_channels = (n_features, n_global_features,
                                embedding_width, width)
        for step in range(nsteps):
            cin = (n_features + n_global_features if step == 0
                   else embedding_width + width)
            self.add_module(f"embedding_{step:02d}", ConvChain(
                cin, embedding_width, width=width, depth=3, ksize=1,
                dtype=self.conv_dtype))
            self.add_module(f"propagation_{step:02d}", Autoencoder(
                embedding_width, width, num_levels=3, increase_factor=2.0,
                num_convs=3, width=width, ksize=3, output_type="leaky_relu",
                dtype=self.conv_dtype))
        self.kernel_stage = _KernelStage(embedding_width + width,
                                         ksize * ksize, width,
                                         self.conv_dtype)

    def _remat(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass with ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _stack(self, name, x):
        return self._remat(getattr(self, name), x)

    @property
    def kernels_fit(self):
        """Whether the per-sample chain kernel holds every embedding step
        and the kernel regressor, and the training path's kernels their
        widths (multiples of 8; the entry's row at most
        ``chain_train.MAX_ENTRY`` channels). Asks the CUDA build, loading it
        (building it on first use): only ``layers.kernel_path`` reads this,
        last."""
        nf, ngf, ew, w = self._chain_channels
        return (ew % 8 == 0 and w % 8 == 0
                and chain_train.pad8(nf + ngf) <= chain_train.MAX_ENTRY
                and sample_chain.embedding_fits(self.embedding_00, nf, ngf,
                                                False)
                and all(sample_chain.embedding_fits(
                    getattr(self, f"embedding_{s:02d}"), ew, w, True)
                    for s in range(1, self.nsteps))
                and sample_chain.regress_fits(
                    self.kernel_stage.kernel_regressor, ew + w))

    def forward(self, samples):
        with tracing.span("sbmc.forward", samples["features"]):
            return self._forward(samples)

    def _forward(self, samples):
        radiance = samples["radiance"].float()
        # Features may arrive float16 (halved host->device transfer); the
        # training path's entry casts them as it lays them out.
        features = samples["features"]
        dtype = self.conv_dtype or torch.float32
        fused = layers.kernel_path(self, features)
        train = fused and torch.is_grad_enabled()
        if not train or self.pixel:
            features = features.to(dtype)
        gfeatures = samples["global_features"]
        mask = samples.get("sample_mask", None)
        bs, spp, _, h, w = features.shape

        if mask is None:
            mask_f = torch.ones((bs, spp), dtype=dtype,
                                device=features.device)
        else:
            mask_f = mask.to(dtype)
        n_valid = mask_f.sum(dim=1).clamp(min=1.0)  # [bs]

        if self.pixel:
            # Collapse the samples to a 1-spp masked mean.
            m = mask_f[:, :, None, None, None]
            nv = n_valid[:, None, None, None, None]
            radiance = (radiance * m).sum(dim=1, keepdim=True) / nv
            features = (features * m).sum(dim=1, keepdim=True) / nv
            spp, mask = 1, None
            mask_f = torch.ones((bs, 1), dtype=features.dtype,
                                device=features.device)
            n_valid = torch.ones((bs,), dtype=features.dtype,
                                 device=features.device)

        gf = gfeatures.reshape(bs, -1, 1, 1).to(dtype)
        if train:
            logits = self._train_chains(features, gf, mask_f, n_valid)
        else:
            feats, propagated = self._embed(fused, features, gf, mask_f,
                                            n_valid)

        regressor = self.kernel_stage.kernel_regressor
        weights = None
        state = progressive_init(bs, radiance.shape[2], h, w,
                                 radiance.device)
        kernels_out = []
        for s in range(spp):
            if train:
                kernels = logits[s].to(self.kernel_dtype or dtype)
            else:
                with tracing.span("sbmc.regress"):
                    if fused:
                        weights = weights or sample_chain.regressor_weights(
                            regressor)
                        kernels = sample_chain.regress(
                            regressor, feats[:, s], propagated,
                            self.kernel_dtype, weights)
                    else:
                        kernels = sample_chain.regress_ref(
                            regressor, feats[:, s], propagated,
                            self.kernel_dtype)
            with tracing.span("sbmc.splat"):
                data = crop_like(radiance[:, s], kernels).contiguous()
                state = progressive_kernel_apply(
                    data, kernels, state, splat=self.splat,
                    valid=None if mask is None else mask[:, s])
            if self.return_kernels:
                kernels_out.append(kernels)

        output = state.sum_r / (state.sum_w + self.eps)
        crop = (self.ksize - 1) // 2
        out = {"radiance": output[..., crop:-crop, crop:-crop]}
        if self.return_kernels:
            out["kernels"] = torch.stack(kernels_out, dim=1)
        return out

    def _embed(self, fused, feats, gf, mask_f, n_valid):
        """The embedding steps and the U-Nets (the chain kernel with
        ``fused``, else the plain modules): the last step's per-sample
        features and the last U-Net's output."""
        propagated = None
        for step in range(self.nsteps):
            name = f"embedding_{step:02d}"
            extra = gf if step == 0 else propagated
            with tracing.span("sbmc.embedding"):
                if fused:
                    feats, reduced = sample_chain.embedding_step(
                        getattr(self, name), feats, extra, mask_f, n_valid)
                else:
                    feats, reduced = sample_chain.embedding_step_ref(
                        getattr(self, name), feats, extra, mask_f, n_valid,
                        run=lambda x, name=name: self._stack(name, x))
            with tracing.span("sbmc.propagation"):
                propagated = self._stack(f"propagation_{step:02d}", reduced)
        return feats, propagated

    def _train_chains(self, features, gf, mask_f, n_valid):
        """The embedding steps, the U-Nets and the regressor under gradients
        on the card (:mod:`~sbmc_tpu_torch.nn.chain_train`): the chains on
        pixel-major matrices, each U-Net on the step's mean as a
        channels-last tensor. Returns each sample's logits (in the conv
        dtype). Spans as :meth:`forward`'s, the regressor's once for all
        samples."""
        bs, spp, nf, h, w = features.shape
        x = chain_train.entry(features, gf.reshape(bs, -1),
                              chain_train.pad8(nf + gf.shape[1]), gf.dtype)
        e = None
        for step in range(self.nsteps):
            with tracing.span("sbmc.embedding"):
                x, reduced = self._remat(
                    chain_train.embedding_step,
                    getattr(self, f"embedding_{step:02d}"), x, e, mask_f,
                    n_valid)
            with tracing.span("sbmc.propagation"):
                c = reduced.shape[-1]
                propagated = self._stack(
                    f"propagation_{step:02d}",
                    reduced.view(bs, h, w, c).permute(0, 3, 1, 2))
            e = propagated.permute(0, 2, 3, 1).reshape(bs, h * w, -1)
        with tracing.span("sbmc.regress"):
            return chain_train.regress(self.kernel_stage.kernel_regressor,
                                       x, e, (h, w))
