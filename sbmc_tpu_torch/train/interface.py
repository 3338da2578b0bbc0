"""Training interface: train/eval steps, optimizer, guards (counterpart of
``sbmc_tpu/train/interface.py``).

Adam(lr=1e-4), the tonemapped relative MSE as training loss, the relative
MSE as the reported metric, gradient-norm clipping at 1000 and a fail-fast
NaN/Inf loss guard. Where the JAX interface is functional (a ``TrainState``
goes in and comes out), this one is PyTorch's idiom: it owns the model, the
``torch.optim.Adam`` optimizer and the step count, and ``state_tree`` /
``load_state_tree`` carry them to and from the JAX package's checkpoint
layout.

With ``distributed=True`` the train step is data-parallel over the process
group (:mod:`sbmc_tpu_torch.parallel.mesh`), as JAX's step is over a mesh:
DDP averages the gradients in the backward, the clip then sees the global
gradient (as ``optax.clip_by_global_norm`` does on the mesh), and the
step's metrics are the global batch's means on every rank.
"""

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from sbmc_tpu_torch import losses as losses_mod
from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.parallel.mesh import all_mean
from sbmc_tpu_torch.params import (export_adam_state, export_jax_params,
                                   load_adam_state, load_jax_params)
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import crop_like

__all__ = ["DenoiserInterface"]

LOSS_FNS = {
    "tonemapped_relative_mse": losses_mod.tonemapped_relative_mse,
    "relative_mse": losses_mod.relative_mse,
    "smape": losses_mod.smape,
    "tonemapped_mse": losses_mod.tonemapped_mse,
}


class DenoiserInterface:
    """Runs train/eval steps for a denoiser model.

    Args:
      model: a module whose ``model(batch)`` returns a dict with "radiance".
        It is moved to ``device``.
      lr: Adam learning rate.
      loss: one of ``LOSS_FNS`` keys (default: the training loss).
      grad_clip: global-norm clip.
      device: torch device; a CUDA device that is missing raises.
      distributed: train data-parallel over the initialized process group
        (raises without one). ``model`` stays the bare module: checkpoints,
        exports, the display strip and ``eval_step`` use it and never enter
        a collective; only ``train_step``'s forward goes through the DDP
        wrapper.
    """

    def __init__(self, model, lr=1e-4, loss="tonemapped_relative_mse",
                 grad_clip=1000.0, device="cuda", distributed=False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self._ddp = None
        if distributed:
            # The models hold no buffers to broadcast, and every mode
            # (SBMC, --gather, --pixel, KPCN, LBF) gives every parameter a
            # gradient, so DDP need not search the graph for unused ones.
            self._ddp = DistributedDataParallel(
                self.model, broadcast_buffers=False,
                device_ids=[self.device] if self.device.type == "cuda"
                else None)
        self.loss_name = loss
        self.loss_fn = LOSS_FNS[loss]
        self.rmse_fn = losses_mod.relative_mse
        self.grad_clip = float(grad_clip)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def _losses(self, batch, net=None):
        net = self.model if net is None else net
        radiance = net(batch)["radiance"].float()
        tgt = crop_like(batch["target_image"], radiance)
        loss = self.loss_fn(radiance, tgt)
        with torch.no_grad():
            rmse = self.rmse_fn(radiance, tgt)
            base = self._input_baseline(batch, tgt)
        return loss, rmse, base

    def _input_baseline(self, batch, tgt):
        """Training-sanity reference: the loss of the trivial predictor
        (the masked per-pixel sample mean, i.e. the noisy input itself) on
        the same batch. A healthy run drops below it within a few hundred
        steps."""
        if "radiance" not in batch:
            return torch.zeros((), device=tgt.device)
        rad = batch["radiance"].float()
        if "sample_mask" in batch:
            m = batch["sample_mask"].float()[:, :, None, None, None]
            mean = (rad * m).sum(1) / m.sum(1).clamp(min=1.0)
        else:
            mean = rad.mean(1)
        return self.loss_fn(crop_like(mean, tgt), tgt)

    def _clip_gradients(self):
        """Global-norm clip with optax's arithmetic: gradients are left
        untouched while ``norm < grad_clip`` and become ``(g / norm) *
        grad_clip`` otherwise (``torch.nn.utils.clip_grad_norm_`` divides by
        ``norm + 1e-6`` instead). Stays on the device: no host read."""
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        clip = ~(norm < self.grad_clip)
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(grads, torch.where(clip, self.grad_clip * one,
                                               one))

    @staticmethod
    def _arrays_only(batch):
        """Drop non-array metadata (e.g. file paths)."""
        return {k: v for k, v in batch.items()
                if hasattr(v, "ndim") or np.isscalar(v)}

    def _to_device(self, batch):
        out = {}
        for k, v in self._arrays_only(batch).items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(self.device)
        return out

    def train_step(self, batch):
        """One optimization step on ``batch`` (a dict of numpy arrays or
        tensors). Returns a dict of 0-dim tensors on the device: read them a
        step late so the host does not wait on every step. Data-parallel,
        they are the global means, the same on every rank, so a non-finite
        loss stops every rank at the same step.

        While tracing is on the step is the span ``train.step``, with
        ``train.to_device``, ``train.forward`` (model, loss, metrics),
        ``train.backward``, ``train.clip`` and ``train.optimizer`` (twice:
        ``zero_grad`` before the forward, Adam after the clip) under it."""
        with tracing.span("train.step", self.device):
            with tracing.span("train.to_device"):
                batch = self._to_device(batch)
            self.model.train()
            with tracing.span("train.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            with tracing.span("train.forward"):
                loss, rmse, base = self._losses(batch, self._ddp)
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.clip"):
                self._clip_gradients()
            with tracing.span("train.optimizer"):
                self.optimizer.step()
            self.step += 1
            metrics = (loss.detach(), rmse, base)
            # Free the autograd graph inside the span: tearing down its
            # nodes is host time of the step, a millisecond or more.
            del loss
            if self._ddp is not None:
                metrics = all_mean(metrics)
        return dict(zip(("loss", "rmse", "input_loss"), metrics))

    def eval_step(self, batch):
        batch = self._to_device(batch)
        self.model.eval()
        with torch.no_grad():
            loss, rmse, base = self._losses(batch)
        return {"loss": loss, "rmse": rmse, "input_loss": base}

    @staticmethod
    def check_finite(metrics):
        """Fail fast on a NaN/Inf loss (the span ``train.check_finite``: the
        host's read of a step's loss)."""
        with tracing.span("train.check_finite", metrics["loss"]):
            loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(
                "Loss is not finite (%r), there might be outliers in the "
                "data." % loss)
        return loss

    def state_tree(self):
        """Parameters, Adam state and step as the JAX package's checkpoint
        tree (nested dicts of numpy arrays)."""
        return {"params": export_jax_params(self.model),
                "opt_state": export_adam_state(self.model, self.optimizer),
                "step": np.asarray(self.step, np.int32)}

    def load_state_tree(self, tree):
        """Load a checkpoint tree (in place); raises ``ValueError`` when it
        does not match the model."""
        load_jax_params(self.model, tree["params"])
        load_adam_state(self.model, self.optimizer, tree["opt_state"])
        self.step = int(np.asarray(tree["step"]))
