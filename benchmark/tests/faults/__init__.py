"""Faults planted in the program underneath a whole run, one file an
architecture and traffic kind: ``faults/<arch>.<kind>.py`` holds
``FAULTS``, ``{name: plant(monkeypatch)}``, the faults that such a cell
can have. Shared plantings live here."""

import importlib.util
import os

import torch

__all__ = ["load", "alter_radiance", "train_state_unchanged",
           "train_half_batch", "train_loss_altered", "train_grad_flipped"]


def load(arch, kind):
    """``FAULTS`` of ``faults/<arch>.<kind>.py``."""
    path = os.path.join(os.path.dirname(__file__), "%s.%s.py" % (arch, kind))
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.tests.faults._%s_%s" % (arch, kind), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.FAULTS


def alter_radiance(mp, cls):
    """An answer changed where it is made: an 8x8 corner of each denoised
    tile of model class ``cls``."""
    orig = cls.forward

    def fwd(self, x):
        out = dict(orig(self, x))
        r = out["radiance"].clone()
        r[..., :8, :8] += 0.5
        out["radiance"] = r
        return out

    mp.setattr(cls, "forward", fwd)


def _interface():
    from sbmc_tpu_torch.train.interface import DenoiserInterface
    return DenoiserInterface


def train_state_unchanged(mp):
    """The optimiser step hands back the parameters it was given."""
    cls = _interface()
    step = cls.train_step

    def frozen(self, batch):
        before = [p.detach().clone() for p in self.model.parameters()]
        out = step(self, batch)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return out

    mp.setattr(cls, "train_step", frozen)


def train_half_batch(mp):
    """Half of each batch's tiles left out, the mean taken over the
    rest."""
    cls = _interface()
    step = cls.train_step

    def half_tiles(self, batch):
        n = batch["radiance"].shape[0]
        return step(self, {k: v[:n // 2] for k, v in batch.items()})

    mp.setattr(cls, "train_step", half_tiles)


def train_loss_altered(mp):
    """Each step's reported loss changed where it is made."""
    cls = _interface()
    step = cls.train_step

    def altered(self, batch):
        out = dict(step(self, batch))
        out["loss"] = out["loss"] * 1.05
        return out

    mp.setattr(cls, "train_step", altered)


def train_grad_flipped(mp):
    """The clipped gradients reach the optimiser with their signs
    flipped: a wrong backward whose norms are right."""
    cls = _interface()
    clip = cls._clip_gradients

    def flipped(self):
        clip(self)
        torch._foreach_neg_([p.grad for p in self.model.parameters()
                             if p.grad is not None])

    mp.setattr(cls, "_clip_gradients", flipped)
