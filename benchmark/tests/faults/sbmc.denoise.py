"""Faults of a denoising cell of the sample-based splatting model."""

from benchmark.tests.faults import alter_radiance


def _state_unchanged(mp):
    """The splat step hands back the state it was given."""
    from sbmc_tpu_torch import ops
    mp.setattr(ops, "progressive_splat_update",
               lambda data, klogits, r, w, m: (r, w, m))


def _half_batch(mp):
    """Half of a frame's samples left out, the mean taken over the
    rest."""
    from sbmc_tpu_torch.models import Multisteps
    fwd = Multisteps.forward

    def half_samples(self, samples):
        spp = samples["radiance"].shape[1]
        cut = {k: v[:, :spp // 2] for k, v in samples.items()
               if k in ("radiance", "features", "sample_mask")}
        return fwd(self, dict(samples, **cut))

    mp.setattr(Multisteps, "forward", half_samples)


def _answer_altered(mp):
    from sbmc_tpu_torch.models import Multisteps
    alter_radiance(mp, Multisteps)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
