"""Model construction from checkpoint metadata, so inference needs no flags
(counterpart of ``sbmc_tpu/models/build.py``)."""

from sbmc_tpu_torch.models.multisteps import Multisteps

__all__ = ["build_model"]


def build_model(meta):
    """Instantiate the model described by a checkpoint ``meta`` dict.

    Only the SBMC ``Multisteps`` model is ported; KPCN and LBF come with
    slice 3 and raise ``NotImplementedError`` here.
    """
    params = dict(meta["model_params"])
    arch = meta.get("arch")
    if arch is None:  # round-1 checkpoints carry only kpcn_mode
        arch = "kpcn" if meta.get("kpcn_mode", False) else "sbmc"
    if arch in ("kpcn", "lbf"):
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (slice 3: KPCN and LBF)")
    if arch != "sbmc":
        raise ValueError(f"unknown arch {arch!r}")
    return Multisteps(**params)
