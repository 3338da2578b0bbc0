"""Model construction from checkpoint metadata, so inference needs no flags
(counterpart of ``sbmc_tpu/models/build.py``)."""

from sbmc_tpu_torch.models.kpcn import KPCN
from sbmc_tpu_torch.models.lbf import LBF
from sbmc_tpu_torch.models.multisteps import Multisteps

__all__ = ["build_model", "model_meta"]


def build_model(meta):
    """Instantiate the model described by a checkpoint ``meta`` dict
    (``arch``: "sbmc", "kpcn" or "lbf"); raises ``ValueError`` on another
    arch."""
    params = dict(meta["model_params"])
    arch = meta.get("arch")
    if arch is None:  # round-1 checkpoints carry only kpcn_mode
        arch = "kpcn" if meta.get("kpcn_mode", False) else "sbmc"
    models = {"sbmc": Multisteps, "kpcn": KPCN, "lbf": LBF}
    if arch not in models:
        raise ValueError(f"unknown arch {arch!r}")
    return models[arch](**params)


def model_meta(kpcn_mode, model_params, data_params, arch=None):
    """Assemble the meta dict persisted with checkpoints (the JAX package's
    layout, so either package's inference reads it)."""
    if arch is None:
        arch = "kpcn" if kpcn_mode else "sbmc"
    return {
        "arch": arch,
        "kpcn_mode": arch == "kpcn",
        "model_params": dict(model_params),
        "data_params": dict(data_params),
    }
