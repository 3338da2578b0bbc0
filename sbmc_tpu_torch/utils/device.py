"""Device selection for the port's entry points."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda"):
    """Return ``torch.device(device)``; raises if a CUDA device was asked for
    and none is available (the entry points never carry on on the CPU
    unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev
