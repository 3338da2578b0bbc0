"""One module an architecture (``arch`` in a configuration file): how the
benchmark builds the program's model, makes its inputs and counts its
work. Shared here: loading the seed's weights into the program."""

import importlib

import torch

from benchmark.reference.names import program_name

__all__ = ["load", "build"]


def load(name):
    """The module of architecture ``name``."""
    return importlib.import_module("benchmark.arch." + name)


def build(cls, cfg, params, device):
    """The program's model ``cls(**cfg["model"])`` on ``device`` holding
    ``params`` (reference names); built on the meta device, so no
    parameter is initialised on the host."""
    with torch.device("meta"):
        net = cls(**cfg["model"])
    net = net.to_empty(device=device)
    state = {program_name(k): v for k, v in params.items()}
    net.load_state_dict(state, strict=True)
    return net
