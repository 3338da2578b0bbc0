"""Random weights of a configuration, made on the device from the seed.

One ``torch.rand`` call of a device ``torch.Generator`` draws every
parameter's numbers at once; each leaf then takes its slice: a kernel
``w`` uniform in Xavier's bound ``gain * sqrt(6 / (fan_in + fan_out))``, a
weight-norm scale ``g`` of 0.75 to 1.25 times its kernel's norm per output
channel, a bias uniform in [-0.1, 0.1]. The weights are float32, as the
program keeps its parameters; both sides get the same ones.
"""

import math

import torch

from benchmark.reference.models import leaves

__all__ = ["make"]


def make(cfg, seed, device):
    """``{reference name: tensor}`` for configuration ``cfg``."""
    spec = leaves(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    params, kernels, at = {}, {}, 0
    for (name, shape, gain, kind), n in zip(spec, sizes):
        u = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            rf = math.prod(shape[2:])
            bound = gain * math.sqrt(6.0 / (shape[0] * rf + shape[1] * rf))
            params[name] = (2 * u - 1) * bound
            kernels[name[:-2]] = params[name]
        elif kind == "g":
            norm = kernels[name[:-2]].flatten(1).norm(dim=1)
            params[name] = norm * (0.75 + 0.5 * u)
        else:
            params[name] = (2 * u - 1) * 0.1
    return params
