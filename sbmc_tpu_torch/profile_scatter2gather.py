"""Microbenchmark of the scatter2gather op, forward and forward plus
backward (counterpart of ``scripts/profile/scatter2gather.py``).

    python -m sbmc_tpu_torch.profile_scatter2gather [--bs 4] [--size 128] \\
        [--ksize 21] [--iters 20] [--warmup 5] [--backend kernel|plain] \\
        [--device cuda]

Weights ``[bs, ksize^2, size, size]``, float32, from ``RandomState(0)`` as
the JAX script draws them. ``forward`` is ``ops.scatter2gather``;
``fwd+bwd`` the gradient of its output's sum, which on the card launches
the ``scatter2gather`` kernel twice (the transpose is its own adjoint).
``--backend plain`` times autograd through
``ops.reference.scatter2gather_ref`` instead, a yardstick the caller names.
Timing as ``profile_kernel_weighting``; GB/s count the weights read and
the transpose written. Runs on ``--device cuda`` unless told otherwise,
and raises when that device is missing.
"""

import argparse

import numpy as np
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.profile_kernel_weighting import time_call
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["main", "parse_args"]


def main(argv=None):
    """Returns ``{name: seconds a call}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    wts = torch.from_numpy(rng.randn(args.bs, args.ksize ** 2, args.size,
                                     args.size).astype(np.float32)).to(device)
    s2g = (ops.scatter2gather if args.backend == "kernel"
           else ops.reference.scatter2gather_ref)

    def fwd():
        with torch.no_grad():
            return s2g(wts)

    def bwd():
        w = wts.detach().requires_grad_()
        return torch.autograd.grad(s2g(w).sum(), w)

    nbytes = wts.numel() * wts.element_size()
    times = {}
    for name, fn in (("forward", fwd), ("fwd+bwd", bwd)):
        dt = time_call(fn, device, args.warmup, args.iters)
        print(f"scatter2gather {name}: {dt * 1e3:.3f} ms "
              f"({2 * nbytes / 1e9 / dt:.0f} GB/s)")
        times[name] = dt
    return times


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bs", type=int, default=4)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--ksize", type=int, default=21)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--backend", default="kernel",
                        choices=["kernel", "plain"],
                        help="the hand-written kernel (default) or the "
                        "plain PyTorch version.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
