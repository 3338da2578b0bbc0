"""Microbenchmark of the kernel-weighting op, forward and forward plus
backward (counterpart of ``scripts/profile/kernel_weighting.py``).

    python -m sbmc_tpu_torch.profile_kernel_weighting [--bs 4] \\
        [--size 128] [--ksize 21] [--iters 20] [--warmup 5] \\
        [--backend kernel|plain] [--device cuda]

Data ``[bs, 3, size, size]`` and weights ``[bs, ksize^2, size, size]``,
float32, from ``RandomState(0)`` as the JAX script draws them. ``forward``
is ``ops.kernel_weighting``; ``fwd+bwd`` takes the gradients of the
output's sum to the data and to the weights. With ``--backend kernel``
(the default) these are the hand-written kernels: on the card the forward
launches ``kw_fwd``, and the backward ``scatter2gather`` and ``kw_fwd`` for
the data's gradient and ``kw_dw`` for the weights'. ``--backend plain``
times the plain PyTorch versions (autograd through
``ops.reference.kernel_weighting_ref``), a yardstick the caller names: it
is never taken in the kernels' place. Each is called once and ``--warmup``
times, then timed over ``--iters`` calls between two CUDA events (on the
CPU, on the host clock); the lines give ms a call and GB/s of the
weights' and data's bytes. Runs on ``--device cuda`` unless told
otherwise, and raises when that device is missing.
"""

import argparse

import numpy as np
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.timing import elapsed_ms

__all__ = ["main", "parse_args", "time_call"]


def time_call(fn, device, warmup, iters):
    """Seconds a call of ``fn`` after one call and ``warmup`` more."""
    fn()
    for _ in range(warmup):
        fn()
    return elapsed_ms(fn, device, iters) / 1e3


def _nbytes(t):
    return t.numel() * t.element_size()


def main(argv=None):
    """Returns ``{name: seconds a call}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(args.bs, 3, args.size, args.size)
                            .astype(np.float32)).to(device)
    wts = torch.from_numpy(rng.randn(args.bs, args.ksize ** 2, args.size,
                                     args.size).astype(np.float32)).to(device)
    kw = (ops.kernel_weighting if args.backend == "kernel"
          else ops.reference.kernel_weighting_ref)

    def fwd():
        with torch.no_grad():
            return kw(data, wts)

    def bwd():
        d = data.detach().requires_grad_()
        w = wts.detach().requires_grad_()
        return torch.autograd.grad(kw(d, w)[0].sum(), (d, w))

    times = {}
    for name, fn in (("forward", fwd), ("fwd+bwd", bwd)):
        dt = time_call(fn, device, args.warmup, args.iters)
        traffic = (_nbytes(wts) + _nbytes(data)) / 1e9
        print(f"kernel_weighting {name}: {dt * 1e3:.3f} ms "
              f"({traffic / dt:.0f}+ GB/s)")
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
                        help="the hand-written kernels (default) or the "
                        "plain PyTorch versions.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
