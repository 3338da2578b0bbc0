"""Wall time of work on a device, for the port's benchmarks and profiles."""

import time

import torch

__all__ = ["elapsed_ms"]


def elapsed_ms(fn, device, iters=1):
    """Mean milliseconds of ``iters`` calls of ``fn``: between two CUDA
    events on a CUDA device (the calls' device work, whatever the host
    enqueued before), else on the host clock."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
