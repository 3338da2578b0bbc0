"""Where the flagship forward spends its device time.

    python -m sbmc_tpu_torch.profile [--checkpoint weights/flagship_f16] \\
        [--size 1080x2048] [--spp 4]

Builds the checkpoint's model on the GPU, runs one tile of random inputs
once to warm up, then once under ``torch.profiler``, and prints the wall
time, the device's busy share of it, device time by kernel class
(convolutions and GEMMs, the splat kernel, elementwise and copies, other)
and the top kernels by device time.
"""

import argparse
import time

import torch

from sbmc_tpu_torch.denoise import load_model
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["classify", "main"]

_CONV = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgmma", "sm90",
         "implicit", "winograd", "fft")
_ELEMENTWISE = ("elementwise", "vectorized", "copy", "cat", "reduce",
                "pool", "upsample", "index", "fill", "memcpy", "memset")


def classify(name):
    """Kernel class of a device event name."""
    low = name.lower()
    if "psf_kernel" in low:
        return "splat kernel"
    if any(k in low for k in _CONV):
        return "conv/gemm"
    if any(k in low for k in _ELEMENTWISE):
        return "elementwise/copy"
    return "other"


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="weights/flagship_f16")
    p.add_argument("--size", default="1080x2048",
                   help="tile height x width")
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    h, w = (int(v) for v in args.size.split("x"))
    dev = resolve_device("cuda")
    model, meta, _ = load_model(args.checkpoint, dev)
    nf = meta["model_params"]["n_features"]
    ngf = meta["model_params"]["n_global_features"]
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {
        "radiance": torch.rand(1, args.spp, 3, h, w, device=dev,
                               generator=gen),
        "features": torch.rand(1, args.spp, nf, h, w, device=dev,
                               generator=gen).half(),
        "global_features": torch.rand(1, ngf, 1, 1, device=dev,
                                      generator=gen)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, kernels = {}, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us, evt.count, evt.key))
        cls = classify(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = sum(by_class.values()) / 1e3
    print("%s: %dx%d tile, %d spp: wall %.2f ms (profiled), device busy "
          "%.2f ms (%.1f%%)" % (torch.cuda.get_device_name(0), h, w,
                                args.spp, wall_ms, busy_ms,
                                100 * busy_ms / wall_ms))
    if not kernels:
        print("the profiler recorded no device time")
        return
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-17s %9.2f ms  %5.1f%%" % (cls, us / 1e3,
                                              100 * us / 1e3 / busy_ms))
    print("top kernels (device ms, launches, name):")
    for us, count, key in sorted(kernels, reverse=True)[:args.top]:
        print("  %9.2f  %5d  %s" % (us / 1e3, count, key[:110]))


if __name__ == "__main__":
    main()
