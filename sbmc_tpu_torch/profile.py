"""Where the flagship forward, or a train step, spends its device time.

    python -m sbmc_tpu_torch.profile [--checkpoint weights/flagship_f16] \\
        [--size 1080x2048] [--spp 4]
    python -m sbmc_tpu_torch.profile --train [--bf16] [--size 128x128] \\
        [--spp 8] [--bs 4] [--arch sbmc|gather|kpcn|lbf]
    python -m sbmc_tpu_torch.profile --baseline nlm|cbf|rpf|nfor \\
        [--size 1080x2048] [--spp 4]

Builds the checkpoint's model on the GPU, runs one tile of random inputs
once to warm up, then once under ``torch.profiler``, and prints the wall
time, the device's busy share of it, device time by kernel class
(convolutions and GEMMs, the splat kernels, the optimizer, elementwise and
copies, other) and the top kernels by device time. With ``--train`` the
profiled unit is one optimization step of ``DenoiserInterface`` (forward,
loss, backward, clip, Adam) at the checkpoint's architecture on a random
batch with random sample masks; ``--bf16`` runs the conv stacks in bfloat16
as ``python -m sbmc_tpu_torch.train --bf16`` does, else they are float32.
``--arch`` picks the model as the train entry point's ``--gather``,
``--kpcn_mode`` and ``--lbf_mode`` do: the checkpoint's architecture with
gather kernels, KPCN at its published width on the 27-channel pixel
statistics, or LBF at its defaults; other than ``sbmc`` they start from
freshly initialised weights, with or without ``--train``. ``--baseline``
profiles one classical baseline of :mod:`sbmc_tpu_torch.comparisons` on a
frame of random sample records instead of a model.
"""

import argparse
import time

import torch

from sbmc_tpu_torch.comparisons import denoise_buffers
from sbmc_tpu_torch.denoise import load_model
from sbmc_tpu_torch.models import KPCN, LBF
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.train.interface import DenoiserInterface
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["classify", "main"]

_CONV = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgmma", "sm90",
         "implicit", "winograd", "fft", "wgrad", "dgrad", "fprop")
_ELEMENTWISE = ("elementwise", "vectorized", "copy", "cat", "reduce",
                "pool", "upsample", "index", "fill", "memcpy", "memset")


def classify(name):
    """Kernel class of a device event name."""
    low = name.lower()
    if "psf_kernel" in low:
        return "splat kernel"
    if "psb_ddata" in low or "psb_dlogits" in low:
        return "splat backward kernels"
    if any(k in low for k in ("kw_fwd_kernel", "kw_dw_kernel",
                              "kw_exp_kernel", "s2g_kernel",
                              "s2g_max_kernel")):
        return "kernel-weighting kernels"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer/clip (foreach)"
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


def _random_kpcn_batch(dev, bs, h, w, train):
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.rand(bs, 27 if k.endswith("_in") else 3, h, w,
                           device=dev, generator=gen)
             for k in ("kpcn_diffuse_in", "kpcn_specular_in",
                       "kpcn_diffuse_buffer", "kpcn_specular_buffer",
                       "kpcn_albedo")}
    if train:
        batch["target_image"] = torch.rand(bs, 3, h, w, device=dev,
                                           generator=gen)
    return batch


def _random_batch(dev, bs, spp, nf, ngf, h, w, train):
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {
        "radiance": torch.rand(bs, spp, 3, h, w, device=dev, generator=gen),
        "features": torch.rand(bs, spp, nf, h, w, device=dev,
                               generator=gen).half(),
        "global_features": torch.rand(bs, ngf, 1, 1, device=dev,
                                      generator=gen)}
    if train:
        batch["target_image"] = torch.rand(bs, 3, h, w, device=dev,
                                           generator=gen)
        # Randomized sample counts: 2..spp valid samples per item.
        n_valid = torch.randint(2, spp + 1, (bs, 1), device=dev,
                                generator=gen)
        batch["sample_mask"] = torch.arange(spp, device=dev)[None] < n_valid
    return batch


#: The sample-record channels the baselines read (a RAW_MODE subset).
BASELINE_LABELS = (
    ["dx", "dy", "lens_u", "lens_v", "t"]
    + ["%s_%s" % (n, c) for n in ("diffuse", "specular", "albedo_first")
       for c in "rgb"]
    + ["normal_first_x", "normal_first_y", "normal_first_z", "depth_first"])


def _baseline_run(method, dev, spp, h, w):
    """``(run, what)`` for one baseline on random records, warmed up."""
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.rand(spp, len(BASELINE_LABELS), h, w, device=dev,
                       generator=gen)

    def run():
        denoise_buffers(feats, BASELINE_LABELS, method=method)
    run()
    return run, "%s baseline" % method


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="weights/flagship_f16")
    p.add_argument("--size", default=None,
                   help="tile height x width (default 1080x2048, or 128x128 "
                   "with --train)")
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (default 4, or 8 with --train)")
    p.add_argument("--train", action="store_true",
                   help="profile one train step instead of one forward")
    p.add_argument("--bs", type=int, default=4,
                   help="batch size of the train step")
    p.add_argument("--bf16", action="store_true",
                   help="with --train: bfloat16 conv stacks")
    p.add_argument("--arch", default="sbmc",
                   choices=("sbmc", "gather", "kpcn", "lbf"),
                   help="model to profile (default: the checkpoint's)")
    p.add_argument("--baseline", default=None,
                   choices=("nlm", "cbf", "rpf", "nfor"),
                   help="profile a classical baseline instead of a model")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    size = args.size or ("128x128" if args.train else "1080x2048")
    spp = args.spp or (8 if args.train else 4)
    h, w = (int(v) for v in size.split("x"))
    dev = resolve_device("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.baseline:
        run, what = _baseline_run(args.baseline, dev, spp, h, w)
    elif args.train or args.arch != "sbmc":
        # Freshly initialised weights, as a training run starts.
        torch.manual_seed(0)
        meta = Checkpointer.load_meta(args.checkpoint)
        conv_dtype = "bfloat16" if args.bf16 else None
        params = dict(meta["model_params"], conv_dtype=conv_dtype,
                      splat=args.arch != "gather")
        nf, ngf = params["n_features"], params["n_global_features"]
        if args.arch == "kpcn":
            model = KPCN(conv_dtype=conv_dtype)
        elif args.arch == "lbf":
            model = LBF(nf, ngf, conv_dtype=conv_dtype)
        else:
            model = build_model(dict(meta, model_params=params))
        bs = args.bs if args.train else 1
        if args.arch == "kpcn":
            batch = _random_kpcn_batch(dev, bs, h, w, args.train)
        else:
            batch = _random_batch(dev, bs, spp, nf, ngf, h, w, args.train)
        convs = "bf16" if args.bf16 else "float32"
    if args.baseline:
        pass  # run and what are set
    elif args.train:
        iface = DenoiserInterface(model, device=dev)
        what = "%s train step, batch %d, %s convs" % (args.arch, args.bs,
                                                      convs)
        for _ in range(3):
            iface.train_step(batch)

        def run():
            iface.train_step(batch)
    else:
        if args.arch == "sbmc":
            model, meta, _ = load_model(args.checkpoint, dev)
            batch = _random_batch(dev, 1, spp,
                                  meta["model_params"]["n_features"],
                                  meta["model_params"]["n_global_features"],
                                  h, w, False)
            what = "forward"
        else:
            model = model.to(dev).eval()
            what = "%s forward, %s convs" % (args.arch, convs)
        with torch.inference_mode():
            model(batch)

        def run():
            with torch.inference_mode():
                model(batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, kernels = {}, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # A labelled range (such as "Optimizer.step#Adam.step") spans
        # kernels that are counted on their own.
        if getattr(evt, "is_user_annotation", False) \
                or evt.key.startswith(("Optimizer.", "ProfilerStep")):
            continue
        kernels.append((us, evt.count, evt.key))
        cls = classify(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = sum(by_class.values()) / 1e3
    samples = ", %d spp" % spp if args.baseline or args.arch != "kpcn" \
        else ""
    print("%s: %s, %dx%d tile%s: wall %.2f ms (profiled), device busy "
          "%.2f ms (%.1f%%)" % (torch.cuda.get_device_name(0), what, h, w,
                                samples, wall_ms, busy_ms,
                                100 * busy_ms / wall_ms))
    if not kernels:
        print("the profiler recorded no device time")
        return
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-24s %9.2f ms  %5.1f%%" % (cls, us / 1e3,
                                              100 * us / 1e3 / busy_ms))
    print("top kernels (device ms, launches, name):")
    for us, count, key in sorted(kernels, reverse=True)[:args.top]:
        print("  %9.2f  %5d  %s" % (us / 1e3, count, key[:110]))


if __name__ == "__main__":
    main()
