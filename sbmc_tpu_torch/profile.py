"""Where the flagship forward, or a train step, spends its device time.

    python -m sbmc_tpu_torch.profile [--checkpoint weights/flagship_f16] \\
        [--size 1080x2048] [--spp 4]
    python -m sbmc_tpu_torch.profile --train [--bf16] [--size 128x128] \\
        [--spp 8] [--bs 4] [--arch sbmc|gather|kpcn|lbf]
    python -m sbmc_tpu_torch.profile --baseline nlm|cbf|rpf|nfor \\
        [--size 1080x2048] [--spp 4]

Builds the checkpoint's model on the GPU, runs one tile of random inputs
once to warm up, then once under ``torch.profiler``, and prints the wall
time, the device's busy share of it (the union of its kernel, copy and set
intervals), device time and share by program span of the profiled call
(:mod:`sbmc_tpu_torch.tracing`: ``sbmc.embedding``, ``sbmc.propagation``,
``sbmc.regress``, ``sbmc.splat``; ``kpcn.*``; ``train.*`` and the model's
spans under ``train.forward``) and the top kernels by device time. With
``--train`` the
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

from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.comparisons import denoise_buffers
from sbmc_tpu_torch.denoise import load_model
from sbmc_tpu_torch.models import KPCN, LBF
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.train.interface import DenoiserInterface
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["busy_ms", "span_rows", "main"]

#: The span of one profiled unit, by what is profiled.
UNIT_SPAN = {"train": "train.step", "sbmc": "sbmc.forward",
             "gather": "sbmc.forward", "kpcn": "kpcn.forward"}


def busy_ms(intervals):
    """Milliseconds covered by the union of ``(start_us, end_us)``
    intervals: overlapping kernels count once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def span_rows(call):
    """``(name, calls, device_ms, share %)`` of call ``call`` and of each
    span name below it, the share of the call's device ms."""
    rows = [(call.name, 1, call.device_ms)]
    rows += [(name, s.calls, s.device_ms) for name, s in call.below.items()]
    return [(n, c, ms, 100.0 * ms / call.device_ms if call.device_ms else 0.0)
            for n, c, ms in rows]


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
    unit = None if args.baseline else UNIT_SPAN.get(
        "train" if args.train else args.arch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    recorded = tracing.calls(unit) if unit else []
    spans = {c.name for t in tracing.calls() for c in t.walk()}

    def labelled(evt):
        # A labelled range (a program span, "Optimizer.step#Adam.step")
        # spans kernels that are counted on their own.
        return (getattr(evt, "is_user_annotation", False) or evt.key in spans
                or evt.key.startswith(("Optimizer.", "ProfilerStep")))

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(_device_us(evt), evt.count, evt.key)
               for evt in prof.key_averages()
               if evt.device_type == cuda and _device_us(evt) > 0
               and not labelled(evt)]
    busy = busy_ms([(e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == cuda and not labelled(e)])
    samples = ", %d spp" % spp if args.baseline or args.arch != "kpcn" \
        else ""
    print("%s: %s, %dx%d tile%s: wall %.2f ms (profiled), device busy "
          "%.2f ms (%.1f%%)" % (torch.cuda.get_device_name(0), what, h, w,
                                samples, wall_ms, busy, 100 * busy / wall_ms))
    if not kernels:
        print("the profiler recorded no device time")
        return
    if recorded:
        print("program spans (device ms, share of %s, calls, name):" % unit)
        for name, n, ms, share in span_rows(recorded[-1]):
            print("  %9.2f  %5.1f%%  %5d  %s" % (ms, share, n, name))
    print("top kernels (device ms, launches, name):")
    for us, count, key in sorted(kernels, reverse=True)[:args.top]:
        print("  %9.2f  %5d  %s" % (us / 1e3, count, key[:110]))


if __name__ == "__main__":
    main()
