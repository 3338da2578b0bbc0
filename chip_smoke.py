#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sbmc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:

1. device: needs a CUDA device; prints the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels from ``sbmc_tpu_torch/ops/csrc`` with
   nvcc and prints the build seconds;
3. kernel: holds the fused progressive splat kernel against its plain
   PyTorch version on the card (k in {3, 5, 21}, odd shapes, float32 and
   bfloat16 logits, initial and random state), then times both at the
   flagship tile shape (1, 3, 1080, 2048), k = 21, bf16 logits;
4. reference: the flagship model on the card against the same model on the
   CPU (plain splat), on a small input, in float32 and in bfloat16 convs;
5. main path: writes a synthetic 256x256, 4-spp frame and denoises it with
   ``sbmc_tpu_torch.denoise`` and ``weights/flagship_f16`` (full width:
   ksize 21, width 128, nsteps 3, bf16 convs) through uniform tiles; checks
   the EXR and that every sample step of every tile launched the kernel;
6. scale: times the flagship forward on one full 1080x2048 tile at 4 spp.

Then one JSON line with each kernel's numbers and, last, the device line.
Any failure raises and exits non-zero without printing a result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel against plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# ATOL is the JAX package's bound for its fused splat kernel against the
# composed version (tests/test_ops.py); RTOL covers float32 sums over up to
# 441 taps taken in another order (sum_w reaches hundreds at 1080x2048).
ATOL, RTOL = 2e-4, 2e-5
# The flagship model on the card against the CPU, on the same input:
# float32 convs (no TF32) differ by summation order only; bfloat16 convs
# round at other places in cuDNN and on the CPU, which moves outputs by as
# much as the JAX model's own bf16-vs-f32 drift (~1.7e-2 max, ~2.3e-3 mean).
MODEL_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-3)}

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores


def _device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])


def _time_ms(fn, warmup, iters):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _splat_inputs(rng, bs, c, h, w, k, dtype, init):
    dev = torch.device("cuda")

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32).to(dt).to(dev)

    data = t(rng.randn(bs, c, h, w))
    logits = t(3 * rng.randn(bs, k * k, h, w), dtype)
    if init:
        state = (torch.zeros(bs, c, h, w, device=dev),
                 torch.zeros(bs, 1, h, w, device=dev),
                 torch.full((bs, 1, h, w), -1e30, device=dev))
    else:
        state = (t(rng.randn(bs, c, h, w)),
                 t(abs(rng.randn(bs, 1, h, w))),
                 t(rng.randn(bs, 1, h, w)))
    return (data, logits) + state


def _compare(ops, args):
    got = ops.progressive_splat_update(*args)
    want = ops.progressive_splat_update_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, r in zip(got, want):
        if not bool(torch.all((g - r).abs() <= ATOL + RTOL * r.abs())):
            raise AssertionError(
                "splat kernel disagrees with its plain version: max abs "
                "err %.3g" % float((g - r).abs().max()))
        err = max(err, float((g - r).abs().max()))
    return err


def _kernel_phase(ops, main_tile):
    rng = np.random.RandomState(0)
    err = 0.0
    cases = 0
    for k in (3, 5, 21):
        for hw in ((37, 53), (130, 3), (5, 7)):
            for dtype in (torch.float32, torch.bfloat16):
                for init in (True, False):
                    args = _splat_inputs(rng, 2, 3, *hw, k, dtype, init)
                    err = max(err, _compare(ops, args))
                    cases += 1
    # The main path's own tile shape, and two channels (the kernel's other
    # template instance the tests use).
    for c, hw, bs in ((3, main_tile, 1), (2, (37, 53), 2)):
        args = _splat_inputs(rng, bs, c, *hw, 21, torch.bfloat16, False)
        err = max(err, _compare(ops, args))
        cases += 1
    print("kernel check: %d cases, max abs err %.3g (tolerance %.0e + %.0e"
          " * |plain|)" % (cases, err, ATOL, RTOL))
    args = _splat_inputs(rng, 1, 3, *main_tile, 21, torch.bfloat16, False)
    print("kernel time at the main path's tile (1, 3, %d, %d), k=21, bf16: "
          "%.4f ms" % (*main_tile, _time_ms(
              lambda: ops.progressive_splat_update(*args), 3, 50)))

    # Flagship tile: 1080x2048, k = 21, bf16 logits, bs 1, 3 channels.
    bs, c, h, w, k = 1, 3, 1080, 2048, 21
    args = _splat_inputs(rng, bs, c, h, w, k, torch.bfloat16, False)
    err = max(err, _compare(ops, args))
    ms = _time_ms(lambda: ops.progressive_splat_update(*args), 3, 20)
    plain_ms = _time_ms(lambda: ops.progressive_splat_update_ref(*args), 1,
                        3)
    hw_ = h * w
    logits_bytes = bs * k * k * hw_ * 2
    # Each input read once (data, logits, three state planes), each
    # output written once (three state planes).
    nbytes = logits_bytes + bs * hw_ * 4 * (c + (c + 2) + (c + 2))
    # Per tap: subtract, exp, add to sum_w, and one FMA per channel.
    flops = bs * k * k * hw_ * (3 + 2 * c)
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    bound_by = ("bytes" if nbytes / H100_BYTES_PER_S
                >= flops / H100_F32_FLOPS else "operations")
    print("kernel time at (1, 3, 1080, 2048), k=21, bf16: %.4f ms; plain "
          "version %.4f ms; bound %.4f ms (%s: %.4g GB, logits alone "
          "%.4f ms)" % (ms, plain_ms, bound_ms, bound_by, nbytes / 1e9,
                        logits_bytes / H100_BYTES_PER_S * 1e3))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _reference_phase(checkpoint):
    """The flagship model on the card (kernel) against the CPU (plain)."""
    from sbmc_tpu_torch.models.build import build_model
    from sbmc_tpu_torch.params import load_jax_params
    from sbmc_tpu_torch.train.checkpointer import Checkpointer

    meta = Checkpointer.load_meta(checkpoint)
    tree, _ = Checkpointer(checkpoint).load_params()
    rng = np.random.RandomState(1)
    batch = {"radiance": rng.rand(1, 2, 3, 48, 48),
             "features": rng.rand(1, 2, 93, 48, 48),
             "global_features": rng.rand(1, 3, 1, 1)}
    for dtype, (max_tol, mean_tol) in MODEL_TOL.items():
        params = dict(meta["model_params"], conv_dtype=dtype)
        model = load_jax_params(build_model(dict(meta, model_params=params)),
                                tree)
        outs = []
        for dev in ("cpu", "cuda"):
            b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
            with torch.inference_mode():
                outs.append(model.to(dev)(b)["radiance"].cpu().numpy())
        diff = np.abs(outs[0] - outs[1])
        print("reference: flagship %s convs, card vs CPU on 1x2x48x48: max "
              "abs %.3g, mean %.3g (tolerance %.0e / %.0e)"
              % (dtype, diff.max(), diff.mean(), max_tol, mean_tol))
        if not (np.isfinite(outs[1]).all() and diff.max() <= max_tol
                and diff.mean() <= mean_tol):
            raise AssertionError("flagship model on the card disagrees with "
                                 "the CPU (%s convs)" % dtype)


def _scale_phase(checkpoint, spp=4, h=1080, w=2048):
    """The flagship forward on one full 1080x2048 tile (random inputs):
    the time a frame's worth of work takes on the card at real size."""
    from sbmc_tpu_torch.denoise import load_model

    model, _, _ = load_model(checkpoint, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {
        "radiance": torch.rand(1, spp, 3, h, w, device="cuda",
                               generator=gen),
        "features": torch.rand(1, spp, 93, h, w, device="cuda",
                               generator=gen).half(),
        "global_features": torch.rand(1, 3, 1, 1, device="cuda",
                                      generator=gen)}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = _time_ms(lambda: model(batch), 1, 3)
    print("flagship forward on one %dx%d tile at %d spp (bf16 convs): "
          "%.2f ms; peak device memory %.2f GB" % (
              h, w, spp, ms, torch.cuda.max_memory_allocated() / 1e9))


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _main_phase(ops, checkpoint, tmp, tile, pad):
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.data.datasets import FullImagesDataset
    from sbmc_tpu_torch.data.synthetic import generate_dataset
    from sbmc_tpu_torch.utils import exr

    size, spp = 256, 4
    data_dir = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    generate_dataset(data_dir, n_scenes=1, ts=64, tiles_per_side=4,
                     spp=spp, gt_spp=64, seed=0)
    gen_s = time.perf_counter() - t0
    out = os.path.join(tmp, "out", "frame.exr")
    argv = ["--input", data_dir, "--checkpoint", checkpoint, "--output", out,
            "--uniform_tiles", "--tile_size", str(tile), "--tile_pad",
            str(pad), "--spp", str(spp), "--device", "cuda"]
    warm = denoise.main(denoise.parse_args(argv))
    ops.reset_launch_counts()
    res = denoise.main(denoise.parse_args(argv))
    launches = dict(ops.launch_counts)
    tiles = res[0]["tiles"]
    if launches["progressive_splat"] != tiles * spp:
        raise AssertionError("splat kernel launched %d times, expected "
                             "tiles x spp = %d" % (
                                 launches["progressive_splat"], tiles * spp))
    img = exr.read(out)
    if img.shape != (size, size, 3) or not np.isfinite(img).all():
        raise AssertionError("denoised EXR is %s, finite: %s" % (
            img.shape, bool(np.isfinite(img).all())))
    frame = FullImagesDataset(data_dir, spp=spp)[0]
    crop = 10  # (ksize - 1) / 2: the model's border
    inner = (slice(crop, -crop), slice(crop, -crop))
    gt = frame["target_image"].transpose(1, 2, 0)[inner]
    noisy = frame["low_spp"].transpose(1, 2, 0)[inner]
    print("main path: %dx%d frame, %d spp, %d uniform tiles of %d (pad %d): "
          "%.2f ms/frame (first run %.2f ms), splat launches %d; data "
          "written in %.1f s" % (size, size, spp, tiles, tile, pad,
                                 res[0]["ms"], warm[0]["ms"],
                                 launches["progressive_splat"], gen_s))
    print("quality vs the frame's ground truth (clipped to [0, 1], %d px "
          "border cropped): denoised %.2f dB, noisy input %.2f dB"
          % (crop, _psnr(img[inner], gt), _psnr(noisy, gt)))
    return launches


def main():
    _device_phase()
    if not os.path.isdir(os.path.join(ROOT, "sbmc_tpu_torch")):
        raise SystemExit("chip_smoke: sbmc_tpu_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    from sbmc_tpu_torch import ops
    from sbmc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_cuda()
    print("build: %.2f s (nvcc %s)" % (time.perf_counter() - t0,
                                       " ".join(_build.NVCC_FLAGS)))

    tile, pad = 160, 32
    with torch.inference_mode():
        numbers = _kernel_phase(ops, (tile, tile))
    checkpoint = os.path.join(ROOT, "weights", "flagship_f16")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reference_phase(checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        launches = _main_phase(ops, checkpoint, tmp, tile, pad)
    _scale_phase(checkpoint)

    kernels = [dict(
        name="progressive_splat", route="cuda",
        source="sbmc_tpu_torch/ops/csrc/progressive_splat.cu",
        replaces="sbmc_tpu/ops/pallas_kernels.py:535",
        launches=launches["progressive_splat"], library_ms=None,
        **numbers)]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError("kernel %s never launched on the main path"
                                 % k["name"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
