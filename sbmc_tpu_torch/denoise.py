"""Denoise rendered samples with a trained model (counterpart of
``scripts/denoise.py``).

    python -m sbmc_tpu_torch.denoise --input DATA_DIR \\
        --checkpoint weights/flagship_f16 --output out.exr --uniform_tiles

The model (SBMC, KPCN or LBF) and the dataset configuration come from the
checkpoint's meta, so no model flags are needed. A frame is processed in
overlapping tiles, one tile on a device at a time: ``--uniform_tiles``
stacks equal-size tiles (the frame zero-padded to the grid) and ships the
feature stacks to the device as float16; the default path cuts ragged
tiles. ``--num_devices N`` spreads the tiles over N cards (default: every
visible one), with a copy of the model on each: ragged tiles round-robin,
uniform tiles in contiguous shards of the stack; the frame is the same for
every N. Runs on ``--device cuda`` unless told otherwise, and raises when that
device is missing. Times are fenced with ``torch.cuda.synchronize()``.
``--trace DIR`` records the whole first scene, from loading its samples
to writing its EXR, with ``torch.profiler`` (host and, on the card, device
activity), writes a Chrome trace, ``DIR/denoise_trace.json``, and logs one
line a program span (:mod:`sbmc_tpu_torch.tracing`): a scene is
``denoise.scene``, with ``denoise.load``, ``denoise.split``,
``denoise.to_device``, ``denoise.tiles`` (the model calls under it),
``denoise.readback``, ``denoise.merge`` and ``denoise.write`` under it.
"""

import argparse
import functools
import logging
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch import tracing
from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import load_jax_params
from sbmc_tpu_torch.parallel.mesh import local_devices, replicas
from sbmc_tpu_torch.parallel.tiles import (merge_tiles, merge_tiles_uniform,
                                           pad_back, split_tiles,
                                           split_tiles_uniform)
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.image import write_png

__all__ = ["main", "load_model", "denoise_uniform", "denoise_ragged",
           "parse_args"]

log = logging.getLogger("sbmc_tpu_torch.denoise")

TRACE_FILE = "denoise_trace.json"


def load_model(checkpoint, device):
    """Build the checkpoint's model and load its weights; returns
    ``(model, meta, step)``. Raises when the directory holds no
    checkpoint: inference never runs on random weights."""
    meta = Checkpointer.load_meta(checkpoint)
    model = build_model(meta)
    tree, step = Checkpointer(checkpoint).load_params()
    load_jax_params(model, tree)
    return model.to(device).eval(), meta, step


def _sync(devices):
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _to_device(arrays, device):
    out = {}
    for k, v in arrays.items():
        v = torch.from_numpy(np.ascontiguousarray(v))
        tracing.count("h2d_bytes", v.nbytes)
        out[k] = v.to(device)
    return out


def denoise_uniform(models, batch, args, devices):
    """Denoise ``batch`` in uniform tiles over ``devices`` (``models[d]``
    on ``devices[d]``; a device may be named twice): ``min(len(devices),
    tiles)`` of them, each given a contiguous shard of the tile stack, as
    the JAX script's mesh shards the stack padded to a multiple of that
    count. The padded copies are not run (their outputs would be dropped),
    so the last shards may be short. Every device runs its shard one tile
    at a time; the tiles are enqueued on all devices before any output is
    read, so cards work at once. Returns ``(frame, ms, tiles)``; the frame
    does not depend on the device count."""
    with tracing.span("denoise.split"):
        stacked, info = split_tiles_uniform(batch, tile=args.tile_size,
                                            pad=args.tile_pad)
        if not args.f32_transfer:
            # Ship the dominant feature stacks as float16 (halves the
            # host->device bytes and device residency, matching the
            # f16-cached training feed); radiance stays float32 (HDR range).
            for k in stacked:
                if "features" in k or k.endswith("_in"):
                    stacked[k] = stacked[k].astype(np.float16)
    n_tiles = stacked["features" if "features" in stacked
                      else "kpcn_diffuse_in"].shape[0]
    per = -(-n_tiles // min(len(devices), n_tiles))
    starts = range(0, n_tiles, per)
    with tracing.span("denoise.to_device"):
        # Slices of the stack, not copies: one device ships it whole.
        shards = [_to_device({k: v[lo:lo + per] for k, v in stacked.items()},
                             devices[d]) for d, lo in enumerate(starts)]
        _sync(devices)
    t0 = time.perf_counter()
    outs = [[] for _ in shards]
    with tracing.span("denoise.tiles"):
        for i in range(per):
            for d, (shard, lo) in enumerate(zip(shards, starts)):
                if lo + i >= n_tiles:
                    continue  # the last shard is short
                # Float16 stacks are upcast on the device, as the JAX
                # script's _upcast does; the model then casts to its conv
                # dtype.
                tile = {k: (v[i:i + 1].float() if v.dtype == torch.float16
                            else v[i:i + 1]) for k, v in shard.items()}
                outs[d].append(models[d](tile)["radiance"])
    with tracing.span("denoise.readback"):
        # One read-back a device (it synchronises); one device's is the
        # stack.
        outs = [torch.cat(o).cpu().numpy() for o in outs]
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
    elapsed = (time.perf_counter() - t0) * 1000
    log.info("    denoising time %.1f ms (%d uniform tiles over %d "
             "device(s))", elapsed, n_tiles, len(shards))
    with tracing.span("denoise.merge"):
        frame = merge_tiles_uniform(out, info)
    return frame, elapsed, n_tiles


def denoise_ragged(models, batch, args, devices):
    """Denoise ``batch`` in ragged tiles, tile ``i`` on ``devices[i % N]``
    (``models[d]`` on ``devices[d]``), as the JAX script deals them out:
    every tile is enqueued before any output is read. Returns ``(frame,
    ms, tiles)``; the frame does not depend on the device count."""
    with tracing.span("denoise.split"):
        tiles = split_tiles(batch, max_sz=args.tile_size, pad=args.tile_pad)
        canvas = np.zeros_like(np.asarray(batch["low_spp"]))
    n_dev = len(devices) if len(tiles) > 1 else 1
    _sync(devices)
    t0 = time.perf_counter()
    outs = []
    with tracing.span("denoise.tiles"):
        for i, (tb, *_) in enumerate(tiles):
            d = i % n_dev
            inputs = {k: v for k, v in tb.items()
                      if isinstance(v, np.ndarray)}
            with tracing.span("denoise.to_device", devices[d]):
                inputs = _to_device(inputs, devices[d])
            outs.append(models[d](inputs)["radiance"])
    with tracing.span("denoise.readback"):
        merged = [(pad_back(tb, out.cpu().numpy()), *where)
                  for out, (tb, *where) in zip(outs, tiles)]
    elapsed = (time.perf_counter() - t0) * 1000
    log.info("    denoising time %.1f ms (%d tiles over %d device(s))",
             elapsed, len(tiles), n_dev)
    with tracing.span("denoise.merge"):
        frame = merge_tiles(canvas, merged)
    return frame, elapsed, len(tiles)


def _scene(models, data, scene_id, args, devices, out_path):
    """Denoise scene ``scene_id`` of ``data`` and write it to ``out_path``
    (and a PNG beside it); returns ``(ms, tiles)``."""
    run = denoise_uniform if args.uniform_tiles else denoise_ragged
    with tracing.span("denoise.scene", devices[0]):
        with tracing.span("denoise.load"):
            item = data[scene_id]
            batch = {k: v[None] if isinstance(v, np.ndarray) else v
                     for k, v in item.items()}
        with torch.inference_mode():
            canvas, elapsed, n_tiles = run(models, batch, args, devices)
        with tracing.span("denoise.write"):
            out_radiance = np.asarray(canvas)[0].transpose(1, 2, 0)
            outdir = os.path.dirname(out_path)
            if outdir:
                os.makedirs(outdir, exist_ok=True)
            exr.write(out_path, out_radiance)
            png = out_path.replace(".exr", ".png")
            write_png(png, (np.clip(out_radiance, 0, 1) * 255
                            ).astype(np.uint8))
    log.info("    wrote %s / %s", out_path, png)
    return elapsed, n_tiles


def _traced(fn, devices, trace_dir):
    """``fn()`` under ``torch.profiler`` (every device's work): writes the
    Chrome trace into ``trace_dir`` and logs each program span of the
    scene it recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if devices[0].type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("    wrote profiler trace to %s", path)
    call = tracing.calls("denoise.scene")[-1]
    log.info("    %-20s %6s %11s %11s %13s", "span", "calls", "host ms",
             "device ms", "h2d_bytes")
    rows = [(call.name, 1, call.host_ms, call.device_ms, call.counters)]
    rows += [(name, s.calls, s.host_ms, s.device_ms, s.counters)
             for name, s in call.below.items()]
    for name, n, host, dev, counters in rows:
        log.info("    %-20s %6d %11.3f %11.3f %13d", name, n, host, dev,
                 counters.get("h2d_bytes", 0))
    return out


def main(args):
    """Denoise every scene of ``args.input``; returns one dict per scene
    with its output path, denoising milliseconds and tile count."""
    if not args.output.endswith(".exr"):
        raise SystemExit("--output must be a .exr path, got %r"
                         % args.output)
    if (isinstance(args.tile_size, tuple) or isinstance(args.tile_pad,
                                                        tuple)) \
            and not args.uniform_tiles:
        raise SystemExit("rectangular HxW tiles require --uniform_tiles")
    if not os.path.exists(args.input):
        raise ValueError("input {} does not exist".format(args.input))
    devices = local_devices(args.device, args.num_devices)
    # Float32 stays float32: no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()

    model, meta, step = load_model(args.checkpoint, devices[0])
    models = replicas(model, devices)
    log.info("Loaded checkpoint %s (step %s)", args.checkpoint, step)
    data_params = dict(meta["data_params"])
    if args.spp:
        data_params["spp"] = args.spp
    data = FullImagesDataset(args.input, **data_params)
    log.info("Denoising input with %d spp (%s) on %s", data.spp,
             meta.get("arch", "sbmc").upper(),
             ", ".join(str(d) for d in devices))
    log.info("setup time %.1f ms", (time.perf_counter() - start) * 1000)

    results = []
    for scene_id in range(len(data)):
        scene = os.path.basename(data.get_scene_name(scene_id))
        log.info("  scene %s", scene)
        # With several scenes, suffix the output path per scene.
        out_path = args.output if len(data) == 1 else \
            args.output.replace(".exr", "_%s.exr" % scene)
        one = functools.partial(_scene, models, data, scene_id, args,
                                devices, out_path)
        if args.trace and scene_id == 0:
            elapsed, n_tiles = _traced(one, devices, args.trace)
        else:
            elapsed, n_tiles = one()
        results.append({"scene": scene, "output": out_path, "ms": elapsed,
                        "tiles": n_tiles, "spp": data.spp})
    return results


def _tile(v):
    # "512" -> 512; "640x2048" -> (640, 2048) (uniform-tile path only).
    if "x" in v:
        a, b = v.split("x")
        return (int(a), int(b))
    return int(v)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", type=str, required=True,
                        help="folder containing the sample .bin files.")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="folder containing the model checkpoint.")
    parser.add_argument("--output", type=str, required=True,
                        help="output .exr destination.")
    parser.add_argument("--spp", type=int,
                        help="number of samples to use as input.")
    parser.add_argument("--tile_size", type=_tile, default=512,
                        help="tile size bounding device memory usage; HxW "
                        "(e.g. 640x2048) for rectangular uniform tiles.")
    parser.add_argument("--tile_pad", type=_tile, default=128,
                        help="overlap padding around tiles (HxW allowed).")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices to spread tiles over (default: every "
                        "visible card on cuda, 1 on cpu; more than exist "
                        "raises; on cpu, that many replicas on the CPU).")
    parser.add_argument("--uniform_tiles", action="store_true",
                        help="uniform-size tiles, stacked and shipped to the "
                        "device once (feature stacks as float16).")
    parser.add_argument("--f32_transfer", action="store_true",
                        help="ship feature stacks as float32 instead of "
                        "float16 (uniform-tile path).")
    parser.add_argument("--trace", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                        "first scene into this directory.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    parser.add_argument("--verbose", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    logging.basicConfig(level=logging.INFO if _args.verbose
                        else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    main(_args)
