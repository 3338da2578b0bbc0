"""Denoise rendered samples with a trained model (counterpart of
``scripts/denoise.py``).

    python -m sbmc_tpu_torch.denoise --input DATA_DIR \\
        --checkpoint weights/flagship_f16 --output out.exr --uniform_tiles

The model (SBMC, KPCN or LBF) and the dataset configuration come from the
checkpoint's meta, so no model flags are needed. A frame is processed in
overlapping tiles, one tile on the device at a time: ``--uniform_tiles``
stacks equal-size tiles (the frame zero-padded to the grid) and ships the
feature stacks to the device as float16; the default path cuts ragged
tiles. Runs on ``--device cuda`` unless told otherwise, and raises when that
device is missing. Times are fenced with ``torch.cuda.synchronize()``.
``--trace DIR`` records the first scene's tiles with ``torch.profiler``
(host and, on the card, device activity) and writes a Chrome trace,
``DIR/denoise_trace.json``.
"""

import argparse
import logging
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import load_jax_params
from sbmc_tpu_torch.parallel.tiles import (merge_tiles, merge_tiles_uniform,
                                           pad_back, split_tiles,
                                           split_tiles_uniform)
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import write_png

__all__ = ["main", "load_model", "parse_args"]

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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(arrays, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _denoise_uniform(model, batch, args, device):
    stacked, info = split_tiles_uniform(batch, tile=args.tile_size,
                                        pad=args.tile_pad)
    if not args.f32_transfer:
        # Ship the dominant feature stacks as float16 (halves the
        # host->device bytes and device residency, matching the f16-cached
        # training feed); radiance stays float32 (HDR range).
        for k in stacked:
            if "features" in k or k.endswith("_in"):
                stacked[k] = stacked[k].astype(np.float16)
    n_tiles = stacked["features" if "features" in stacked
                      else "kpcn_diffuse_in"].shape[0]
    dev = _to_device(stacked, device)
    _sync(device)
    t0 = time.perf_counter()
    outs = []
    for i in range(n_tiles):
        # Float16 stacks are upcast on the device, as the JAX script's
        # _upcast does; the model then casts to its conv dtype.
        tile = {k: (v[i:i + 1].float() if v.dtype == torch.float16
                    else v[i:i + 1]) for k, v in dev.items()}
        outs.append(model(tile)["radiance"])
    out = torch.cat(outs).cpu().numpy()  # synchronises
    elapsed = (time.perf_counter() - t0) * 1000
    log.info("    denoising time %.1f ms (%d uniform tiles, %s)", elapsed,
             n_tiles, device)
    return merge_tiles_uniform(out, info), elapsed, n_tiles


def _denoise_ragged(model, batch, args, device):
    tiles = split_tiles(batch, max_sz=args.tile_size, pad=args.tile_pad)
    canvas = np.zeros_like(np.asarray(batch["low_spp"]))
    _sync(device)
    t0 = time.perf_counter()
    merged = []
    for tb, y0, y1, x0, x1, tilepad in tiles:
        inputs = {k: v for k, v in tb.items() if isinstance(v, np.ndarray)}
        out = model(_to_device(inputs, device))["radiance"].cpu().numpy()
        merged.append((pad_back(tb, out), y0, y1, x0, x1, tilepad))
    elapsed = (time.perf_counter() - t0) * 1000
    log.info("    denoising time %.1f ms (%d tiles, %s)", elapsed,
             len(tiles), device)
    return merge_tiles(canvas, merged), elapsed, len(tiles)


def _traced(run, model, batch, args, device):
    """``run(model, batch, args, device)`` under ``torch.profiler``; writes
    the Chrome trace into ``args.trace``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = run(model, batch, args, device)
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("    wrote profiler trace to %s", path)
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
    device = resolve_device(args.device)
    # Float32 stays float32: no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()

    model, meta, step = load_model(args.checkpoint, device)
    log.info("Loaded checkpoint %s (step %s)", args.checkpoint, step)
    data_params = dict(meta["data_params"])
    if args.spp:
        data_params["spp"] = args.spp
    data = FullImagesDataset(args.input, **data_params)
    log.info("Denoising input with %d spp (%s) on %s", data.spp,
             meta.get("arch", "sbmc").upper(), device)
    log.info("setup time %.1f ms", (time.perf_counter() - start) * 1000)

    results = []
    for scene_id in range(len(data)):
        item = data[scene_id]
        batch = {k: v[None] if isinstance(v, np.ndarray) else v
                 for k, v in item.items()}
        scene = os.path.basename(data.get_scene_name(scene_id))
        log.info("  scene %s", scene)
        # With several scenes, suffix the output path per scene.
        out_path = args.output if len(data) == 1 else \
            args.output.replace(".exr", "_%s.exr" % scene)
        run = _denoise_uniform if args.uniform_tiles else _denoise_ragged
        with torch.inference_mode():
            if args.trace and scene_id == 0:
                canvas, elapsed, n_tiles = _traced(run, model, batch, args,
                                                   device)
            else:
                canvas, elapsed, n_tiles = run(model, batch, args, device)
        out_radiance = np.asarray(canvas)[0].transpose(1, 2, 0)
        outdir = os.path.dirname(out_path)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
        exr.write(out_path, out_radiance)
        png = out_path.replace(".exr", ".png")
        write_png(png, (np.clip(out_radiance, 0, 1) * 255).astype(np.uint8))
        log.info("    wrote %s / %s", out_path, png)
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
