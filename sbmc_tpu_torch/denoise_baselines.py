"""Denoise ``.bin`` samples with a classical baseline (NLM, cross-bilateral,
RPF or NFOR), writing the same ``.exr``/``.png`` outputs as
``sbmc_tpu_torch.denoise`` (counterpart of ``scripts/denoise_baselines.py``).

    python -m sbmc_tpu_torch.denoise_baselines --input DATA_DIR \\
        --output out.exr --method nfor [--spp 4]

Runs on ``--device cuda`` unless told otherwise, and raises when that
device is missing. With several scenes the output path gets a per-scene
suffix. Times are fenced with ``torch.cuda.synchronize()``.
"""

import argparse
import logging
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch.comparisons import denoise_buffers
from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import write_png

__all__ = ["main", "parse_args"]

log = logging.getLogger("sbmc_tpu_torch.baselines")


def main(args):
    """Denoise every scene of ``args.input``; returns one dict per scene
    with its output path and denoising milliseconds."""
    if not args.output.endswith(".exr"):
        raise SystemExit("--output must be a .exr path, got %r"
                         % args.output)
    device = resolve_device(args.device)
    data = FullImagesDataset(args.input, mode=TilesDataset.RAW_MODE,
                             spp=args.spp)
    results = []
    for scene_id in range(len(data)):
        item = data[scene_id]
        scene = os.path.basename(data.get_scene_name(scene_id))
        out_path = args.output if len(data) == 1 else \
            args.output.replace(".exr", "_%s.exr" % scene)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = denoise_buffers(item["features"], data.labels,
                              method=args.method, device=device)
        ms = (time.perf_counter() - t0) * 1e3  # the result is on the host
        log.info("  %s: %s denoise %.1f ms (%s)", scene, args.method, ms,
                 device)
        out_radiance = out.transpose(1, 2, 0)
        outdir = os.path.dirname(out_path)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
        exr.write(out_path, out_radiance)
        png = out_path.replace(".exr", ".png")
        write_png(png, (np.clip(out_radiance, 0, 1) * 255).astype(np.uint8))
        log.info("    wrote %s / %s", out_path, png)
        results.append({"scene": scene, "output": out_path, "ms": ms})
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", type=str, required=True,
                        help="folder containing the sample .bin files.")
    parser.add_argument("--output", type=str, required=True,
                        help="output .exr destination.")
    parser.add_argument("--method", choices=["nlm", "cbf", "rpf", "nfor"],
                        default="nlm")
    parser.add_argument("--spp", type=int, default=None,
                        help="number of samples to use as input.")
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
