"""Run the NFOR [Bitterli2016] comparison denoiser on ``.bin`` samples
(counterpart of ``scripts/denoise_nfor.py``).

    python -m sbmc_tpu_torch.denoise_nfor DENOISER_EXE SCENE_DIR OUTPUT \\
        [--tmp_dir DIR] [--spp 8] [--verbose]

Converts a scene's ``.bin`` tiles into the multi-channel ``.exr`` layout
that Tungsten's ``denoiser`` binary expects (color, diffuse, specular,
albedo, normal and depth, each with A/B half-buffers and the Monte-Carlo
estimate's variance: 24 files of float32 pixels), then runs the binary on
them and removes the temporary directory. The binary is not part of the
repo. Host-only: nothing here runs on a device.
"""

import argparse
import os
import shutil
import subprocess
import tempfile

import numpy as np

from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.logging import get_logger, set_logger

__all__ = ["bins2exr", "main", "parse_args"]


def bins2exr(data_dir, output, spp):
    """Convert the one scene of ``data_dir`` into NFOR's ``.exr`` channel
    files in ``output``."""
    log = get_logger("sbmc_tpu_torch.nfor")

    data = FullImagesDataset(data_dir, mode=TilesDataset.RAW_MODE, spp=spp)
    if len(data.scenes) != 1:
        raise RuntimeError("Invalid number of scenes in .bin folder.")
    im = data[0]
    os.makedirs(output, exist_ok=True)

    labels = data.labels
    half = spp // 2
    df = im["features"]

    def planes(idx, n=3):
        # [spp, c, h, w] -> [h, w, c, spp]
        return df[:, idx:idx + n].transpose(2, 3, 1, 0)

    out = {}

    def add(name, stack):
        out[name] = stack.mean(-1)
        out[name + "A"] = stack[..., :half].mean(-1)
        out[name + "B"] = stack[..., half:].mean(-1)
        # The Monte-Carlo estimate's variance: the samples' over n.
        out[name + "Variance"] = stack.var(-1) / spp

    diffuse = np.maximum(planes(labels.index("diffuse_r")), 0)
    specular = np.maximum(planes(labels.index("specular_r")), 0)
    add("color", np.maximum(diffuse + specular, 0))
    add("diffuse", diffuse)
    add("specular", specular)
    add("albedo", planes(labels.index("albedo_first_r")))
    add("normal", planes(labels.index("normal_first_x")))
    depth = np.tile(planes(labels.index("depth_first"), 1), [1, 1, 3, 1])
    depth = np.maximum(depth, 0) / im["scene_radius"]
    add("depth", depth)

    for k, v in out.items():
        log.debug("  %s %.2f -- %.2f", k, v.min(), v.max())
        exr.write(os.path.join(output, k + ".exr"), v, pixel_type="float")


def main(argv=None):
    args = parse_args(argv)
    set_logger(args.verbose)
    if args.tmp_dir is None:
        args.tmp_dir = tempfile.mkdtemp()
    args.denoiser_exe = os.path.abspath(args.denoiser_exe)

    os.makedirs(args.tmp_dir, exist_ok=True)
    scene_name = os.path.basename(args.scene)
    bins_folder = os.path.join(args.tmp_dir, "bins")
    os.makedirs(bins_folder, exist_ok=True)
    link = os.path.join(bins_folder, scene_name)
    if not os.path.exists(link):
        os.symlink(os.path.abspath(args.scene), link)

    exr_folder = os.path.join(args.tmp_dir, "exr_channels")
    bins2exr(bins_folder, exr_folder, args.spp)

    os.makedirs(args.output, exist_ok=True)
    stderr = None if args.verbose else subprocess.DEVNULL
    subprocess.call([args.denoiser_exe, exr_folder + "/", args.output],
                    stderr=stderr)
    shutil.rmtree(args.tmp_dir)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("denoiser_exe",
                        help="path to Tungsten's `denoiser` executable.")
    parser.add_argument("scene",
                        help="folder containing the scene .bin files.")
    parser.add_argument("output", help="output path.")
    parser.add_argument("--tmp_dir", default=None)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--verbose", action="store_true", default=False)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
