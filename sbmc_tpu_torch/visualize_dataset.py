"""Dump PNG visualisations of a ``.bin`` dataset: the reference image, the
low-sample-count image and, optionally, the per-feature means (counterpart
of ``scripts/visualize_dataset.py``).

    python -m sbmc_tpu_torch.visualize_dataset DATA_DIR OUTPUT [--spp N] \\
        [--dump_features]

For each scene ``NNNN_reference.png`` and ``NNNN_low_spp.png`` (8-bit
RGB), and with ``--dump_features`` the sample mean of each diffuse,
specular, albedo and normal feature (8-bit RGB; normals mapped from [-1, 1]
to [0, 1]) and of depth, visibility and hit flags (16-bit grey). Values are
clipped to [0, 1]. The PNGs are written by the port's own encoder (no
``imageio``). Host-only: nothing here runs on a device.
"""

import argparse
import os

import numpy as np

from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.utils.image import write_png
from sbmc_tpu_torch.utils.logging import get_logger, set_logger

__all__ = ["save", "main", "parse_args"]


def save(outdir, name, im, dtype=np.uint8):
    """Clip ``im`` (``[c, h, w]`` or ``[h, w]``) to [0, 1] and write it as a
    PNG in ``dtype``: uint8, or uint16 for one channel (three channels are
    always written as uint8, as the JAX script's imageio backend forces)."""
    im = np.asarray(im)
    if im.ndim == 3:  # [c, h, w] -> [h, w, c]
        im = im.transpose(1, 2, 0)
        if im.shape[-1] == 1:
            im = im[..., 0]
    if im.ndim == 3 and dtype != np.uint8:
        dtype = np.uint8
    im = np.clip(im, 0, 1)
    maxval = np.iinfo(dtype).max
    os.makedirs(outdir, exist_ok=True)
    write_png(os.path.join(outdir, name), (im * maxval).astype(dtype))


def main(argv=None):
    args = parse_args(argv)
    set_logger()
    log = get_logger("sbmc_tpu_torch.visualize")

    data = FullImagesDataset(args.data_dir, spp=args.spp)
    log.info("Visualizing dataset with %d spp (gt_spp = %d)", data.spp,
             data.tiles_dset.gt_sample_count)
    for idx in range(len(data)):
        sample = data[idx]
        im = sample["target_image"]
        log.info("sample %d target radiance: %.2f -- %.2f", idx, im.min(),
                 im.max())
        save(args.output, "%04d_reference.png" % idx, im)
        save(args.output, "%04d_low_spp.png" % idx, sample["low_spp"])

        if not args.dump_features:
            continue
        feats = sample["features"]  # [spp, nf, h, w]
        for i, k in enumerate(data.labels):
            if k in ("diffuse_r", "specular_r", "albedo_r",
                     "albedo_first_r"):
                vis = feats[:, i:i + 3]
                k = k[:-2]
            elif k in ("depth", "depth_first", "visibility", "hasHit"):
                vis = feats[:, i:i + 1]
            elif k in ("normal_x", "normal_first_x"):
                vis = (feats[:, i:i + 3] + 1.0) * 0.5
                k = k[:-2]
            else:
                continue
            vis = vis.mean(0)
            log.info("  %s (feature): %.2f -- %.2f", k, vis.min(), vis.max())
            save(args.output, "%04d_%s.png" % (idx, k), vis,
                 dtype=np.uint16)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data_dir",
                        help="folder containing the scenes to visualize")
    parser.add_argument("output", help="output folder for the PNGs")
    parser.add_argument("--spp", type=int)
    parser.add_argument("--dump_features", action="store_true",
                        default=False)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
