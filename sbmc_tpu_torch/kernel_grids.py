"""Visualise the per-sample splatting kernels a trained SBMC model predicts
(counterpart of ``scripts/figures/kernels.py``).

    python -m sbmc_tpu_torch.kernel_grids --input SCENE_DIR \\
        --checkpoint CKPT_DIR --output OUT [--samples 4] [--crop 64] \\
        [--device cuda]

Loads a training checkpoint (the latest numbered one, else ``final``),
runs the model with ``return_kernels=True`` on the first scene of
``FullImagesDataset(SCENE_DIR, **meta["data_params"])``, its radiance and
features cropped to ``--crop`` pixels a side, and writes ``output.png``
(the denoised crop, ``rad / (1 + rad)``) and ``kernels_sampleNN.png`` for
the first ``--samples`` samples: each pixel's k x k kernel logits as a
k-times enlarged grid, ``exp(grid - grid.max())``, in the logits' dtype as
the JAX script's numpy keeps it (bfloat16 logits stay bfloat16). KPCN
checkpoints, which predict per-pixel gather kernels without the per-sample
scan, are refused; so is a directory without a training checkpoint (the
JAX script would run on random weights). Runs on ``--device cuda`` unless
told otherwise, and raises when that device is missing.
"""

import argparse
import os

import numpy as np
import torch

from sbmc_tpu_torch.data.datasets import FullImagesDataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import load_jax_params, read_msgpack
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import write_png

__all__ = ["kernels_to_image", "main", "parse_args"]


def kernels_to_image(kernels):
    """``[k2, h, w]`` kernel logits (a tensor) -> ``[h*k, w*k]``
    exp-normalised grid image, in the logits' dtype."""
    k2, h, w = kernels.shape
    k = int(round(k2 ** 0.5))
    img = kernels.reshape(k, k, h, w).permute(2, 0, 3, 1).reshape(
        h * k, w * k)
    return torch.exp(img - img.max())


def _training_params(root):
    """The flax params of the latest numbered checkpoint of ``root``, else
    of ``final``; raises ``SystemExit`` when there is neither."""
    found = Checkpointer(root).find()
    if found is None or not found[2]:
        raise SystemExit("no training checkpoint (ckpt_*.msgpack or "
                         "final.msgpack) in %s" % root)
    return read_msgpack(found[0])["params"]


def _u8(im):
    return (torch.clamp(im, 0, 1) * 255).to(torch.uint8).numpy()


def main(argv=None):
    """Returns the number of kernel grids written."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meta = Checkpointer.load_meta(args.checkpoint)
    if meta.get("kpcn_mode", False):
        raise SystemExit("kernel visualization requires an SBMC "
                         "(Multisteps) checkpoint; KPCN predicts per-pixel "
                         "gather kernels without the per-sample scan.")
    model = build_model(meta)
    if not isinstance(model, Multisteps):
        raise SystemExit("kernel visualization requires an SBMC "
                         "(Multisteps) checkpoint, got arch %r"
                         % meta.get("arch"))
    model.return_kernels = True
    load_jax_params(model, _training_params(args.checkpoint))
    data = FullImagesDataset(args.input, **meta["data_params"])

    item = data[0]
    batch = {k: v[None] for k, v in item.items()
             if isinstance(v, np.ndarray)}
    if args.crop:
        for k in ("radiance", "features"):
            batch[k] = batch[k][..., :args.crop, :args.crop]

    model.to(device).eval()
    with torch.no_grad():
        out = model({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()})
    os.makedirs(args.output, exist_ok=True)

    rad = out["radiance"][0].float().cpu().permute(1, 2, 0)
    write_png(os.path.join(args.output, "output.png"), _u8(rad / (1 + rad)))

    kernels = out["kernels"][0].cpu()  # [spp, k2, h, w]
    n = min(args.samples, kernels.shape[0])
    for s in range(n):
        write_png(os.path.join(args.output, "kernels_sample%02d.png" % s),
                  _u8(kernels_to_image(kernels[s])))
    print("wrote kernel grids for %d samples to %s" % (n, args.output))
    return n


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", required=True,
                        help=".bin scene folder")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--samples", type=int, default=4)
    parser.add_argument("--crop", type=int, default=64,
                        help="crop size to keep the kernel grids small")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
