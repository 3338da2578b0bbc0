"""Training-sanity probe: score a checkpoint (or float16 snapshot) against
the trivial predictor, the per-pixel sample mean (the noisy input), on
tiles of a dataset under the training loss (counterpart of
``scripts/probe_vs_input.py``).

    python -m sbmc_tpu_torch.probe_vs_input DATA_DIR CKPT_OR_SNAPSHOT_DIR \\
        [--spp 8] [--tiles 4] [--device cuda]

A denoiser that has learned anything beats the input mean decisively. The
probe takes ``--tiles`` tiles of ``TilesDataset(DATA_DIR, spp)`` evenly
spaced over the dataset, runs the model on each, one tile at a time, and
scores its output and the input mean against the target, both cropped to
the model's output, with ``losses.tonemapped_relative_mse`` in float32 on
the host. It prints a line per tile and the verdict line. The weights come
from ``params_f16.msgpack`` when the directory holds one (an
``export_params`` snapshot), else from the latest numbered training
checkpoint, else from ``final``; the model from the directory's
``meta.json``. Runs on ``--device cuda`` unless told otherwise, and raises
when that device is missing.
"""

import argparse
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch import losses
from sbmc_tpu_torch.data.datasets import TilesDataset
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import load_jax_params, read_msgpack
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.utils.device import resolve_device

__all__ = ["load_params", "score_tiles", "main", "parse_args"]


def load_params(src, model):
    """Load the weights of ``src`` into ``model`` (in place): the float16
    snapshot if the directory holds one, else its training checkpoint.
    Raises ``SystemExit`` when it holds neither."""
    snap = os.path.join(src, Checkpointer.SNAPSHOT_FILE)
    if os.path.exists(snap):
        return load_jax_params(model, read_msgpack(snap))
    try:
        tree, step = Checkpointer(src).load_params()
    except FileNotFoundError:
        raise SystemExit(f"no checkpoint found in {src}") from None
    print(f"loaded checkpoint step {step}")
    return load_jax_params(model, tree)


def _batch(item, device):
    return {k: torch.from_numpy(np.array(v[None])).to(device)
            for k, v in item.items() if isinstance(v, np.ndarray)}


def score_tiles(model, ds, tiles, device):
    """``(indices, model scores, input-mean scores)`` on ``tiles`` tiles of
    ``ds`` spaced evenly over it, printing a line per tile."""
    idxs = np.linspace(0, len(ds) - 1, tiles).astype(int)
    lm, li = [], []
    for i in idxs:
        it = ds[int(i)]
        t0 = time.time()
        with torch.no_grad():
            out = model(_batch(it, device))["radiance"].float().cpu()
        h, w = out.shape[-2:]
        th, tw = it["target_image"].shape[-2:]
        oy, ox = (th - h) // 2, (tw - w) // 2
        tgt = torch.from_numpy(np.asarray(it["target_image"])[None][
            :, :, oy:oy + h, ox:ox + w])
        pin = torch.from_numpy(np.asarray(it["radiance"]).mean(
            0, keepdims=True)[:, :, oy:oy + h, ox:ox + w])
        a = float(losses.tonemapped_relative_mse(out, tgt))
        b = float(losses.tonemapped_relative_mse(pin, tgt))
        lm.append(a)
        li.append(b)
        print(f"tile {i}: model {a:.5f} vs input-mean {b:.5f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return idxs, lm, li


def main(argv=None):
    """Returns ``{"tiles": indices, "model": scores, "input": scores}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    # Float32 stays float32: no TF32 in matmuls or cuDNN convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meta = Checkpointer.load_meta(args.checkpoint)
    model = build_model(meta)
    ds = TilesDataset(args.data, spp=args.spp)
    load_params(args.checkpoint, model)
    model.to(device).eval()

    idxs, lm, li = score_tiles(model, ds, args.tiles, device)
    mm, mi = float(np.mean(lm)), float(np.mean(li))
    verdict = "BEATS" if mm < mi else "LOSES TO"
    print(f"MEAN over {len(idxs)} tiles: model {mm:.5f} vs input {mi:.5f} "
          f"-> model {verdict} the trivial input mean")
    return {"tiles": [int(i) for i in idxs], "model": lm, "input": li}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", help=".bin tile folder")
    p.add_argument("checkpoint", help="checkpoint dir or f16 snapshot dir")
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--tiles", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda).")
    return p.parse_args(argv)


if __name__ == "__main__":
    main()
