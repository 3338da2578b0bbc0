"""Quality-evaluation suite: score SBMC against the noisy input, the learned
baselines and the classical baselines on a held-out scene set (counterpart
of ``scripts/eval_suite.py``).

    python -m sbmc_tpu_torch.eval_suite --data DATA_DIR \\
        --checkpoint weights/flagship_f16 --output OUT_DIR \\
        [--kpcn_checkpoint CKPT] [--lbf_checkpoint CKPT] [--png]

For every scene in ``--data`` this writes (under ``--output``):
``gt/<scene>.exr`` (the ground truth recorded with the tiles),
``<spp>spp_input/``, ``<spp>spp_ours/`` (SBMC through overlapping ragged
tiles), ``<spp>spp_{nlm,cbf,rpf,nfor}/`` (the classical baselines of
:mod:`sbmc_tpu_torch.comparisons` on the RAW_MODE sample stacks) and, when
their checkpoints are given, ``<spp>spp_lbf/`` and ``<spp>spp_kpcn/``; then
PSNR / relMSE / DSSIM and the reference metric set per method, excluding a
``--pad`` border, into ``metrics.csv``, ``metrics.md`` and a table on
stdout. Runs on ``--device cuda`` unless told otherwise, and raises when
that device is missing. Each method's time per frame is logged, on the host
clock fenced with ``torch.cuda.synchronize()``, and returned by
:func:`main`.
"""

import argparse
import logging
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch import evaluation
from sbmc_tpu_torch.comparisons import denoise_buffers
from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
from sbmc_tpu_torch.denoise import load_model
from sbmc_tpu_torch.parallel.tiles import merge_tiles, pad_back, split_tiles
from sbmc_tpu_torch.utils import exr
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.image import write_png

__all__ = ["main", "parse_args", "psnr", "rel_mse", "TiledModel",
           "BASELINES"]

log = logging.getLogger("sbmc_tpu_torch.eval_suite")

BASELINES = ("nlm", "cbf", "rpf", "nfor")


def psnr(im, ref):
    """PSNR of the Reinhard-tonemapped images (robust to HDR outliers)."""
    ref_t = np.clip(ref, 0, None)
    im_t = np.clip(im, 0, None)
    ref_t = ref_t / (1 + ref_t)
    im_t = im_t / (1 + im_t)
    mse = ((im_t - ref_t) ** 2).mean()
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def rel_mse(im, ref, eps=1e-2):
    return float((((im - ref) ** 2) / (ref ** 2 + eps)).mean())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TiledModel:
    """A checkpoint's model driven through the overlap-tiled (ragged)
    inference path, one tile on the device at a time."""

    def __init__(self, checkpoint, device, tile_size, tile_pad):
        self.model, self.meta, step = load_model(checkpoint, device)
        self.device, self.tile_size, self.tile_pad = (device, tile_size,
                                                      tile_pad)
        self.tiles = 0  # tiles of the last frame denoised
        log.info("restored %s at step %s", checkpoint, step)

    def denoise(self, item):
        """``[h, w, 3]`` radiance of one frame's dataset item."""
        batch = {k: v[None] if isinstance(v, np.ndarray) else v
                 for k, v in item.items()}
        tiles = split_tiles(batch, max_sz=self.tile_size, pad=self.tile_pad)
        canvas = np.zeros_like(np.asarray(batch["low_spp"]))
        merged = []
        with torch.inference_mode():
            for tb, y0, y1, x0, x1, tilepad in tiles:
                inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device) for k, v in tb.items()
                    if isinstance(v, np.ndarray)}
                out = self.model(inputs)["radiance"].cpu().numpy()
                merged.append((pad_back(tb, out), y0, y1, x0, x1, tilepad))
        merge_tiles(canvas, merged)
        self.tiles = len(tiles)
        return canvas[0].transpose(1, 2, 0)


def _tonemap8(im):
    im = np.clip(im, 0, None)
    return (np.clip((im / (1 + im)) ** (1 / 2.2), 0, 1) * 255).astype(
        np.uint8)


def main(args):
    """Evaluate every scene of ``args.data``; returns ``{"methods": [...],
    "rows": [per-scene metric dicts], "ms": {method: [ms per scene]},
    "tiles": {method: tiles per frame}}``."""
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ours = TiledModel(args.checkpoint, device, args.tile_size, args.tile_pad)
    data_params = dict(ours.meta["data_params"])
    data_params["spp"] = args.spp
    model_data = FullImagesDataset(args.data, **data_params)
    raw_data = FullImagesDataset(args.data, mode=TilesDataset.RAW_MODE,
                                 spp=args.spp)

    rows = []
    methods = ["input", "ours"] + list(BASELINES)
    lbf = kpcn = kpcn_data = None
    if args.lbf_checkpoint:
        lbf = TiledModel(args.lbf_checkpoint, device, args.tile_size,
                         args.tile_pad)
        methods.append("lbf")
    if args.kpcn_checkpoint:
        # KPCN reads pixel statistics (dataset mode "kpcn"), so it sees the
        # scenes through its own dataset view.
        kpcn = TiledModel(args.kpcn_checkpoint, device, args.tile_size,
                          args.tile_pad)
        kpcn_params = dict(kpcn.meta["data_params"])
        kpcn_params["spp"] = args.spp
        kpcn_data = FullImagesDataset(args.data, **kpcn_params)
        methods.append("kpcn")
    times = {}
    tiles = {}

    def timed(name, fn, *a, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(device)
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    col_names = ["psnr", "relmse", "dssim"] + [
        "ref_" + k for k in evaluation.METRIC_OPS]
    for scene_id in range(len(model_data)):
        item = model_data[scene_id]
        raw = raw_data[scene_id]
        scene = os.path.basename(model_data.get_scene_name(scene_id))
        gt = np.asarray(item["target_image"]).transpose(1, 2, 0)
        noisy = np.asarray(item["low_spp"]).transpose(1, 2, 0)

        outs = {"input": noisy}
        # Learned models: overlap-tiled inference.
        outs["ours"] = timed("ours", ours.denoise, item)
        if lbf is not None:
            try:
                outs["lbf"] = timed("lbf", lbf.denoise, item)
            except Exception as e:
                # A missing or partial LBF checkpoint must not sink the
                # whole evaluation: drop the column, score the rest.
                log.warning("lbf baseline unavailable (%s); dropping", e)
                methods.remove("lbf")
                lbf = None
        if kpcn is not None:
            try:
                outs["kpcn"] = timed("kpcn", kpcn.denoise,
                                     kpcn_data[scene_id])
            except Exception as e:
                log.warning("kpcn baseline unavailable (%s); dropping", e)
                methods.remove("kpcn")
                kpcn = None

        tiles.update((m, t.tiles) for m, t in (("ours", ours), ("lbf", lbf),
                                                ("kpcn", kpcn)) if t)
        # Classical baselines.
        for m in BASELINES:
            outs[m] = timed(m, denoise_buffers, raw["features"],
                            raw_data.labels, method=m,
                            device=device).transpose(1, 2, 0)

        # Write and score.
        gdir = os.path.join(args.output, "gt")
        os.makedirs(gdir, exist_ok=True)
        exr.write(os.path.join(gdir, scene + ".exr"), gt)
        if args.png:
            # One [gt | methods...] strip per scene for visual inspection.
            strip = np.concatenate(
                [_tonemap8(gt)] + [_tonemap8(outs[m]) for m in methods],
                axis=1)
            pdir = os.path.join(args.output, "png")
            os.makedirs(pdir, exist_ok=True)
            write_png(os.path.join(pdir, scene + ".png"), strip)
            if scene_id == 0:
                with open(os.path.join(pdir, "columns.txt"), "w") as f:
                    f.write("gt " + " ".join(methods) + "\n")
        # Score the interior: a border of `pad` pixels, which the models
        # cannot produce, is excluded from every method (the reference's
        # protocol, sbmc/evaluation.py: 21-px border).
        p = args.pad
        gt_c = gt[p:-p, p:-p]
        row = {"scene": scene}
        for m in methods:
            mdir = os.path.join(args.output, "%dspp_%s" % (args.spp, m))
            os.makedirs(mdir, exist_ok=True)
            exr.write(os.path.join(mdir, scene + ".exr"), outs[m])
            o_c = outs[m][p:-p, p:-p]
            row[m + "_psnr"] = psnr(o_c, gt_c)
            row[m + "_relmse"] = rel_mse(o_c, gt_c)
            row[m + "_dssim"] = 1.0 - evaluation.ssim(o_c, gt_c)
            for k, op in evaluation.METRIC_OPS.items():
                row["%s_ref_%s" % (m, k)] = float(op(o_c, gt_c))
        rows.append(row)
        log.info("  %s: %s", scene, "  ".join(
            "%s %.2f dB" % (m, row[m + "_psnr"]) for m in methods))
        log.info("  %s: ms per frame %s", scene, "  ".join(
            "%s %.2f" % (m, times[m][-1]) for m in methods if m in times))
        # Stream the CSV row by row, so a run cut short still leaves the
        # scored scenes on disk; the header goes with the first row, once
        # the method list is final.
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "metrics.csv"),
                  "w" if scene_id == 0 else "a") as f:
            if scene_id == 0:
                f.write("scene," + ",".join(
                    "%s_%s" % (m, c) for m in methods
                    for c in col_names) + "\n")
            f.write(row["scene"] + "," + ",".join(
                "%.6f" % row["%s_%s" % (m, c)] for m in methods
                for c in col_names) + "\n")

    # Aggregate table: tonemapped PSNR/relMSE/DSSIM plus the reference
    # metric set on linear radiance (sbmc/evaluation.py:305-310).
    lines = ["| method | PSNR (dB) | relMSE | DSSIM | MSE | rMSE | L1 "
             "| relL1 |",
             "|---|---|---|---|---|---|---|---|"]
    for m in methods:
        lines.append(
            "| %s | %.2f | %.4f | %.4f | %.5f | %.5f | %.5f | %.5f |" % (
                (m,) + tuple(float(np.mean([r[m + "_" + c] for r in rows]))
                             for c in ("psnr", "relmse", "dssim", "ref_mse",
                                       "ref_rmse", "ref_l1",
                                       "ref_relative_l1"))))
    table = "\n".join(lines)
    print(table)
    with open(os.path.join(args.output, "metrics.md"), "w") as f:
        f.write("# Held-out evaluation (%d scenes, %d spp)\n\n%s\n"
                % (len(rows), args.spp, table))
    return {"methods": methods, "rows": rows, "ms": times, "tiles": tiles}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data", required=True,
                        help="held-out scene folder (.bin tiles).")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--kpcn_checkpoint", default=None,
                        help="checkpoint dir of a trained KPCN baseline "
                        "(python -m sbmc_tpu_torch.train --kpcn_mode); adds "
                        "a 'kpcn' column.")
    parser.add_argument("--lbf_checkpoint", default=None,
                        help="checkpoint dir of a trained LBF baseline "
                        "(--lbf_mode); adds an 'lbf' column.")
    parser.add_argument("--output", required=True)
    parser.add_argument("--spp", type=int, default=4)
    parser.add_argument("--tile_size", type=int, default=512)
    parser.add_argument("--tile_pad", type=int, default=64)
    parser.add_argument("--png", action="store_true",
                        help="also write a tonemapped [gt|methods...] "
                        "comparison strip per scene under <output>/png.")
    parser.add_argument("--pad", type=int, default=21,
                        help="border excluded from the metrics (reference "
                        "protocol: 21).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    parser.add_argument("--verbose", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    _args = parse_args()
    logging.basicConfig(level=logging.DEBUG if _args.verbose
                        else logging.INFO,
                        format="%(levelname)s | %(name)s | %(message)s")
    main(_args)
