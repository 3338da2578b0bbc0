"""Headline benchmark of the port: full-frame 1080p denoise throughput on
one GPU (counterpart of the repo-level ``bench.py``).

    python -m sbmc_tpu_torch.bench                     # SBMC, 4 spp, bf16
    python -m sbmc_tpu_torch.bench --tiling ragged      # the CLI's tiles
    python -m sbmc_tpu_torch.bench --model kpcn
    python -m sbmc_tpu_torch.bench --f32 --spp 8

The configuration is ``bench.py``'s: the flagship architecture
(``Multisteps``: 93 features, 3 global features, ksize 21, width 128, 3
steps) or ``KPCN(ksize=21)``, with random weights from ``--seed``, on a
1080x1920 frame at 4 spp; convs and kernel logits in bfloat16 unless
``--f32``. Each tile's inputs are drawn on the device, inside the frame,
from a ``torch.Generator`` (features in the conv dtype), and the model runs
tile by tile; outputs stay on the device, as the host copies of
``python -m sbmc_tpu_torch.denoise`` are not part of the model's time.

Tiling: ``uniform`` (default) cuts ``split_tiles_uniform`` tiles at the
first rung of ``bench.py``'s ladder for the model and sample count (one
padded (1080, 2048) tile for SBMC at 4 and 8 spp); ``ragged`` cuts the
denoise CLI's default ``split_tiles`` tiles (512, pad 128: 28 tiles at
1080x1920). ``--tile`` / ``--pad`` override either.

Timing: ``--warmup`` frames first (they take the kernel build and cuDNN's
first calls), the first of them stitched and checked (the merged frame is
(H, W) and finite); then ``--iters`` frames, each between two CUDA events.
Prints one JSON line with ``bench.py``'s keys: ``value`` is frames/s from
the median frame time, ``vs_baseline`` is against the same 0.5 frames/s
estimate of the reference pipeline on a V100 (``baseline_estimate``: an
estimate, not a measurement), plus every frame's time, the tiling and the
device (the card's name and power limit). Defaults come from the
``SBMC_BENCH_*`` variables ``bench.py`` reads. Runs on ``--device cuda``
unless told otherwise, and raises when that device is missing.
"""

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.parallel.tiles import (_pair, merge_tiles,
                                           merge_tiles_uniform, pad_back,
                                           split_tiles, split_tiles_uniform)
from sbmc_tpu_torch.utils.device import resolve_device
from sbmc_tpu_torch.utils.timing import elapsed_ms

__all__ = ["main", "parse_args", "geometry", "build_model", "tile_inputs",
           "run_frame", "merge_frame", "Geometry"]

#: The reference publishes no numbers; 0.5 frames/s is ``bench.py``'s
#: documented estimate of its CUDA/Halide pipeline on a V100.
V100_BASELINE_FPS = 0.5
N_FEATURES = 93
N_GLOBAL = 3
KPCN_IN = 27
#: The first rung of ``bench.py``'s tile ladders: (tile, pad).
_SBMC_RUNG = ((1080, 2048), (50, 64))
_SBMC_RUNGS = {16: ((590, 1024), (50, 64)), 32: ((590, 1024), (50, 64))}
_KPCN_RUNG = ((1160, 2000), (40, 40))
#: ``python -m sbmc_tpu_torch.denoise``'s default ragged tiles.
_RAGGED = (512, 128)


def _tile_arg(v):
    """"768" -> 768, "1216x768" -> (1216, 768), "" -> None."""
    if not v:
        return None
    if "x" in v:
        a, b = v.split("x")
        return (int(a), int(b))
    return int(v) or None


class Geometry:
    """A frame's tiles: ``shapes`` is each tile's (h, w) in order, and
    ``tile`` / ``pad`` what was asked for. ``info`` (uniform) or ``tiles``
    (ragged, ``split_tiles``' list on a frame of zeros) serve the merge."""

    def __init__(self, tiling, h, w, tile, pad):
        self.tiling, self.h, self.w = tiling, h, w
        frame = {"features": np.zeros((1, 1, 1, h, w), np.float32)}
        if tiling == "uniform":
            (th, tw), (py, px) = _pair(tile), _pair(pad)
            # bench.py clamps a tile to the padded frame.
            self.tile = (min(th, h + 2 * py), min(tw, w + 2 * px))
            self.pad = (py, px)
            _, self.info = split_tiles_uniform(frame, tile=self.tile,
                                               pad=self.pad)
            n = self.info["ny"] * self.info["nx"]
            self.shapes = [self.tile] * n
        elif tiling == "ragged":
            self.tile, self.pad = tile, pad
            self.tiles = split_tiles(frame, max_sz=tile, pad=pad)
            self.shapes = [tuple(tb["features"].shape[-2:])
                           for tb, *_ in self.tiles]
        else:
            raise ValueError("unknown tiling %r" % tiling)

    @property
    def n_tiles(self):
        return len(self.shapes)


def geometry(model="sbmc", spp=4, h=1080, w=1920, tiling="uniform",
             tile=None, pad=None):
    """The frame's :class:`Geometry`: ``bench.py``'s first rung for the
    model and sample count (uniform) or the denoise CLI's default tiles
    (ragged) unless ``tile`` is given; ``pad`` defaults to a quarter of an
    explicit tile, as in ``bench.py``."""
    if tile is None:
        if tiling == "ragged":
            tile, pad = _RAGGED
        elif model == "kpcn":
            tile, pad = _KPCN_RUNG
        else:
            tile, pad = _SBMC_RUNGS.get(spp, _SBMC_RUNG)
    elif pad is None:
        pad = (tuple(t // 4 for t in tile) if isinstance(tile, tuple)
               else tile // 4)
    return Geometry(tiling, h, w, tile, pad)


def build_model(model="sbmc", ksize=21, f32=False, seed=0):
    """The benchmarked model with random weights from ``seed``."""
    dtype = None if f32 else "bfloat16"
    torch.manual_seed(seed)
    if model == "kpcn":
        return KPCN(n_in=KPCN_IN, ksize=ksize, conv_dtype=dtype)
    if model != "sbmc":
        raise ValueError("unknown model %r" % model)
    return Multisteps(n_features=N_FEATURES, n_global_features=N_GLOBAL,
                      ksize=ksize, conv_dtype=dtype, kernel_dtype=dtype)


def tile_inputs(model, shape, spp, f32, gen, device):
    """One tile's random inputs, drawn on ``device`` from ``gen``: uniform
    in [0, 1), as ``bench.py`` draws them; SBMC features in the conv
    dtype."""
    th, tw = shape

    def rand(*s, dtype=torch.float32):
        return torch.rand(*s, generator=gen, device=device, dtype=dtype)

    if model == "kpcn":
        return {"kpcn_diffuse_in": rand(1, KPCN_IN, th, tw),
                "kpcn_specular_in": rand(1, KPCN_IN, th, tw),
                "kpcn_diffuse_buffer": rand(1, 3, th, tw),
                "kpcn_specular_buffer": rand(1, 3, th, tw),
                "kpcn_albedo": rand(1, 3, th, tw)}
    fdt = torch.float32 if f32 else torch.bfloat16
    return {"radiance": rand(1, spp, 3, th, tw),
            "features": rand(1, spp, N_FEATURES, th, tw, dtype=fdt),
            "global_features": rand(1, N_GLOBAL, 1, 1)}


def run_frame(net, geo, make_tile):
    """Apply ``net`` to every tile of ``geo``; ``make_tile(i, (h, w))``
    gives tile ``i``'s inputs. Returns the outputs, on the device."""
    return [net(make_tile(i, shape))["radiance"]
            for i, shape in enumerate(geo.shapes)]


def merge_frame(outs, geo):
    """Stitch a frame's tile outputs as the denoise CLI does: ``[1, 3, H,
    W]`` numpy."""
    outs = [o.float().cpu().numpy() for o in outs]
    if geo.tiling == "uniform":
        return merge_tiles_uniform(np.concatenate(outs), geo.info)
    canvas = np.zeros((1, 3, geo.h, geo.w), np.float32)
    merged = [(pad_back(tb, out), y0, y1, x0, x1, tilepad)
              for out, (tb, y0, y1, x0, x1, tilepad) in zip(outs, geo.tiles)]
    return merge_tiles(canvas, merged)


def _device_name(device):
    if device.type != "cuda":
        return str(device)
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "%s, power limit not read" % torch.cuda.get_device_name(
            device)


def main(args):
    """Run the benchmark; prints the JSON line and returns it as a dict."""
    device = resolve_device(args.device)
    # The denoise CLI's settings: float32 stays float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geo = geometry(args.model, args.spp, args.height, args.width,
                   args.tiling, args.tile, args.pad)
    net = build_model(args.model, args.ksize, args.f32, args.seed)
    net = net.to(device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)

    def make_tile(i, shape):
        return tile_inputs(args.model, shape, args.spp, args.f32, gen,
                           device)

    def frame():
        return run_frame(net, geo, make_tile)

    with torch.inference_mode():
        merged = merge_frame(frame(), geo)
        if merged.shape[-2:] != (args.height, args.width) \
                or not np.isfinite(merged).all():
            raise RuntimeError("the frame is %s, finite: %s" % (
                merged.shape, bool(np.isfinite(merged).all())))
        for _ in range(args.warmup - 1):
            frame()
        ms = [elapsed_ms(frame, device) for _ in range(args.iters)]

    dt = float(np.median(ms)) / 1e3
    fps = 1.0 / dt
    metric = ("1080p_%dspp_denoise_frames_per_sec_per_chip" % args.spp
              if args.model == "sbmc" else
              "1080p_kpcn_denoise_frames_per_sec_per_chip")
    result = {
        "metric": metric,
        "model": args.model,
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / V100_BASELINE_FPS, 3),
        "baseline_estimate": True,
        "baseline_fps": V100_BASELINE_FPS,
        "tile": [geo.tile, geo.pad],
        "n_tiles": geo.n_tiles,
        "resolution": [args.height, args.width],
        "spp": args.spp,
        "frame_seconds": round(dt, 4),
        "frame_ms": ms,
        "tiling": args.tiling,
        "precision": "f32" if args.f32 else "bf16",
        "warmup": args.warmup,
        "iters": args.iters,
        "device": _device_name(device),
    }
    print(json.dumps(result))
    return result


def parse_args(argv=None):
    env = os.environ.get
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("sbmc", "kpcn"),
                        default=env("SBMC_BENCH_MODEL", "sbmc"))
    parser.add_argument("--tiling", choices=("uniform", "ragged"),
                        default="uniform")
    parser.add_argument("--spp", type=int,
                        default=int(env("SBMC_BENCH_SPP", 4)))
    parser.add_argument("--height", type=int,
                        default=int(env("SBMC_BENCH_H", 1080)))
    parser.add_argument("--width", type=int,
                        default=int(env("SBMC_BENCH_W", 1920)))
    parser.add_argument("--tile", type=_tile_arg,
                        default=_tile_arg(env("SBMC_BENCH_TILE", "")),
                        help="tile size, N or HxW (default: see above).")
    parser.add_argument("--pad", type=_tile_arg,
                        default=_tile_arg(env("SBMC_BENCH_PAD", "")),
                        help="tile overlap, N or HxW (default: a quarter "
                        "of an explicit --tile).")
    parser.add_argument("--iters", type=int,
                        default=int(env("SBMC_BENCH_ITERS", 4)))
    parser.add_argument("--warmup", type=int, default=2,
                        help="untimed frames first (at least 1: the first "
                        "is checked).")
    parser.add_argument("--ksize", type=int,
                        default=int(env("SBMC_BENCH_KSIZE", 21)))
    parser.add_argument("--f32", action="store_true",
                        default=bool(env("SBMC_BENCH_F32")),
                        help="float32 convs and logits (default: bf16).")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and of the inputs.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda).")
    args = parser.parse_args(argv)
    if args.warmup < 1 or args.iters < 1:
        parser.error("--warmup and --iters must be at least 1")
    if args.tiling == "ragged" and isinstance(args.tile, tuple):
        parser.error("ragged tiles take one --tile size, not HxW")
    return args


if __name__ == "__main__":
    main(parse_args())
