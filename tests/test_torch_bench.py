"""The port's bench (``python -m sbmc_tpu_torch.bench``) against the
repo-level ``bench.py``, on the CPU.

- Geometry: the default tile, pad and tile count for each model and sample
  count are ``bench.py``'s first rung, clamped as ``bench.py`` clamps it and
  split by the JAX package's ``split_tiles_uniform``; exact.
- The printed line carries ``bench.py``'s keys and metric names.
- The bench's frame is the denoise CLI's frame: the same weights and inputs
  through the bench's tiles and merge and through
  ``sbmc_tpu_torch.denoise``'s uniform and ragged paths give the same
  image, bit for bit (float32 model; features and global features that
  float16 holds exactly, so the CLI's float16 transfer of both changes
  nothing).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from sbmc_tpu.parallel.tiles import split_tiles_uniform as jsplit_uniform
from sbmc_tpu_torch import bench, denoise
from sbmc_tpu_torch.parallel.tiles import split_tiles, split_tiles_uniform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

#: bench.py's keys (its JSON line, bench.py:296-314).
BENCH_KEYS = {"metric", "model", "value", "unit", "vs_baseline",
              "baseline_estimate", "baseline_fps", "tile", "n_tiles",
              "resolution", "spp", "frame_seconds"}


def _ladders():
    """bench.py's tile ladders, read from its source (importing it would
    configure JAX for the whole test process)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    names = ("_DEFAULT_LADDER", "_SPP_LADDERS", "_KPCN_LADDER")
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) in names}


@pytest.mark.parametrize("model,spp", [("sbmc", 4), ("sbmc", 8),
                                       ("sbmc", 16), ("sbmc", 32),
                                       ("kpcn", 4)])
def test_default_geometry_is_bench_first_rung(model, spp):
    lad = _ladders()
    if model == "kpcn":
        tile, pad = lad["_KPCN_LADDER"][0]
    else:
        tile, pad = lad["_SPP_LADDERS"].get(spp, lad["_DEFAULT_LADDER"])[0]
    h, w = 1080, 1920
    (th, tw), (py, px) = tile, pad
    tile = (min(th, h + 2 * py), min(tw, w + 2 * px))
    _, info = jsplit_uniform({"features": np.zeros((1, 1, 1, h, w))},
                             tile=tile, pad=pad)
    geo = bench.geometry(model, spp)
    assert (geo.tile, geo.pad) == (tile, pad)
    assert geo.info == info
    assert geo.n_tiles == info["ny"] * info["nx"]
    assert geo.shapes == [tile] * geo.n_tiles
    assert geo.n_tiles == {4: 1, 8: 1, 16: 4, 32: 4}[spp]


def test_ragged_geometry_is_the_denoise_cli_default():
    args = denoise.parse_args(["--input", "x", "--checkpoint", "c",
                               "--output", "o.exr"])
    geo = bench.geometry(tiling="ragged")
    assert (geo.tile, geo.pad) == (args.tile_size, args.tile_pad) \
        == (512, 128)
    assert geo.n_tiles == 28
    frame = {"features": np.zeros((1, 1, 1, 1080, 1920), np.float32)}
    assert geo.shapes == [tb["features"].shape[-2:] for tb, *_ in
                          split_tiles(frame, max_sz=512, pad=128)]


def test_explicit_tile_takes_bench_pad_default():
    geo = bench.geometry(tile=(640, 2048), h=1080, w=1920)
    assert (geo.tile, geo.pad) == ((640, 2048), (160, 512))
    geo = bench.geometry(tile=768, pad=64, h=1080, w=1920)
    assert (geo.tile, geo.pad, geo.n_tiles) == ((768, 768), (64, 64), 6)


@pytest.mark.parametrize("argv,metric", [
    ([], "1080p_2spp_denoise_frames_per_sec_per_chip"),
    (["--tiling", "ragged", "--tile", "40", "--pad", "8", "--f32"],
     "1080p_2spp_denoise_frames_per_sec_per_chip"),
    (["--model", "kpcn", "--f32"],
     "1080p_kpcn_denoise_frames_per_sec_per_chip")],
    ids=["sbmc_uniform_bf16", "sbmc_ragged_f32", "kpcn_f32"])
def test_cpu_run_prints_one_bench_line(argv, metric, capsys):
    res = bench.main(bench.parse_args(
        ["--device", "cpu", "--height", "48", "--width", "64", "--spp", "2",
         "--ksize", "5", "--iters", "2", "--warmup", "1"] + argv))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(
        json.dumps(res))
    assert BENCH_KEYS <= set(res)
    assert res["metric"] == metric and res["unit"] == "frames/s"
    assert res["baseline_estimate"] is True and res["baseline_fps"] == 0.5
    assert res["resolution"] == [48, 64] and res["spp"] == 2
    assert res["device"] == "cpu" and len(res["frame_ms"]) == 2
    fps = 1e3 / float(np.median(res["frame_ms"]))
    assert np.isfinite(res["value"]) and res["value"] > 0
    assert abs(res["value"] - fps) <= 1e-4 * max(1.0, fps)
    assert res["vs_baseline"] == round(res["value"] / 0.5, 3)
    assert res["tiling"] == ("ragged" if "ragged" in argv else "uniform")
    assert res["precision"] == ("f32" if "--f32" in argv else "bf16")


def test_bench_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(bench.parse_args(["--height", "48", "--width", "64"]))


@pytest.mark.parametrize("tiling", ["uniform", "ragged"])
def test_frame_is_the_denoise_cli_frame(tiling):
    rng = np.random.RandomState(0)
    spp, h, w, tile, pad = 2, 48, 56, 40, 8
    batch = {
        "radiance": rng.rand(1, spp, 3, h, w).astype(np.float32),
        "features": rng.rand(1, spp, bench.N_FEATURES, h, w).astype(
            np.float16).astype(np.float32),
        "global_features": rng.rand(1, bench.N_GLOBAL, 1, 1).astype(
            np.float16).astype(np.float32),
        "low_spp": np.zeros((1, 3, h, w), np.float32)}
    model = bench.build_model("sbmc", ksize=5, f32=True, seed=0).eval()
    geo = bench.geometry("sbmc", spp, h, w, tiling, tile, pad)
    if tiling == "uniform":
        stacked, _ = split_tiles_uniform(batch, tile=tile, pad=pad)
        tiles = [{k: v[i:i + 1] for k, v in stacked.items()}
                 for i in range(geo.n_tiles)]
    else:
        tiles = [tb for tb, *_ in split_tiles(batch, max_sz=tile, pad=pad)]
    assert len(tiles) == geo.n_tiles > 1

    def make_tile(i, shape):
        t = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in tiles[i].items() if k != "low_spp"}
        assert tuple(t["features"].shape[-2:]) == shape
        return t

    args = denoise.parse_args(
        ["--input", "x", "--checkpoint", "c", "--output", "o.exr",
         "--tile_size", str(tile), "--tile_pad", str(pad), "--device",
         "cpu"] + (["--uniform_tiles"] if tiling == "uniform" else []))
    run = (denoise._denoise_uniform if tiling == "uniform"
           else denoise._denoise_ragged)
    with torch.inference_mode():
        got = bench.merge_frame(bench.run_frame(model, geo, make_tile), geo)
        want, _, n = run(model, batch, args, torch.device("cpu"))
    assert n == geo.n_tiles and got.shape == (1, 3, h, w)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[..., 2:-2, 2:-2]).min() > 0
