"""``python -m sbmc_tpu_torch.generate_training_data --renderer wavefront``
against ``scripts/generate_training_data.py --renderer wavefront`` (run as
a subprocess on the CPU): the same file names and headers, and records
within the tile tolerance of ``tests/test_torch_pathtracer.py`` (the
scenes come with whatever textures the seed draws, value noise included,
so radiance and albedo are held to its TEX_SHARE bounds and the rest to
GEO_SHARE).
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from sbmc_tpu_torch import generate_training_data as gtd
from sbmc_tpu_torch.data import bin_format

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
ARGS = ["-", "-", ASSETS, None, "--renderer", "wavefront", "--count", "1",
        "--start_index", "2", "--width", "32", "--height", "16",
        "--tile_size", "16", "--spp", "2", "--gt_spp", "4", "--obj_dir",
        os.path.join(ASSETS, "objs"), "--tex_dir",
        os.path.join(ASSETS, "textures"), "--env_dir",
        os.path.join(ASSETS, "envmaps")]
#: Shares of samples allowed beyond 1e-3 + 1e-3 |JAX| (see
#: tests/test_torch_pathtracer.py for their derivation).
GEO_SHARE, TEX_SHARE, PIX_TEX_SHARE = 0.02, 0.30, 0.50


def _argv(out):
    return [out if a is None else a for a in ARGS]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _header(path):
    with open(path, "rb") as f:
        return (struct.unpack("9i", f.read(36)), struct.unpack("4f",
                                                               f.read(16)),
                struct.unpack("2i", f.read(8)))


def _share(got, want, axis):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(axis).mean()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("datagen")
    jout, tout = str(root / "jax"), str(root / "torch")
    proc = subprocess.run(
        [sys.executable, "scripts/generate_training_data.py"] + _argv(jout),
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats, count = gtd.main(gtd.parse_args(_argv(tout) + ["--device",
                                                          "cpu"]))
    assert count == 1 and stats["total"] > 0
    return jout, tout


def test_same_files_and_headers(corpora):
    jout, tout = corpora
    names = _files(jout)
    assert names == _files(tout)
    assert names == ["scene_00002/tile_0000_0000.bin",
                     "scene_00002/tile_0000_0001.bin"]
    for name in names:
        (ji, jf, jb), (ti, tf, tb) = (_header(os.path.join(jout, name)),
                                      _header(os.path.join(tout, name)))
        assert ji == ti and jb == tb
        np.testing.assert_allclose(tf, jf, rtol=1e-6)


def test_records_within_tile_tolerance(corpora):
    jout, tout = corpora
    for name in _files(jout):
        want = bin_format.read_tile(os.path.join(jout, name))
        got = bin_format.read_tile(os.path.join(tout, name))
        # The camera draws are bit-exact; the lens position goes through
        # cos and sin.
        np.testing.assert_allclose(got.features[:, :5], want.features[:, :5],
                                   rtol=1e-6, atol=1e-7)
        assert _share(got.features[:, 11:21], want.features[:, 11:21],
                      1) <= GEO_SHARE
        for part in (slice(5, 11), slice(21, 27)):
            assert _share(got.features[:, part], want.features[:, part],
                          1) <= TEX_SHARE
        assert _share(got.pixel_data, want.pixel_data, 0) <= PIX_TEX_SHARE
        for rec in ("p", "ld", "bt"):
            assert _share(getattr(got, rec), getattr(want, rec),
                          1) <= GEO_SHARE, rec


def test_pbrt_renderer_raises(tmp_path):
    argv = _argv(str(tmp_path))
    argv.remove("wavefront")
    argv.remove("--renderer")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        gtd.main(gtd.parse_args(argv + ["--device", "cpu"]))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        gtd.main(gtd.parse_args(argv + ["--renderer", "pbrt", "--device",
                                        "cpu"]))


def test_cli_checks(tmp_path):
    argv = _argv(str(tmp_path))
    with pytest.raises(ValueError, match="divide"):
        gtd.main(gtd.parse_args(argv + ["--tile_size", "12", "--device",
                                        "cpu"]))


#: A tiny configuration for the sharding test: one 16x16 tile a scene.
SHARD_ARGS = ["-", "-", ASSETS, None, "--renderer", "wavefront", "--width",
              "16", "--height", "16", "--tile_size", "16", "--spp", "1",
              "--gt_spp", "2", "--obj_dir", os.path.join(ASSETS, "objs"),
              "--device", "cpu"]


def _render(out, *extra):
    argv = [out if a is None else a for a in SHARD_ARGS] + list(extra)
    gtd.main(gtd.parse_args(argv))
    return {name: open(os.path.join(out, name), "rb").read()
            for name in _files(out)}


def test_workers_render_disjoint_scenes(tmp_path):
    """Two workers at ``--count 2 --num_workers 2`` render disjoint scenes
    (worker w: scenes start + 2 s + w), and together, file for file, what
    one worker renders at ``--count 4``. The JAX script's wavefront branch
    gives worker 1 worker 0's scenes 1..count-1 (a divergence ROADMAP.md
    records); at one worker the indices are the same."""
    workers = [_render(str(tmp_path / ("w%d" % w)), "--count", "2",
                       "--start_index", "3", "--num_workers", "2",
                       "--worker_id", str(w)) for w in (0, 1)]
    scenes = [{name.split("/")[0] for name in files} for files in workers]
    assert scenes == [{"scene_00003", "scene_00005"},
                      {"scene_00004", "scene_00006"}]
    one = _render(str(tmp_path / "one"), "--count", "4", "--start_index",
                  "3")
    assert sorted(one) == sorted(list(workers[0]) + list(workers[1]))
    for files in workers:
        for name, data in files.items():
            assert data == one[name], name
