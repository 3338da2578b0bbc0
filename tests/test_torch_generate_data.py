"""``python -m sbmc_tpu_torch.generate_training_data`` against
``scripts/generate_training_data.py`` on the CPU.

``--renderer wavefront`` (the JAX script run as a subprocess): the same
file names and headers, and records within the tile tolerance of
``tests/test_torch_pathtracer.py`` (the scenes come with whatever textures
the seed draws, value noise included, so radiance and albedo are held to
its TEX_SHARE bounds and the rest to GEO_SHARE).

``--renderer pbrt`` (both CLIs as subprocesses with timeouts, with the
``pbrt`` and ``obj2pbrt`` stand-ins of ``sbmc_tpu_torch.pbrt_stand_ins``,
test doubles for binaries the repo does not hold): the same scene files
after ``pbrt_stand_ins.normalise_scene`` (each ``uuid4`` id becomes
``UUID<n>`` by order of first appearance, the repo's assets folder
``<ASSETS>``), the same ``.bin`` files, the cleaning, the sharding, and the
digest of scenes 0 and 1 that ``chip_smoke.py`` holds the card's machine
to.
"""

import importlib.util
import multiprocessing
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from sbmc_tpu_torch import generate_training_data as gtd
from sbmc_tpu_torch import pbrt_stand_ins
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


# -- the PBRT branch ----------------------------------------------------------

#: A small PBRT-branch configuration: 32x32 crops in tiles of 16 pixels.
PBRT_ARGS = ["--width", "32", "--height", "32", "--tile_size", "16",
             "--spp", "2", "--gt_spp", "4"]
#: The CLI's defaults, at which chip_smoke.py synthesizes scenes 0 and 1.
DEFAULT_RENDER = dict(spp=32, gt_spp=512, height=512, width=512,
                      path_depth=5, tile_size=128)
#: Seconds a datagen subprocess may take.
DATAGEN_TIMEOUT = 300
#: Runs scripts/generate_training_data.py with its two Pools kept
#: referenced. The script drops them, and on Python >= 3.8 a Pool that is
#: collected terminates its workers at once: as written it would wait at
#: ``scene_queue.join()`` forever.
_JAX_DATAGEN = """
import multiprocessing, runpy, sys
kept = []
_pool = multiprocessing.Pool
def Pool(*a, **k):
    kept.append(_pool(*a, **k))
    return kept[-1]
multiprocessing.Pool = Pool
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
#: Runs the port's CLI and fails if a worker process outlived it.
_PORT_DATAGEN = """
import multiprocessing, sys
from sbmc_tpu_torch import generate_training_data as g
records = g.main(g.parse_args(sys.argv[1:]))
assert not multiprocessing.active_children(), multiprocessing.active_children()
print("records", len(records), sum(r["ok"] for r in records))
"""


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    """(pbrt, obj2pbrt, assets lists folder)."""
    root = tmp_path_factory.mktemp("stand_ins")
    pbrt, obj2pbrt = pbrt_stand_ins.install(str(root / "bin"))
    lists = pbrt_stand_ins.write_asset_lists(str(root / "assets"), ASSETS)
    return pbrt, obj2pbrt, lists


def _datagen(jax, stand_ins, out, *extra):
    code = _JAX_DATAGEN if jax else _PORT_DATAGEN
    script = ["scripts/generate_training_data.py"] if jax else []
    proc = subprocess.run(
        [sys.executable, "-c", code] + script + list(stand_ins) + [out]
        + PBRT_ARGS + list(extra), cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=DATAGEN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _scene_text(path):
    with open(path) as f:
        return pbrt_stand_ins.normalise_scene(f.read(),
                                              [(ASSETS, "<ASSETS>")])


def _scenes(out):
    """{normalised scene.pbrt: {file: bytes of its .bin tiles}} of the
    scene folders of ``out``, with the normalised geometry listing."""
    scenes = {}
    for d in sorted(os.listdir(out)):
        sdir = os.path.join(out, d)
        bins = {f: open(os.path.join(sdir, f), "rb").read()
                for f in os.listdir(sdir) if f.endswith(".bin")}
        geo = sorted(pbrt_stand_ins.normalise_scene(f) for f in os.listdir(
            os.path.join(sdir, "geometry")))
        scenes[_scene_text(os.path.join(sdir, "scene.pbrt"))] = (bins, geo)
    return scenes


@pytest.fixture(scope="module")
def pbrt_corpora(stand_ins, tmp_path_factory):
    root = tmp_path_factory.mktemp("pbrt_datagen")
    outs = []
    for jax in (True, False):
        out = str(root / ("jax" if jax else "torch"))
        stdout = _datagen(jax, stand_ins, out, "--count", "2", "--threads",
                          "1", "--no-clean")
        outs.append(out)
    assert "records 2 2" in stdout
    return outs


def test_pbrt_cli_matches_jax_script(pbrt_corpora):
    """``--count 2 --threads 1 --no-clean``: the same normalised scene
    files, converted geometry and ``.bin`` tiles (the stand-in seeds them
    from the normalised scene, so they agree byte for byte)."""
    want, got = (_scenes(out) for out in pbrt_corpora)
    assert len(got) == 2
    assert sorted(got) == sorted(want)
    for text, (bins, geo) in got.items():
        assert sorted(bins) == ["0000_0000.bin", "0000_0001.bin",
                                "0001_0000.bin", "0001_0001.bin"]
        assert bins == want[text][0]
        assert geo == want[text][1] and geo
        assert '"integer recordedsamples" [2]' in text
        assert "<ASSETS>/envmaps/" in text and "UUID0" in text
    tile = bin_format.read_tile(os.path.join(
        pbrt_corpora[1], sorted(os.listdir(pbrt_corpora[1]))[0],
        "0001_0001.bin"))
    assert tile.features.shape == (2, 27, 16, 16)
    assert (tile.image_width, tile.gt_sample_count, tile.block_x,
            tile.block_y) == (32, 4, 16, 16)


def test_pbrt_cli_cleans(stand_ins, tmp_path):
    """With cleaning on (two threads) only the ``.bin`` tiles are left, and
    the command returns with no worker process alive."""
    out = str(tmp_path / "out")
    assert "records 2 2" in _datagen(False, stand_ins, out, "--count", "2",
                                     "--threads", "2", "--batch_size", "2")
    dirs = os.listdir(out)
    assert len(dirs) == 2
    for d in dirs:
        assert sorted(os.listdir(os.path.join(out, d))) == [
            "0000_0000.bin", "0000_0001.bin", "0001_0000.bin",
            "0001_0001.bin"]


def test_pbrt_workers_shard_disjoint(stand_ins, tmp_path):
    """Two workers at ``--count 2 --num_workers 2`` make disjoint scenes
    whose union is what one worker makes at ``--count 4`` (scene ``idx =
    start + s * workers + worker``, as in the JAX script)."""
    sets = []
    for w in (0, 1):
        out = str(tmp_path / ("w%d" % w))
        _datagen(False, stand_ins, out, "--count", "2", "--num_workers", "2",
                 "--worker_id", str(w), "--start_index", "3", "--no-clean")
        sets.append(set(_scenes(out)))
    one = str(tmp_path / "one")
    _datagen(False, stand_ins, one, "--count", "4", "--start_index", "3",
             "--threads", "2", "--batch_size", "4", "--no-clean")
    assert len(sets[0]) == len(sets[1]) == 2
    assert not sets[0] & sets[1]
    assert sets[0] | sets[1] == set(_scenes(one))


class _Done(Exception):
    pass


class _Feed:
    """A queue that hands out ``items`` and then stops the JAX script's
    worker loop."""

    def __init__(self, items):
        self.items = list(items)

    def get(self, block=True):
        if not self.items:
            raise _Done
        return self.items.pop(0)

    def task_done(self):
        pass


class _Sink(list):
    def put(self, item, block=True):
        self.append(item)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_digest_matches_chip_smoke(stand_ins, tmp_path):
    """Scenes 0 and 1 at the CLI's defaults (512x512 and its scale and
    crop, 32/512 spp, tiles of 128) with the obj2pbrt stand-in, drawn by the
    JAX script's own worker loop and by the port: the digest of their
    normalised scene files is the constant chip_smoke.py holds the card's
    machine to."""
    jgtd = _load("scripts/generate_training_data.py", "jax_datagen")
    smoke = _load("chip_smoke.py", "chip_smoke")
    digests = []
    for name, module in (("jax", jgtd), ("torch", gtd)):
        args = gtd.parse_args(list(stand_ins) + [str(tmp_path / name)])
        params = module.GeneratorParams(args)
        items = [{"idx": i, "gen_params": params,
                  "render_params": DEFAULT_RENDER, "verbose": False,
                  "clean": False} for i in (0, 1)]
        if module is jgtd:
            sink = _Sink()
            with pytest.raises(_Done):
                jgtd.create_scene_file(_Feed(items), sink)
            assert len(sink) == 2
        else:
            assert all(gtd.synthesize(item) for item in items)
        texts = [_scene_text(os.path.join(args.output, d, "scene.pbrt"))
                 for d in os.listdir(args.output)]
        digests.append(pbrt_stand_ins.scene_digest(texts))
    assert digests[1] == digests[0] == smoke.PBRT_SCENE_DIGEST


def test_pbrt_cli_checks(stand_ins, tmp_path):
    """Unknown generators, and SunCG without ``--suncg_root``, fail before
    any worker starts."""
    argv = list(stand_ins) + [str(tmp_path / "o")] + PBRT_ARGS
    with pytest.raises(RuntimeError, match="Unknown generator"):
        gtd.main(gtd.parse_args(argv + ["--generators", "NoSuchGenerator"]))
    with pytest.raises(RuntimeError, match="--suncg_root"):
        gtd.main(gtd.parse_args(argv + ["--generators",
                                        "SunCGSceneGenerator"]))
    assert not multiprocessing.active_children()


def test_render_scene_outcomes(stand_ins, tmp_path):
    """The render worker's three outcomes: tiles (cleaned to the tiles), a
    failed pbrt (the folder stays, as in the JAX script) and a render that
    wrote no tile (the folder goes)."""
    pbrt, obj2pbrt, lists = stand_ins
    params = gtd.GeneratorParams(gtd.parse_args(
        [pbrt, obj2pbrt, lists, str(tmp_path / "out")]))
    render_params = dict(DEFAULT_RENDER, width=32, height=32, tile_size=16,
                         spp=2, gt_spp=4)

    def scene(idx, **kw):
        sdir = gtd.synthesize({"idx": idx, "gen_params": params,
                               "render_params": render_params})
        return dict({"idx": idx, "gen_params": params, "scene_dir": sdir,
                     "verbose": False, "clean": True}, **kw)

    data = scene(0)
    assert gtd.render_scene(data)
    assert all(f.endswith(".bin") for f in os.listdir(data["scene_dir"]))
    data = scene(1)
    os.rename(os.path.join(data["scene_dir"], "geometry"),
              os.path.join(data["scene_dir"], "moved"))
    assert not gtd.render_scene(data)
    assert os.path.exists(os.path.join(data["scene_dir"], "scene.pbrt"))
    params.renderer = "/bin/true"
    data = scene(2)
    assert not gtd.render_scene(data)
    assert not os.path.exists(data["scene_dir"])
