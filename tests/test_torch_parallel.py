"""The port's data-parallel training and multi-device denoising, on the CPU
in gloo, against the JAX package's mesh.

Ranks run as separate processes (``tests/torch_rank_worker.py``, which
imports no JAX, or ``python -m torch.distributed.run --standalone``), one
thread each, each under its own deadline of ``RANK_TIMEOUT`` seconds, so a
hang fails the test instead of using up the suite's clock. Rendezvous goes
through a ``FileStore`` in the test's temporary directory, or torchrun's
``--standalone`` free port: never a fixed port.

Tolerances are ``tests/test_torch_train.py``'s for one float32 step:
metrics within 1e-5 relative; every gradient within ``1e-6 + 1e-3 *
|want|``; Adam's moments within ``1e-9 + 2e-3 * |want|``; the update,
where ``|g| > 1e-5``, within 2% of the learning rate. Between ranks the
gradients, moments and parameters are equal: every rank takes the same
all-reduced gradient. Against the port's own single-process step on the
global batch (the other modes, two steps) the same tolerances hold. Denoised
frames: equal for every device count; against the JAX script, ``atol 1e-3,
rtol 2e-3`` (two half units, as ``tests/test_torch_denoise.py`` states).
"""

import csv
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.data import Loader as JLoader
from sbmc_tpu.models import KPCN as JKPCN
from sbmc_tpu.models import LBF as JLBF
from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.parallel.mesh import make_mesh, replicate
from sbmc_tpu.train import Checkpointer as JCheckpointer
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu.utils import exr
from sbmc_tpu_torch import denoise, train_cli
from sbmc_tpu_torch.data import Loader, TilesDataset
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.parallel import mesh
from sbmc_tpu_torch.params import (export_adam_state, export_jax_params,
                                   flatten, load_jax_params)
from sbmc_tpu_torch.train import DenoiserInterface
from tests.test_torch_denoise import FLAGS, setup  # noqa: F401
from tests.test_torch_kpcn import SMALL_KPCN, _kpcn_batch
from tests.test_torch_train import (LR, SMALL, _jax_state, _np_tree,
                                    _random_params)
from tests.torch_rank_worker import grads_of

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_rank_worker.py")
RANK_TIMEOUT = 120
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
for _var in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT") + mesh.JAX_VARS:
    ENV.pop(_var, None)

#: The port's other modes, each trained two steps on two ranks.
MODES = {
    "sbmc": ("sbmc", SMALL),
    "gather": ("sbmc", dict(SMALL, splat=False)),
    "pixel": ("sbmc", dict(SMALL, pixel=True)),
    "kpcn": ("kpcn", SMALL_KPCN),
    "lbf": ("lbf", dict(n_features=8, n_global_features=3, window_r=2,
                        width=8)),
}


def _sbmc_batch(rng, bs=4, spp=3, h=16, w=16):
    """A global batch whose items have 3, 2, 3 and 2 valid samples."""
    return {"radiance": rng.rand(bs, spp, 3, h, w).astype(np.float32),
            "features": rng.rand(bs, spp, 8, h, w).astype(np.float16),
            "global_features": rng.rand(bs, 3, 1, 1).astype(np.float32),
            "target_image": rng.rand(bs, 3, h, w).astype(np.float32),
            "sample_mask": np.arange(spp)[None] < np.array(
                [3, 2, 3, 2])[:bs, None]}


def _start_ranks(tmp, spec, world=2):
    """Start ``world`` rank workers on ``spec``; returns what
    :func:`_wait_ranks` takes."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec_path = str(tmp / "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    outs = [str(tmp / ("rank%d.pkl" % r)) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, spec_path, str(r), str(world),
         str(tmp / "store"), outs[r]], cwd=ROOT, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return procs, outs, time.monotonic() + RANK_TIMEOUT


def _wait_ranks(started, ok=True):
    """Wait for every rank (each by the deadline); returns each rank's
    results when ``ok``, else each rank's ``(returncode, stderr)``."""
    procs, outs, deadline = started
    ended = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            ended.append((p.returncode, err))
    except subprocess.TimeoutExpired:
        pytest.fail("rank %d did not end within %d s" % (len(ended),
                                                         RANK_TIMEOUT))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if not ok:
        return ended
    for r, (rc, err) in enumerate(ended):
        assert rc == 0, "rank %d: %s" % (r, err[-3000:])
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _assert_ranks_agree(ranks):
    for k in ("grads", "opt", "params"):
        for path, want in ranks[0][k].items():
            np.testing.assert_array_equal(ranks[1][k][path], want,
                                          err_msg=k + " " + path)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def _assert_step_matches(got, grads, opt, before, after, g_atol=1e-6):
    """A rank's gradient, Adam state and update against a reference's
    (flat dicts in the flax layout), at the module's tolerances."""
    assert set(got["grads"]) == set(grads) and len(grads) > 10
    for path, want in grads.items():
        np.testing.assert_allclose(got["grads"][path], want, atol=g_atol,
                                   rtol=1e-3, err_msg=path)
    assert set(got["opt"]) == set(opt)
    for path, want in opt.items():
        np.testing.assert_allclose(got["opt"][path], want, atol=1e-9,
                                   rtol=2e-3, err_msg=path)
    compared = 0
    for path, g in grads.items():
        big = np.abs(g) > 1e-5
        compared += int(big.sum())
        np.testing.assert_allclose((got["params"][path] - before[path])[big],
                                   (after[path] - before[path])[big],
                                   atol=0.02 * LR, err_msg=path)
    assert compared > 100


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """One float32 step of SBMC and of KPCN on a global batch of 4: on two
    port ranks (gloo), on JAX's ``make_mesh(2)`` and as JAX's single-device
    gradient; and two steps of every mode on two port ranks. The ranks run
    while JAX compiles."""
    tmp = tmp_path_factory.mktemp("meshes")
    cases = {}
    rng = np.random.RandomState(0)
    sbmc = _sbmc_batch(rng)
    cases["sbmc"] = (JMultisteps(**SMALL), "sbmc", SMALL, sbmc,
                     _random_params(JMultisteps(**SMALL), sbmc, seed=1))
    kpcn = _kpcn_batch(rng, bs=4)
    cases["kpcn"] = (JKPCN(**SMALL_KPCN), "kpcn", SMALL_KPCN, kpcn,
                     _random_params(JKPCN(**SMALL_KPCN), kpcn, seed=2))
    # Two steps of each mode, from the port's own initialisation.
    batches = {"kpcn": [_kpcn_batch(rng, bs=4) for _ in range(2)]}
    for _ in range(2):
        b = _sbmc_batch(rng)
        for name in ("sbmc", "gather", "pixel", "lbf"):
            batches.setdefault(name, []).append(b)
    modes = {}
    for name, (arch, kw) in MODES.items():
        torch.manual_seed(0)
        params = export_jax_params(build_model(
            {"arch": arch, "model_params": kw}))
        modes[name] = (arch, kw, params, batches[name])
    jobs = [{"arch": arch, "model": kw, "params": params, "lr": LR,
             "batches": [batch]}
            for _, arch, kw, batch, params in cases.values()]
    jobs += [{"arch": a, "model": kw, "params": p, "lr": LR, "batches": b}
             for a, kw, p, b in modes.values()]
    started = _start_ranks(tmp, {"jobs": jobs})

    jax_side = {}
    m2 = make_mesh(2)
    for name, (jmodel, _, _, batch, params) in cases.items():
        single = JInterface(jmodel, lr=LR)
        state = _jax_state(single, params)
        arrays = single._arrays_only(batch)
        (loss, (rmse, base)), grads = jax.jit(jax.value_and_grad(
            single._losses, has_aux=True))(state.params, arrays)
        on_mesh = JInterface(jmodel, lr=LR, mesh=m2)
        mstate, mmetrics = on_mesh.train_step(
            replicate(_jax_state(on_mesh, params), m2), batch)
        jax_side[name] = dict(
            single={"loss": loss, "rmse": rmse, "input_loss": base},
            grads=_np_tree(grads["params"]), mesh=mmetrics,
            opt=_np_tree(mstate.opt_state),
            after=_np_tree(mstate.params["params"]),
            before=flatten(params["params"]))
    ranks = _wait_ranks(started)
    return dict(cases=cases, jax=jax_side, modes=modes,
                ranks={name: [r[i] for r in ranks]
                       for i, name in enumerate(cases)},
                mode_ranks=[r[len(cases):] for r in ranks])


@pytest.mark.parametrize("name", ["sbmc", "kpcn"])
def test_two_ranks_match_the_jax_mesh_step(meshes, name):
    ranks, j = meshes["ranks"][name], meshes["jax"][name]
    _assert_ranks_agree(ranks)
    for r in ranks:
        assert r["step"] == 1
        for k in ("loss", "rmse", "input_loss"):
            np.testing.assert_allclose(r["metrics"][0][k],
                                       float(j["mesh"][k]), rtol=1e-5,
                                       atol=1e-12)
            np.testing.assert_allclose(r["metrics"][0][k],
                                       float(j["single"][k]), rtol=1e-5,
                                       atol=1e-12)
        _assert_step_matches(r, j["grads"], j["opt"], j["before"],
                             j["after"])


@pytest.mark.parametrize("name", ["sbmc", "kpcn"])
def test_every_rank_logs_the_global_mean(meshes, name):
    """Each rank's loss is the global batch's, not its own half's."""
    _, arch, kw, batch, params = meshes["cases"][name]
    model = load_jax_params(build_model({"arch": arch, "model_params": kw}),
                            params)
    iface = DenoiserInterface(model, lr=LR, device="cpu")
    halves = [float(iface.eval_step({k: v[h:h + 2] for k, v in
                                     batch.items()})["loss"])
              for h in (0, 2)]
    losses = [r["metrics"][0]["loss"] for r in meshes["ranks"][name]]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], np.mean(halves), rtol=1e-6)
    assert min(abs(losses[0] - h) for h in halves) > 1e-3 * losses[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_every_mode_trains_on_two_ranks(meshes, mode):
    """Two steps of each mode on two ranks against one process on the
    global batches: DDP needs no search for unused parameters in any mode
    (it would raise in the second step), and the ranks agree."""
    i = list(MODES).index(mode)
    ranks = [r[i] for r in meshes["mode_ranks"]]
    arch, kw, params, batches = meshes["modes"][mode]
    _assert_ranks_agree(ranks)
    model = load_jax_params(build_model({"arch": arch, "model_params": kw}),
                            params)
    iface = DenoiserInterface(model, lr=LR, device="cpu")
    before = flatten(export_jax_params(model)["params"])
    metrics = [iface.train_step(b) for b in batches]
    for got, want in zip(ranks[0]["metrics"], metrics):
        for k in ("loss", "rmse", "input_loss"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                       atol=1e-12)
    _assert_step_matches(
        ranks[0], grads_of(model),
        flatten(export_adam_state(model, iface.optimizer)), before,
        flatten(export_jax_params(model)["params"]))


def test_a_nan_on_one_rank_stops_both(tmp_path):
    """A non-finite loss on rank 1's shard alone: the step's metrics are
    the global means, so both ranks' finite-loss guards raise at the same
    step, and neither waits for the other in a collective."""
    rng = np.random.RandomState(3)
    batches = [_sbmc_batch(rng) for _ in range(3)]
    batches[1]["target_image"][3] = np.nan
    torch.manual_seed(0)
    params = export_jax_params(build_model({"arch": "sbmc",
                                            "model_params": SMALL}))
    ended = _wait_ranks(_start_ranks(tmp_path, {
        "arch": "sbmc", "model": SMALL, "params": params, "lr": LR,
        "batches": batches, "trainer": True}), ok=False)
    for r, (rc, err) in enumerate(ended):
        assert rc != 0 and "Loss is not finite (nan)" in err, (r, err[-3000:])


def test_loader_shards_are_equal_and_disjoint(tmp_path):
    """Deliberate divergence from the JAX loader: when the shard count does
    not divide the items, every shard keeps ``len // num_shards`` of them
    (the JAX loader's first shard has one more, and its process would take
    one more step than the others). Where it divides, the two agree."""
    data = str(tmp_path / "d")
    generate_dataset(data, n_scenes=1, ts=8, tiles_per_side=3, spp=2,
                     gt_spp=2, seed=4)
    ds = TilesDataset(data, spp=2)
    assert len(ds) == 9
    for world in (2, 3, 4):
        shards = [Loader(ds, batch_size=1, shard_id=r, num_shards=world)
                  ._indices() for r in range(world)]
        jshards = [JLoader(ds, batch_size=1, shard_id=r, num_shards=world)
                   ._indices() for r in range(world)]
        assert [len(s) for s in shards] == [9 // world] * world
        assert len(set(np.concatenate(shards))) == 9 // world * world
        for s, j in zip(shards, jshards):
            np.testing.assert_array_equal(s, j[:9 // world])
        assert (9 % world == 0) == all(len(j) == 9 // world
                                       for j in jshards)


def _log_lines(text, needle):
    return [ln for ln in text.splitlines() if needle in ln]


def test_cli_trains_on_two_ranks_then_resumes(tmp_path):
    """``torchrun --nproc_per_node 2 -m sbmc_tpu_torch.train --device cpu``
    on 9 tiles (2 does not divide them): each rank reads 4 items of its
    own and takes 4 steps an epoch of the per-process batch of 1 (the JAX
    loader's shards of 5 and 4 items would end rank 1's epoch a step early
    and leave rank 0 waiting in the all-reduce); rank 0 alone writes the
    log, the strips and the checkpoint, which the JAX package's
    Checkpointer reads and a one-process port run resumes. The model is
    LBF, whose checkpoints are kilobytes where the flagship's are 417 MB:
    the CLI's machinery is the same for every model, and the SBMC step on
    two ranks is held to JAX's mesh above."""
    data, ckpt = str(tmp_path / "d"), str(tmp_path / "ck")
    generate_dataset(data, n_scenes=1, ts=16, tiles_per_side=3, spp=4,
                     gt_spp=8, seed=5)
    argv = [data, ckpt, "--spp", "4", "--lbf_mode", "--lbf_window_r", "2",
            "--bs", "1",
            "--log_interval", "1", "--num_worker_threads", "1", "--device",
            "cpu"]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "--log-dir", str(tmp_path / "logs"),
             "-m", "sbmc_tpu_torch.train", *argv,
             "--max_steps", "5"], cwd=ROOT, env=ENV, capture_output=True,
            text=True, timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail("torchrun did not end within %d s" % RANK_TIMEOUT)
    err = proc.stderr
    assert proc.returncode == 0, err[-3000:]
    for r in (0, 1):
        line = _log_lines(err, "Data-parallel: process %d of 2" % r)
        assert len(line) == 1 and ("items %d::2 (4 of 9), 4 steps an epoch "
                                   "of 2 x 1" % r) in line[0], line
    # One writer: each step logged once, one strip an epoch.
    assert len(_log_lines(err, " step 5 | loss=")) == 1
    assert len(_log_lines(err, "wrote display strip")) == 2
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        assert [r["step"] for r in csv.DictReader(f)] == list("12345")
    assert sorted(os.listdir(os.path.join(ckpt, "viz"))) == [
        "epoch_0000.png", "epoch_0001.png"]
    assert {"final.msgpack", "ckpt_000000005.msgpack", "meta.json"} <= set(
        os.listdir(ckpt))
    # The JAX package reads the checkpoint.
    meta = JCheckpointer.load_meta(ckpt)
    assert meta["arch"] == "lbf"
    jmodel = JLBF(**meta["model_params"])
    batch = {"radiance": jnp.zeros((1, 4, 3, 16, 16)),
             "features": jnp.zeros((1, 4, 93, 16, 16)),
             "global_features": jnp.zeros((1, 3, 1, 1))}
    template = _jax_state(JInterface(jmodel), _random_params(
        jmodel, batch, seed=0))
    restored, step = JCheckpointer(ckpt).load_latest(template)
    assert step == 5 and int(restored.step) == 5
    # One process resumes it.
    iface = train_cli.main(train_cli.parse_args(argv + ["--max_steps", "6"]))
    assert iface.step == 6
    got = flatten(export_jax_params(iface.model)["params"])
    assert set(got) == set(_np_tree(restored.params["params"]))
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        assert [r["step"] for r in csv.DictReader(f)] == list("123456")


@pytest.fixture(scope="module")
def frames(setup):  # noqa: F811
    """The denoised frame of ``tests/test_torch_denoise.py``'s setup at 1, 2
    and 3 devices on the CPU, ragged and uniform tiles; and the JAX
    script's at ``--num_devices 2`` (its forced CPU devices), run while
    the port's are made."""
    root, data, ckpt = setup
    jax_runs = {}
    for tiling, extra in (("ragged", []), ("uniform", ["--uniform_tiles"])):
        out = str(root / ("jax2_%s.exr" % tiling))
        jax_runs[tiling] = (out, subprocess.Popen(
            [sys.executable, "scripts/denoise.py", "--input", data,
             "--checkpoint", ckpt, "--output", out, "--num_devices", "2",
             *FLAGS, *extra], cwd=ROOT, env=dict(ENV, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    port = {}
    for tiling, extra in (("ragged", []), ("uniform", ["--uniform_tiles"])):
        for n in (1, 2, 3):
            out = str(root / ("port%d_%s.exr" % (n, tiling)))
            res = denoise.main(denoise.parse_args(
                ["--input", data, "--checkpoint", ckpt, "--output", out,
                 "--device", "cpu", "--num_devices", str(n), *FLAGS,
                 *extra]))
            assert res[0]["tiles"] == 4
            port[tiling, n] = exr.read(out)
    jax_frames = {}
    for tiling, (out, proc) in jax_runs.items():
        try:
            _, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        jax_frames[tiling] = exr.read(out)
    return port, jax_frames


@pytest.mark.parametrize("tiling", ["ragged", "uniform"])
@pytest.mark.parametrize("n", [2, 3])
def test_denoise_frame_does_not_depend_on_devices(frames, tiling, n):
    port, _ = frames
    one = port[tiling, 1]
    assert one.shape == (64, 64, 3) and np.abs(one).max() > 0
    np.testing.assert_array_equal(port[tiling, n], one)


@pytest.mark.parametrize("tiling", ["ragged", "uniform"])
def test_denoise_on_two_devices_matches_jax(frames, tiling):
    port, jax_frames = frames
    np.testing.assert_allclose(port[tiling, 2], jax_frames[tiling],
                               atol=1e-3, rtol=2e-3)


def test_denoise_spreads_tiles_over_replicas():
    """Ragged tile i runs on replica i % N; uniform tiles in contiguous
    shards of ceil(tiles / N), the last short (the JAX mesh's padded copies
    are not run)."""
    calls = []

    class Tagged(torch.nn.Module):
        def __init__(self, tag):
            super().__init__()
            self.tag = tag

        def forward(self, b):
            calls.append((self.tag, int(b["radiance"].flatten()[0])))
            return {"radiance": b["radiance"].mean(1)}

    h, w, side = 8, 20, 4
    batch = {"radiance": np.arange(h * w, dtype=np.float32).reshape(
        1, 1, 1, h, w).repeat(3, 2),
             "features": np.zeros((1, 1, 2, h, w), np.float32),
             "global_features": np.zeros((1, 3, 1, 1), np.float32),
             "low_spp": np.zeros((1, 3, h, w), np.float32)}
    # Tile t starts at pixel value (t // 5 * side) * w + t % 5 * side.
    tile_of = {(t // 5 * side) * w + t % 5 * side: t for t in range(10)}
    cpu = torch.device("cpu")
    for run, extra in ((denoise.denoise_ragged, []),
                       (denoise.denoise_uniform, ["--uniform_tiles"])):
        args = denoise.parse_args(
            ["--input", "x", "--checkpoint", "c", "--output", "o.exr",
             "--tile_size", str(side), "--tile_pad", "0", *extra])
        frames = []
        for n in (1, 2, 4):
            calls.clear()
            frame, _, tiles = run([Tagged(d) for d in range(n)], batch,
                                  args, [cpu] * n)
            assert tiles == 10
            frames.append(frame)
            got = [(d, tile_of[v]) for d, v in calls]
            if run is denoise.denoise_ragged:
                assert got == [(t % n, t) for t in range(10)]
            else:
                # Enqueued tile by tile across the devices.
                per = -(-10 // n)
                assert got == [(d, d * per + i) for i in range(per)
                               for d in range(n) if d * per + i < 10]
        for f in frames[1:]:
            np.testing.assert_array_equal(f, frames[0])
        np.testing.assert_array_equal(frames[0], batch["radiance"][:, 0])


def test_refusals(monkeypatch, tmp_path):
    """No silent single process: the JAX script's multi-host variables
    without torchrun's raise, as do an incomplete torchrun environment, a
    torchrun run on ``cuda`` without a card, and more devices than exist
    (deliberate divergence: JAX's ``local_devices()[:n]`` gives fewer)."""
    for var in mesh.TORCHRUN_VARS + mesh.JAX_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SBMC_COORDINATOR", "host:1234")
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh.init_distributed("cpu")
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_cli.main(train_cli.parse_args(
            [str(tmp_path / "d"), str(tmp_path / "c"), "--device", "cpu"]))
    monkeypatch.delenv("SBMC_COORDINATOR")
    assert mesh.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="incomplete torchrun"):
        mesh.init_distributed("cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT"):
        mesh.init_distributed("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()
    assert mesh.local_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="at least 1"):
        mesh.local_devices("cpu", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.local_devices("cuda") == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert mesh.local_devices("cuda:1") == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="--num_devices 3 but 2 CUDA"):
        mesh.local_devices("cuda", 3)
