"""The port's KPCN, valid/plain conv chains, the gather ablation of
Multisteps and the kpcn/raw dataset modes against the JAX package, on the
same numpy inputs and parameters.

Tolerances:

- float32 models: ``2e-5 + 2e-5 * |jax|`` (conv sums in other orders), as
  for Multisteps in tests/test_torch_models.py (KPCN at full width measured
  1.4e-7 on outputs up to 0.17).
- bfloat16 convs: every conv output and the softmax are rounded to bfloat16
  at places that differ by one step between the frameworks: max abs 5e-3,
  mean abs 1e-3 on outputs up to 0.17 (measured 4.6e-4 and 1.8e-4).
- one float32 train step against the JAX ``DenoiserInterface``: loss and
  metrics within 1e-5 relative, every leaf's gradient within ``1e-6 + 1e-3 *
  |jax|``, as tests/test_torch_train.py states them.
- datasets: "raw" is data movement (exact); "kpcn" runs the same numpy
  expressions in the same order (exact).
- checkpoints: what one package writes the other reads back exactly.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.data import FullImagesDataset as JFullImagesDataset
from sbmc_tpu.data import TilesDataset as JTilesDataset
from sbmc_tpu.data import collate as jcollate
from sbmc_tpu.models import KPCN as JKPCN
from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.models.build import build_model as jbuild
from sbmc_tpu.nn import layers as jl
from sbmc_tpu.train import Checkpointer as JCheckpointer
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu.train import TrainState
from sbmc_tpu_torch import denoise
from sbmc_tpu_torch.data import (FullImagesDataset, Loader, TilesDataset,
                                 collate)
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.models.build import build_model, model_meta
from sbmc_tpu_torch.nn import layers as tl
from sbmc_tpu_torch.parallel import tiles
from sbmc_tpu_torch.params import export_jax_params, flatten, load_jax_params
from sbmc_tpu_torch.train import Checkpointer, DenoiserInterface

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

KPCN_KEYS = ("kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
             "kpcn_specular_buffer", "kpcn_albedo")
SMALL_KPCN = dict(n_in=27, ksize=5, depth=3, width=8)
SMALL_SBMC = dict(n_features=8, n_global_features=3, width=8,
                  embedding_width=8, ksize=3, nsteps=2)


def _kpcn_batch(rng, bs=2, h=19, w=22, n_in=27):
    b = {k: rng.rand(bs, n_in if k.endswith("_in") else 3, h, w).astype(
        np.float32) for k in KPCN_KEYS}
    b["target_image"] = rng.rand(bs, 3, h, w).astype(np.float32)
    return b


def _random_params(module, batch, seed):
    """Flax variables of ``module`` redrawn from a numpy seed (shapes from
    an abstract init, which compiles nothing)."""
    rng = np.random.RandomState(seed)
    arrays = batch if not isinstance(batch, dict) else {
        k: jnp.asarray(v) for k, v in batch.items() if hasattr(v, "ndim")}
    shapes = flax.core.unfreeze(jax.eval_shape(
        module.init, jax.random.PRNGKey(0), arrays))

    def redraw(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = redraw(v)
            elif k == "g":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = (rng.randn(*v.shape) / np.sqrt(
                    np.prod(v.shape[:-1]))).astype(np.float32)
        return out
    return redraw(shapes)


def _both(jmodel, tmodel, params, batch):
    jout = jmodel.apply(params, {k: jnp.asarray(v) for k, v in batch.items()})
    load_jax_params(tmodel, params)
    with torch.inference_mode():
        tout = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    return ({k: np.asarray(v, np.float32) for k, v in jout.items()},
            {k: v.float().numpy() for k, v in tout.items()})


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        flax.serialization.to_state_dict(tree)).items()}


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("weight_norm", [False, True])
@pytest.mark.parametrize("ksize,pad", [(5, False), (3, False), (3, True)])
def test_convchain_valid_and_plain_matches_flax(ksize, pad, weight_norm):
    x = np.random.RandomState(1).randn(2, 6, 15, 14).astype(np.float32)
    kw = dict(ksize=ksize, width=8, depth=3, pad=pad,
              weight_norm=weight_norm)
    jmod = jl.ConvChain(7, **kw)
    tmod = tl.ConvChain(6, 7, **kw)
    params = _random_params(jmod, jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    want = np.asarray(jmod.apply(params, jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    load_jax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    shrink = 0 if pad else 3 * (ksize - 1)
    assert got.shape == want.shape == (2, 7, 15 - shrink, 14 - shrink)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    names = {n for n, _ in tmod.named_parameters()}
    assert ("layer_0.g" in names) == weight_norm
    assert {"layer_0.v", "layer_1.bias", "prediction.v"} <= names


# -- KPCN ---------------------------------------------------------------------

def test_small_kpcn_matches_jax():
    rng = np.random.RandomState(0)
    batch = _kpcn_batch(rng)
    del batch["target_image"]
    jm = JKPCN(**SMALL_KPCN)
    params = _random_params(jm, batch, seed=1)
    jout, tout = _both(jm, KPCN(**SMALL_KPCN), params, batch)
    assert set(tout) == set(jout) == {"radiance", "diffuse", "specular"}
    for k in jout:
        assert tout[k].shape == (2, 3, 7, 10)
        np.testing.assert_allclose(tout[k], jout[k], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("conv_dtype", [None, "bfloat16"])
def test_full_width_kpcn_matches_jax(conv_dtype):
    """The published width (depth 9, width 100, 21x21 kernels, 27 inputs)
    on one 44x45 tile: 8x9 pixels survive the valid convs."""
    rng = np.random.RandomState(2)
    batch = _kpcn_batch(rng, bs=1, h=44, w=45)
    del batch["target_image"]
    jm = JKPCN(conv_dtype=conv_dtype)
    params = _random_params(jm, batch, seed=3)
    tm = KPCN(conv_dtype=conv_dtype)
    assert sum(p.numel() for p in tm.parameters()) == 2 * (
        27 * 100 * 25 + 100 + 7 * (100 * 100 * 25 + 100)
        + 100 * 441 * 25 + 441)
    jout, tout = _both(jm, tm, params, batch)
    got, want = tout["radiance"], jout["radiance"]
    assert got.shape == (1, 3, 8, 9) and np.isfinite(got).all()
    if conv_dtype is None:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        err = np.abs(got - want)
        assert err.max() <= 5e-3 and err.mean() <= 1e-3, (err.max(),
                                                          err.mean())


def test_kpcn_too_small_input_raises():
    batch = {k: torch.zeros(1, 27 if k.endswith("_in") else 3, 12, 40)
             for k in KPCN_KEYS}
    with pytest.raises(ValueError, match="larger than 12x12"):
        KPCN(**SMALL_KPCN)(batch)
    with pytest.raises(ValueError, match="18-pixel border"):
        KPCN()(batch)


def test_build_model_and_round1_meta():
    meta = model_meta(True, SMALL_KPCN, {"spp": 4})
    assert meta["arch"] == "kpcn" and meta["kpcn_mode"]
    assert isinstance(build_model(meta), KPCN)
    # Round-1 metas carry only kpcn_mode.
    assert isinstance(build_model({"kpcn_mode": True,
                                   "model_params": SMALL_KPCN}), KPCN)
    assert isinstance(build_model({"model_params": SMALL_SBMC}), Multisteps)
    with pytest.raises(ValueError, match="unknown arch"):
        build_model({"arch": "nope", "model_params": {}})


# -- the gather ablation ------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_multisteps_gather_matches_jax(masked):
    rng = np.random.RandomState(4)
    batch = {"radiance": rng.rand(2, 3, 3, 14, 15).astype(np.float32),
             "features": rng.rand(2, 3, 8, 14, 15).astype(np.float32),
             "global_features": rng.rand(2, 3, 1, 1).astype(np.float32)}
    if masked:
        batch["sample_mask"] = np.array([[True, True, False],
                                         [True, True, True]])
    kw = dict(SMALL_SBMC, ksize=5, splat=False)
    jm = JMultisteps(**kw)
    params = _random_params(jm, batch, seed=5)
    jout, tout = _both(jm, Multisteps(**kw), params, batch)
    assert tout["radiance"].shape == (2, 3, 10, 11)
    np.testing.assert_allclose(tout["radiance"], jout["radiance"],
                               atol=2e-5, rtol=2e-5)
    # Gather and splat kernels are different models on the same weights.
    _, splat = _both(jm, Multisteps(**dict(kw, splat=True)), params, batch)
    assert np.abs(splat["radiance"] - tout["radiance"]).max() > 1e-3


# -- one train step -----------------------------------------------------------

def _port_grads(iface):
    """The port's gradients, flat, in the flax layout."""
    saved = [p.detach().clone() for p in iface.model.parameters()]
    with torch.no_grad():
        for p in iface.model.parameters():
            p.copy_(p.grad)
    flat = flatten(export_jax_params(iface.model)["params"])
    with torch.no_grad():
        for p, s in zip(iface.model.parameters(), saved):
            p.copy_(s)
    return flat


def _one_step(jmodel, tmodel, batch, seed):
    jiface = JInterface(jmodel, lr=1e-3)
    params = _random_params(jmodel, batch, seed)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=jparams, opt_state=jiface.tx.init(jparams),
                       step=jnp.zeros((), jnp.int32))
    arrays = jiface._arrays_only(batch)
    jgrads = jax.grad(lambda p: jiface._losses(p, arrays)[0])(jparams)
    jstate, jmetrics = jiface.train_step(state, batch)
    iface = DenoiserInterface(load_jax_params(tmodel, params), lr=1e-3,
                              device="cpu")
    metrics = iface.train_step(batch)
    for k in ("loss", "rmse", "input_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-12)
    grads, jgrads = _port_grads(iface), _np_tree(jgrads["params"])
    assert set(grads) == set(jgrads)
    for path, want in jgrads.items():
        np.testing.assert_allclose(grads[path], want, atol=1e-6, rtol=1e-3,
                                   err_msg=path)
    return iface, jiface, jstate, metrics


def test_kpcn_train_step_matches_jax():
    rng = np.random.RandomState(6)
    batch = _kpcn_batch(rng)
    iface, _, _, metrics = _one_step(JKPCN(**SMALL_KPCN), KPCN(**SMALL_KPCN),
                                     batch, seed=7)
    assert float(metrics["input_loss"]) == 0.0  # kpcn batches: no radiance
    assert iface.step == 1 and len(list(iface.model.parameters())) == 12


def test_gather_train_step_matches_jax():
    rng = np.random.RandomState(8)
    batch = {"radiance": rng.rand(2, 3, 3, 12, 12).astype(np.float32),
             "features": rng.rand(2, 3, 8, 12, 12).astype(np.float16),
             "global_features": rng.rand(2, 3, 1, 1).astype(np.float32),
             "target_image": rng.rand(2, 3, 12, 12).astype(np.float32),
             "sample_mask": np.array([[True, True, False],
                                      [True, True, True]])}
    kw = dict(SMALL_SBMC, splat=False)
    _one_step(JMultisteps(**kw), Multisteps(**kw), batch, seed=9)


def test_kpcn_checkpoints_cross_the_packages(tmp_path):
    """A KPCN checkpoint written by the JAX ``Checkpointer`` loads in the
    port (parameters, Adam moments, step) and denoises the same; the port's
    loads back in JAX."""
    rng = np.random.RandomState(10)
    batch = _kpcn_batch(rng)
    iface, jiface, jstate, _ = _one_step(
        JKPCN(**SMALL_KPCN), KPCN(**SMALL_KPCN), batch, seed=11)
    meta = model_meta(True, SMALL_KPCN, {"spp": 4, "mode": "kpcn"})
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointer(jroot, meta=meta).save(jstate, 1)
    torch.manual_seed(0)
    fresh = DenoiserInterface(build_model(Checkpointer.load_meta(jroot)),
                              lr=1e-3, device="cpu")
    state, step = Checkpointer(jroot).load_latest(fresh.state_tree())
    fresh.load_state_tree(state)
    assert step == 1 and fresh.step == 1
    got = flatten(fresh.state_tree())
    want = _np_tree({"params": jstate.params, "opt_state": jstate.opt_state,
                     "step": jstate.step})
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # The port's inference loader against the JAX model on those weights.
    model, _, _ = denoise.load_model(jroot, torch.device("cpu"))
    inputs = {k: batch[k] for k in KPCN_KEYS}
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    jout = jbuild(meta).apply(jstate.params, {k: jnp.asarray(v)
                                              for k, v in inputs.items()})
    np.testing.assert_allclose(out["radiance"].numpy(),
                               np.asarray(jout["radiance"]), atol=2e-5,
                               rtol=2e-5)
    # And the reverse.
    Checkpointer(root, meta=meta).save(iface.state_tree(), iface.step)
    jparams = jax.tree.map(jnp.asarray, _random_params(jiface.model, batch,
                                                       seed=12))
    template = TrainState(params=jparams,
                          opt_state=jiface.tx.init(jparams),
                          step=jnp.zeros((), jnp.int32))
    restored, step = JCheckpointer(root).load_latest(template)
    assert step == 1
    got = _np_tree({"params": restored.params,
                    "opt_state": restored.opt_state})
    tree = iface.state_tree()
    want = flatten({"params": tree["params"],
                    "opt_state": tree["opt_state"]})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert isinstance(jbuild(JCheckpointer.load_meta(root)), JKPCN)


# -- datasets -----------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kpcn_tiles"))
    generate_dataset(root, n_scenes=2, ts=16, tiles_per_side=2, spp=4,
                     gt_spp=4, seed=3)
    return root


def _assert_items_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["kpcn", "raw"])
@pytest.mark.parametrize("spp", [4, 2])
def test_dataset_modes_match_jax(data_root, mode, spp):
    # The optional-feature flags are ignored outside "sbmc" mode.
    ours = TilesDataset(data_root, spp=spp, mode=mode, load_gbuffer=False)
    theirs = JTilesDataset(data_root, spp=spp, mode=mode, load_gbuffer=False)
    assert len(ours) == len(theirs) == 8 and repr(ours) == repr(theirs)
    assert ours.num_features == theirs.num_features == (
        27 if mode == "kpcn" else 22)
    assert ours.num_global_features == theirs.num_global_features == (
        0 if mode == "kpcn" else 3)
    for i in (0, 5):
        _assert_items_equal(ours[i], theirs[i])
    if mode == "kpcn":
        item = ours[0]
        assert "radiance" not in item and "features" not in item
        assert item["kpcn_diffuse_in"].shape == (27, 16, 16)
        _assert_items_equal(collate([ours[0], ours[1]]),
                            jcollate([theirs[0], theirs[1]]))
    full, jfull = (cls(data_root, spp=spp, mode=mode)[1]
                   for cls in (FullImagesDataset, JFullImagesDataset))
    _assert_items_equal(full, jfull)


def test_filelist_and_cache(data_root, tmp_path):
    folders = TilesDataset(data_root, spp=4, mode="kpcn")
    listing = os.path.join(data_root, "list.txt")
    try:
        with open(listing, "w") as f:
            f.write("\n".join(os.path.relpath(p, data_root)
                              for p in folders.files[2:5]) + "\n\n")
        ours = TilesDataset(listing, spp=4, mode="kpcn",
                            cache_preprocessed=True)
        theirs = JTilesDataset(listing, spp=4, mode="kpcn")
        assert ours.files == theirs.files == folders.files[2:5]
        assert ours.io_mode == TilesDataset.FILELIST_MODE
        _assert_items_equal(ours[1], theirs[1])
        assert ours[1] is ours[1]  # cached (no "features" to halve)
        with pytest.raises(RuntimeError, match="folder mode"):
            FullImagesDataset(listing, spp=4)
    finally:
        os.remove(listing)
    with pytest.raises(RuntimeError, match="Unknown dataset loading mode"):
        TilesDataset(data_root, mode="nope")
    with pytest.raises(RuntimeError, match="Incorrect data path"):
        TilesDataset(str(tmp_path / "missing"))
    batches = list(Loader(folders, batch_size=4, num_threads=2))
    assert len(batches) == 2 and "sample_mask" not in batches[0]
    assert batches[0]["kpcn_albedo"].shape == (4, 3, 16, 16)


# -- tiled denoise ------------------------------------------------------------

def test_tiled_kpcn_matches_the_whole_frame():
    """KPCN shrinks a tile by ``2 * depth`` px a side and, unlike
    Multisteps, does not crop the kernel's border: with a pad that covers
    both (``2 * depth + (ksize - 1) / 2``), ragged and uniform tiles stitch
    to the whole-frame output. Compared inside that reach of the frame's
    edge: nearer to it the whole frame gathers zeros where a tile still has
    buffer values, and the uniform grid's zero padding lets edge tiles
    produce pixels the whole frame cannot (in both packages)."""
    rng = np.random.RandomState(13)
    torch.manual_seed(1)
    model = KPCN(**SMALL_KPCN).eval()   # shrinks 6 a side, kernel reach 2
    batch = {k: v for k, v in _kpcn_batch(rng, bs=1, h=50, w=41).items()
             if k in KPCN_KEYS}

    def run(b):
        with torch.inference_mode():
            return model({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in b.items()})["radiance"].numpy()

    whole = tiles.pad_back(batch, run(batch))
    assert whole.shape == (1, 3, 50, 41) and np.abs(whole[..., :6, :]).max() \
        == 0 and np.abs(whole[..., 6:-6, 6:-6]).min() > 0
    pad = 8
    stacked, info = tiles.split_tiles_uniform(batch, tile=24, pad=pad)
    n = stacked["kpcn_diffuse_in"].shape[0]
    assert n == 20
    outs = np.concatenate([run({k: v[i:i + 1] for k, v in stacked.items()})
                           for i in range(n)])
    uniform = tiles.merge_tiles_uniform(outs, info)
    inner = (Ellipsis, slice(8, -8), slice(8, -8))
    np.testing.assert_allclose(uniform[inner], whole[inner], atol=1e-5,
                               rtol=1e-5)
    assert np.abs(uniform[..., :6, :]).max() == 0
    ragged = tiles.split_tiles(batch, max_sz=24, pad=pad)
    canvas = tiles.merge_tiles(
        np.zeros((1, 3, 50, 41), np.float32),
        [(tiles.pad_back(tb, run(tb)), y0, y1, x0, x1, tp)
         for tb, y0, y1, x0, x1, tp in ragged])
    np.testing.assert_allclose(canvas[inner], whole[inner], atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="smaller than the model crop"):
        tiles.merge_tiles_uniform(outs, dict(info, pad=(4, 4)))
