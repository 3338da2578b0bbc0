"""The port's training stack against the JAX package's, on the CPU.

Both start from the same parameters (drawn with numpy) and the same batch.
Tolerances:

- one float32 train step: ``loss``, ``rmse`` and ``input_loss`` within
  ``1e-5`` relative; every leaf's gradient within ``1e-6 + 1e-3 * |jax|``
  (float32 conv and splat sums taken in other orders, chained through the
  whole model); Adam's moments after the step likewise. Parameters after
  the step are compared where ``|g| > 1e-5`` only: Adam's first update is
  ``lr * g / (|g| + 1e-8)``, so where ``|g|`` is near eps a rounding-size
  difference in ``g`` moves the update by a sizeable share of lr. There the
  update agrees within 2% of lr.
- with ``conv_dtype="bfloat16"`` the two frameworks round every conv at
  other places: loss and metrics within 2e-2 relative; the whole gradient
  within 10% in relative L2 norm, and every element within 10% of the
  largest gradient of the model. On this state the JAX model's own
  bfloat16 gradient sits 3.4% (relative L2) from its float32 gradient and
  the port's 4.5% from JAX's bfloat16 one: the comparison is as tight as
  bfloat16 rounding lets any two implementations agree. (Per leaf the
  rounding noise is far larger: JAX's bfloat16 and float32 gradients differ
  by up to 70% of a small leaf's largest value.)
- checkpoints: what one package writes the other reads back exactly
  (float32 arrays, no arithmetic).
- collate and Loader: exact.
"""

import csv
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.data import Loader as JLoader
from sbmc_tpu.data import TilesDataset as JTilesDataset
from sbmc_tpu.data import collate as jcollate
from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.train import Checkpointer as JCheckpointer
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu.train import TrainState
from sbmc_tpu_torch import train_cli
from sbmc_tpu_torch.data import (Loader, MultiSampleCountDataset,
                                 TilesDataset, collate)
from sbmc_tpu_torch.data.synthetic import generate_dataset
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.params import (export_adam_state, export_jax_params,
                                   flatten, load_jax_params, read_msgpack)
from sbmc_tpu_torch.train import (Checkpointer, DenoiserInterface, Trainer,
                                  callbacks)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(n_features=8, n_global_features=3, width=8, embedding_width=8,
             ksize=3, nsteps=2)
LR = 1e-3


def _batch(rng, bs=2, spp=3, nf=8, ngf=3, h=16, w=16, mask=True):
    b = {"radiance": rng.rand(bs, spp, 3, h, w).astype(np.float32),
         "features": rng.rand(bs, spp, nf, h, w).astype(np.float16),
         "global_features": rng.rand(bs, ngf, 1, 1).astype(np.float32),
         "target_image": rng.rand(bs, 3, h, w).astype(np.float32),
         "path": ["a"] * bs}
    if mask:
        b["sample_mask"] = np.array([[True, True, False],
                                     [True, True, True]][:bs])
    return b


def _random_params(module, batch, seed):
    """Flax variables of ``module`` redrawn from a numpy seed (shapes from
    an abstract init, which compiles nothing)."""
    rng = np.random.RandomState(seed)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if hasattr(v, "ndim")}
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


def _jax_state(iface, params):
    params = jax.tree.map(jnp.asarray, params)
    return TrainState(params=params, opt_state=iface.tx.init(params),
                      step=jnp.zeros((), jnp.int32))


def _port_interface(params, lr=LR, loss="tonemapped_relative_mse", **kw):
    model = load_jax_params(Multisteps(**SMALL, **kw), params)
    return DenoiserInterface(model, lr=lr, loss=loss, device="cpu")


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


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten(
        flax.serialization.to_state_dict(tree)).items()}


@pytest.fixture(scope="module")
def one_step():
    """One float32 train step in both packages from the same state."""
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    jiface = JInterface(JMultisteps(**SMALL), lr=LR)
    params = _random_params(jiface.model, batch, seed=1)
    state = _jax_state(jiface, params)
    arrays = jiface._arrays_only(batch)
    jgrads = jax.grad(lambda p: jiface._losses(p, arrays)[0])(state.params)
    jstate, jmetrics = jiface.train_step(state, batch)
    iface = _port_interface(params)
    metrics = iface.train_step(batch)
    return dict(batch=batch, params=params, jiface=jiface, jstate=jstate,
                jmetrics=jmetrics, jgrads=jgrads, iface=iface,
                metrics=metrics)


def test_train_step_matches_jax(one_step):
    s = one_step
    for k in ("loss", "rmse", "input_loss"):
        assert s["metrics"][k].ndim == 0
        np.testing.assert_allclose(float(s["metrics"][k]),
                                   float(s["jmetrics"][k]), rtol=1e-5)
    assert s["iface"].step == 1 and int(s["jstate"].step) == 1
    jgrads = _np_tree(s["jgrads"]["params"])
    grads = _port_grads(s["iface"])
    assert set(grads) == set(jgrads) and len(grads) > 30
    for path, want in jgrads.items():
        np.testing.assert_allclose(grads[path], want, atol=1e-6, rtol=1e-3,
                                   err_msg=path)
    # Adam's moments and count after the step.
    jopt = _np_tree(s["jstate"].opt_state)
    opt = flatten(export_adam_state(s["iface"].model, s["iface"].optimizer))
    assert set(opt) == set(jopt)
    for path, want in jopt.items():
        np.testing.assert_allclose(opt[path], want, atol=1e-9, rtol=2e-3,
                                   err_msg=path)
    # Parameters, where the gradient is well above Adam's eps.
    before = flatten(s["params"]["params"])
    after = flatten(export_jax_params(s["iface"].model)["params"])
    jafter = _np_tree(s["jstate"].params["params"])
    compared = 0
    for path, g in jgrads.items():
        big = np.abs(g) > 1e-5
        compared += int(big.sum())
        np.testing.assert_allclose((after[path] - before[path])[big],
                                   (jafter[path] - before[path])[big],
                                   atol=0.02 * LR, err_msg=path)
    assert compared > 100


def test_train_step_bf16_matches_jax_loosely():
    rng = np.random.RandomState(2)
    batch = _batch(rng)
    jiface = JInterface(JMultisteps(**SMALL, conv_dtype="bfloat16"), lr=LR)
    params = _random_params(jiface.model, batch, seed=3)
    state = _jax_state(jiface, params)
    arrays = jiface._arrays_only(batch)
    (_, (jrmse, jbase)), jgrads = jax.value_and_grad(
        jiface._losses, has_aux=True)(state.params, arrays)
    jloss = jiface._losses(state.params, arrays)[0]
    iface = _port_interface(params, conv_dtype="bfloat16")
    metrics = iface.train_step(batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=2e-2)
    np.testing.assert_allclose(float(metrics["rmse"]), float(jrmse),
                               rtol=2e-2)
    np.testing.assert_allclose(float(metrics["input_loss"]), float(jbase),
                               rtol=1e-5)
    grads = _port_grads(iface)
    jgrads = _np_tree(jgrads["params"])
    assert set(grads) == set(jgrads)
    # Each leaf against its own norm: bf16 rounding at other places moves a
    # small leaf by up to 0.33 of its L2 norm here (the JAX model's own
    # bf16-vs-float32 drift reaches 0.68 on the same leaves); a leaf that is
    # zero or missing differs by 1, one of the wrong sign by 2.
    for path, want in jgrads.items():
        rel = np.linalg.norm(grads[path] - want) / np.linalg.norm(want)
        assert rel <= 0.5, (path, rel)
    # The whole gradient: 0.045 measured, 0.034 is JAX's own drift.
    diff = np.sqrt(sum(((grads[k] - jgrads[k]) ** 2).sum() for k in jgrads))
    norm = np.sqrt(sum((g ** 2).sum() for g in jgrads.values()))
    assert diff <= 0.06 * norm, diff / norm


def test_loss_falls_over_repeated_steps():
    rng = np.random.RandomState(4)
    batch = _batch(rng)
    torch.manual_seed(0)
    iface = DenoiserInterface(Multisteps(**SMALL), lr=1e-2, device="cpu")
    losses = [float(iface.train_step(batch)["loss"]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert iface.step == 10


def test_nan_guard():
    with pytest.raises(RuntimeError):
        DenoiserInterface.check_finite({"loss": torch.tensor(float("nan"))})
    with pytest.raises(RuntimeError):
        DenoiserInterface.check_finite({"loss": float("inf")})
    assert DenoiserInterface.check_finite({"loss": torch.tensor(1.0)}) == 1.0


@pytest.mark.parametrize("loss", ["relative_mse", "smape", "tonemapped_mse"])
def test_eval_step_and_alternative_losses_match_jax(one_step, loss):
    s = one_step
    jiface = JInterface(s["jiface"].model, loss=loss)
    params = jax.tree.map(jnp.asarray, s["params"])
    want = jiface._losses(params, jiface._arrays_only(s["batch"]))
    iface = _port_interface(s["params"], loss=loss)
    before = [p.detach().clone() for p in iface.model.parameters()]
    got = iface.eval_step(s["batch"])
    np.testing.assert_allclose(float(got["loss"]), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(got["rmse"]), float(want[1][0]),
                               rtol=1e-5)
    assert iface.step == 0
    for p, b in zip(iface.model.parameters(), before):
        assert torch.equal(p, b) and p.grad is None
    metrics = iface.train_step(s["batch"])
    assert np.isfinite(float(metrics["loss"]))


def test_clip_matches_optax_arithmetic():
    """Below the limit gradients stay bit-identical; above it they become
    ``(g / norm) * limit``, optax's order of operations."""
    model = torch.nn.Linear(3, 2)
    iface = DenoiserInterface(model, grad_clip=1.0, device="cpu")
    for scale in (1e-3, 50.0):
        rng = np.random.RandomState(5)
        grads = [scale * rng.randn(*p.shape).astype(np.float32)
                 for p in model.parameters()]
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g.copy())
        iface._clip_gradients()
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads)).astype(np.float32)
        for p, g in zip(model.parameters(), grads):
            if norm < 1.0:
                np.testing.assert_array_equal(p.grad.numpy(), g)
            else:
                np.testing.assert_allclose(
                    p.grad.numpy(), (g / norm) * np.float32(1.0), rtol=1e-6)
        if norm >= 1.0:
            total = np.sqrt(sum(float((p.grad ** 2).sum())
                                for p in model.parameters()))
            assert abs(total - 1.0) < 1e-5


def test_remat_gives_the_same_gradients(one_step):
    s = one_step
    plain = _port_interface(s["params"])
    remat = _port_interface(s["params"], remat=True)
    a = plain.train_step(s["batch"])
    b = remat.train_step(s["batch"])
    assert float(a["loss"]) == float(b["loss"])
    for (n, p), q in zip(plain.model.named_parameters(),
                         remat.model.parameters()):
        torch.testing.assert_close(q.grad, p.grad, atol=1e-7, rtol=1e-6,
                                   msg=n)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiles"))
    generate_dataset(root, n_scenes=2, ts=16, tiles_per_side=2, spp=4,
                     gt_spp=4, seed=3)
    return root


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_collate_and_datasets_match_jax(tiles):
    jdata = JTilesDataset(tiles, spp=4)
    data = TilesDataset(tiles, spp=4)
    assert repr(data) == repr(jdata) and len(data) == len(jdata) == 8
    items = [data[i] for i in range(3)]
    jitems = [jdata[i] for i in range(3)]
    _assert_batches_equal(collate(items), jcollate(jitems))
    # Padded spp + mask, from items of unequal sample counts.
    multi = MultiSampleCountDataset(tiles, spp=4)
    assert len(multi) == 24 and multi.max_spp == 4
    picks = [multi[0], multi[9], multi[23]]
    assert [p["features"].shape[0] for p in picks] == [2, 3, 4]
    got = collate(picks, pad_spp=4)
    _assert_batches_equal(got, jcollate(picks, pad_spp=4))
    assert got["features"].dtype == np.float16
    assert got["sample_mask"].tolist() == [[True, True, False, False],
                                           [True, True, True, False],
                                           [True] * 4]
    with pytest.raises(ValueError):
        collate(picks, pad_spp=3)
    # The RAM cache keeps float16 features and hands back the same item.
    cached = TilesDataset(tiles, spp=4, cache_preprocessed=True)
    first = cached[1]
    assert first["features"].dtype == np.float16 and cached[1] is first
    np.testing.assert_array_equal(
        first["features"], data[1]["features"].astype(np.float16))
    # kpcn items carry no "features": the cache keeps them as they are.
    kpcn = TilesDataset(tiles, mode="kpcn", cache_preprocessed=True)
    item = kpcn[1]
    assert kpcn[1] is item and "features" not in item
    _assert_batches_equal(
        collate([item, kpcn[2]]),
        jcollate([JTilesDataset(tiles, mode="kpcn")[i] for i in (1, 2)]))


def test_loader_matches_jax(tiles):
    kw = dict(batch_size=3, shuffle=True, num_threads=1, seed=5,
              random_mask_spp=(2, 4))
    np.random.seed(11)
    want = list(JLoader(JTilesDataset(tiles, spp=4), **kw))
    np.random.seed(11)
    loader = Loader(TilesDataset(tiles, spp=4), **kw)
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert g["sample_mask"].shape == (3, 4)
        assert g["sample_mask"][:, :2].all()
    # Threads keep the order, and shards partition the items.
    many = list(Loader(TilesDataset(tiles, spp=4), batch_size=2,
                       num_threads=3))
    assert [p for b in many for p in b["path"]] == \
        TilesDataset(tiles, spp=4).files
    shards = [list(Loader(TilesDataset(tiles, spp=2), batch_size=1,
                          shard_id=i, num_shards=2)) for i in range(2)]
    assert [len(s) for s in shards] == [4, 4]
    assert not set(b["path"][0] for b in shards[0]) & \
        set(b["path"][0] for b in shards[1])


def test_checkpoint_from_jax_resumes_in_the_port(one_step, tmp_path):
    s = one_step
    root = str(tmp_path / "ck")
    JCheckpointer(root, meta={"model_params": SMALL}).save(s["jstate"], 1)
    torch.manual_seed(1)
    iface = DenoiserInterface(Multisteps(**SMALL), lr=LR, device="cpu")
    ckpt = Checkpointer(root)
    state, step = ckpt.load_latest(iface.state_tree())
    assert step == 1
    iface.load_state_tree(state)
    assert iface.step == 1
    got = flatten(iface.state_tree())
    want = _np_tree({"params": s["jstate"].params,
                     "opt_state": s["jstate"].opt_state,
                     "step": s["jstate"].step})
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert Checkpointer.load_meta(root)["model_params"]["ksize"] == 3
    # Both take the next step from that state: Adam's moments carried over.
    _, jmetrics = s["jiface"].train_step(
        jax.tree.map(jnp.asarray, s["jstate"]), s["batch"])
    metrics = iface.train_step(s["batch"])
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    assert int(iface.optimizer.state[
        next(iface.model.parameters())]["step"]) == 2


def test_checkpoint_from_the_port_resumes_in_jax(one_step, tmp_path):
    s = one_step
    root = str(tmp_path / "ck")
    ckpt = Checkpointer(root, meta={"model_params": SMALL})
    path = ckpt.save(s["iface"].state_tree(), s["iface"].step)
    assert os.path.basename(path) == "ckpt_000000001.msgpack"
    assert not [f for f in os.listdir(root) if f.endswith(".tmp")]
    template = _jax_state(s["jiface"], _random_params(
        s["jiface"].model, s["batch"], seed=9))
    restored, step = JCheckpointer(root).load_latest(template)
    assert step == 1 and int(restored.step) == 1
    got = _np_tree({"params": restored.params,
                    "opt_state": restored.opt_state})
    tree = s["iface"].state_tree()
    want = flatten({"params": tree["params"],
                    "opt_state": tree["opt_state"]})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(restored.opt_state[1][0].count) == 1
    # The port's own inference loader reads the params subtree.
    params, step = Checkpointer(root).load_params()
    assert step == 1 and set(params) == {"params"}


def test_rotation_tag_and_empty(tmp_path):
    torch.manual_seed(0)
    iface = DenoiserInterface(Multisteps(**SMALL), device="cpu")
    ckpt = Checkpointer(str(tmp_path / "c"), meta={}, max_files=2)
    state = iface.state_tree()
    for step in range(5):
        ckpt.save(state, step)
    ckpt.save(state, 5, tag="final")
    files = sorted(os.listdir(str(tmp_path / "c")))
    assert [f for f in files if f.startswith("ckpt_")] == [
        "ckpt_000000004.msgpack", "ckpt_000000005.msgpack"]
    assert "final.msgpack" in files
    assert ckpt.load_latest(state)[1] == 5
    restored, tag = ckpt.load_tag(state, "final")
    assert tag == "final" and set(restored) == set(state)
    assert ckpt.load_tag(state, "best") == (state, None)
    empty = Checkpointer(str(tmp_path / "nope"))
    assert empty.load_latest(state) == (state, None)


def test_incompatible_checkpoint_raises(tmp_path):
    big = DenoiserInterface(Multisteps(**dict(SMALL, width=16,
                                              embedding_width=16)),
                            device="cpu")
    small = DenoiserInterface(Multisteps(**SMALL), device="cpu")
    deep = DenoiserInterface(Multisteps(**dict(SMALL, nsteps=1)),
                             device="cpu")
    ckpt = Checkpointer(str(tmp_path / "c"), meta={})
    ckpt.save(big.state_tree(), 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_latest(small.state_tree())
    with pytest.raises(ValueError, match="unexpected"):
        ckpt.load_latest(deep.state_tree())
    tree = small.state_tree()
    with pytest.raises(ValueError, match="optimizer state"):
        small.load_state_tree(dict(tree, opt_state={"0": {}}))


def _nan_batch(batch):
    bad = dict(batch)
    bad["target_image"] = batch["target_image"] * np.nan
    return bad


def test_crash_does_not_save_final(tmp_path):
    """A NaN-loss abort must not write an end-of-training checkpoint."""
    rng = np.random.RandomState(6)
    b = _batch(rng)
    iface = DenoiserInterface(Multisteps(**SMALL), device="cpu")
    ckpt = Checkpointer(str(tmp_path / "c"), meta={})
    trainer = Trainer(iface, [callbacks.CheckpointingCallback(
        ckpt, iface, interval_steps=10 ** 9)])
    with pytest.raises(RuntimeError, match="not finite"):
        trainer.train([b, _nan_batch(b), b], num_epochs=1)
    assert ckpt.load_latest(None)[1] is None  # nothing was saved


def test_checkpoint_callback_skips_nonfinite(tmp_path):
    iface = DenoiserInterface(Multisteps(**SMALL), device="cpu")
    ckpt = Checkpointer(str(tmp_path / "c"), meta={})
    cb = callbacks.CheckpointingCallback(ckpt, iface, interval_steps=1)
    template = iface.state_tree()
    cb.epoch_end(0)
    assert ckpt.load_latest(template)[1] == 0
    with torch.no_grad():
        next(iface.model.parameters()).mul_(float("nan"))
    iface.step = 1
    cb.batch_end(1, {})
    cb.training_end()
    assert ckpt.load_latest(template)[1] == 0
    assert not os.path.exists(str(tmp_path / "c" / "final.msgpack"))


def test_trainer_full_loop_reads_metrics_a_step_late():
    rng = np.random.RandomState(7)
    batches = [_batch(rng, mask=False) for _ in range(4)]
    torch.manual_seed(0)
    iface = DenoiserInterface(Multisteps(**SMALL), lr=1e-2, device="cpu")
    seen = []

    class Record(callbacks.Callback):
        def batch_end(self, step, metrics):
            seen.append((step, iface.step, float(metrics["loss"])))

        def validation_end(self, epoch, metrics):
            seen.append(("val", epoch, metrics["n"]))

    trainer = Trainer(iface, [Record(), callbacks.ProgressCallback(1)])
    trainer.train(batches, num_epochs=2, val_dataloader=batches[:2])
    assert iface.step == 8
    steps = [s for s in seen if s[0] != "val"]
    assert [s[0] for s in steps] == list(range(1, 9))
    # Within an epoch a step's metrics are emitted after the next step ran.
    assert [s[1] - s[0] for s in steps] == [1, 1, 1, 0, 1, 1, 1, 0]
    assert [s for s in seen if s[0] == "val"] == [("val", 0, 4),
                                                  ("val", 1, 4)]
    val = trainer.validate(batches[:2])
    assert np.isfinite(val["loss"]) and val["n"] == 4
    trainer.train(batches, max_steps=10)
    assert iface.step == 10


class TestScalarLogCallback:
    def test_new_csv_has_wall_time(self, tmp_path):
        p = str(tmp_path / "log.csv")
        cb = callbacks.ScalarLogCallback(p, interval=1)
        cb.batch_end(1, {"loss": torch.tensor(0.5), "input_loss": 0.7})
        with open(p) as f:
            rows = list(csv.DictReader(f))
        assert float(rows[0]["wall_time"]) > 0
        assert float(rows[0]["loss"]) == 0.5

    def test_resume_extends_legacy_header(self, tmp_path):
        p = str(tmp_path / "log.csv")
        with open(p, "w") as f:
            f.write("step,input_loss,loss,rmse\n")
            f.write("50,0.01,0.02,0.1\n")
        cb = callbacks.ScalarLogCallback(p, interval=1)
        cb.batch_end(100, {"input_loss": 0.011, "loss": 0.019,
                           "rmse": 0.09})
        with open(p) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 2
        assert rows[0]["step"] == "50"
        assert rows[0]["wall_time"] == ""        # padded legacy row
        assert rows[1]["step"] == "100"
        assert rows[1]["loss"] == "0.019"
        assert float(rows[1]["wall_time"]) > 0   # new column survives

    def test_existing_empty_file_gets_header(self, tmp_path):
        p = str(tmp_path / "log.csv")
        open(p, "w").close()
        cb = callbacks.ScalarLogCallback(p, interval=1)
        cb.batch_end(1, {"loss": 0.5})
        with open(p) as f:
            lines = f.read().strip().split("\n")
        with open(p) as f:
            rows = list(csv.DictReader(f))
        assert rows and rows[0]["loss"] == "0.5"
        ncol = len(lines[0].split(","))
        assert all(len(line.split(",")) == ncol for line in lines[1:])


def _cli(data, ckpt, *extra):
    return train_cli.parse_args(
        [data, ckpt, "--spp", "4", "--ksize", "3", "--bs", "2",
         "--log_interval", "1", "--num_worker_threads", "2", *extra])


def test_cli_end_to_end_then_resume(tiles, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(_cli(tiles, ckpt, "--max_steps", "1"))
    iface = train_cli.main(_cli(tiles, ckpt, "--max_steps", "3", "--device",
                                "cpu"))
    assert iface.step == 3
    files = set(os.listdir(ckpt))
    assert {"meta.json", "train_log.csv", "final.msgpack", "viz",
            "ckpt_000000003.msgpack"} <= files
    assert os.listdir(os.path.join(ckpt, "viz")) == ["epoch_0000.png"]
    meta = Checkpointer.load_meta(ckpt)
    assert meta["arch"] == "sbmc" and meta["model_params"]["ksize"] == 3
    assert meta["data_params"]["spp"] == 4
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2", "3"]
    assert all(np.isfinite(float(r[k])) for r in rows
               for k in ("loss", "rmse", "input_loss", "wall_time"))
    tree = read_msgpack(os.path.join(ckpt, "final.msgpack"))
    assert int(tree["step"]) == 3 and int(
        tree["opt_state"]["1"]["0"]["count"]) == 3
    # Resume: constant spp and bf16 convs from the same checkpoint.
    iface = train_cli.main(_cli(tiles, ckpt, "--max_steps", "5", "--device",
                                "cpu", "--constant_spp", "--bf16",
                                "--trust_bf16", "--no_cache_ram"))
    assert iface.step == 5
    assert "ckpt_000000005.msgpack" in os.listdir(ckpt)
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        assert [r["step"] for r in csv.DictReader(f)] == list("12345")


@pytest.mark.parametrize("flags,arch", [
    (["--kpcn_mode", "--kpcn_depth", "2", "--kpcn_width", "8", "--ksize",
      "5"], "kpcn"),
    (["--lbf_mode", "--lbf_window_r", "2"], "lbf"),
    (["--gather"], "sbmc"),
    (["--gather", "--bf16", "--constant_spp"], "sbmc")],
    ids=["kpcn", "lbf", "gather", "gather_bf16"])
def test_cli_modes_train_then_denoise(tiles, tmp_path, flags, arch):
    """Each mode trains two steps on the CPU and writes a checkpoint that
    the denoise entry point reads back, through ragged and uniform tiles."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.models import KPCN, LBF
    from sbmc_tpu_torch.utils import exr
    ckpt = str(tmp_path / "ckpt")
    iface = train_cli.main(_cli(tiles, ckpt, "--max_steps", "2", "--device",
                                "cpu", *flags))
    assert iface.step == 2
    meta = Checkpointer.load_meta(ckpt)
    assert meta["arch"] == arch and meta["kpcn_mode"] == (arch == "kpcn")
    files = set(os.listdir(ckpt))
    assert {"meta.json", "train_log.csv", "final.msgpack",
            "ckpt_000000002.msgpack"} <= files
    # KPCN writes no display strip and trains at a constant sample count.
    assert ("viz" in files) == (arch != "kpcn")
    if arch == "kpcn":
        assert isinstance(iface.model, KPCN)
        assert meta["data_params"]["mode"] == "kpcn"
        assert meta["model_params"] == dict(
            n_in=27, ksize=5, depth=2, width=8, conv_dtype=None)
        crop = 4
    elif arch == "lbf":
        assert isinstance(iface.model, LBF)
        assert meta["model_params"]["window_r"] == 2
        crop = 2
    else:
        assert isinstance(iface.model, Multisteps)
        assert meta["model_params"]["splat"] is False
        crop = 1
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert (float(rows[0]["input_loss"]) == 0.0) == (arch == "kpcn")
    outs = []
    for extra in ([], ["--uniform_tiles"]):
        out = str(tmp_path / ("u" if extra else "r") / "a.exr")
        res = denoise.main(denoise.parse_args(
            ["--input", tiles, "--checkpoint", ckpt, "--output", out,
             "--tile_size", "24", "--tile_pad", "8", "--device", "cpu",
             *extra]))
        assert len(res) == 2 and res[0]["tiles"] == 4
        img = exr.read(res[0]["output"])
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
        assert np.abs(img[:crop]).max() == 0
        assert np.abs(img[8:-8, 8:-8]).max() > 0
        outs.append(img)
    # Ragged and uniform tiles agree away from the frame's edge.
    np.testing.assert_allclose(outs[0][8:-8, 8:-8], outs[1][8:-8, 8:-8],
                               atol=2e-3, rtol=2e-3)


def test_cli_kpcn_and_lbf_exclude_each_other(tiles, tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(_cli(tiles, str(tmp_path / "c"), "--device", "cpu",
                            "--kpcn_mode", "--lbf_mode"))
    assert not os.path.exists(str(tmp_path / "c"))


def test_cli_has_no_profile_port(tiles):
    """The JAX script's --profile_port (a jax.profiler server) has no
    counterpart: the flag is refused, not accepted and ignored."""
    with pytest.raises(SystemExit):
        _cli(tiles, "c", "--profile_port", "9999")
