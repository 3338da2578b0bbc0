"""The port's device reservoir (``sbmc_tpu_torch/train/reservoir.py``)
against the JAX package's (``tests/test_reservoir.py``), on the CPU.

Tolerances: one reservoir step on a batch fixed by ``(idx, ks)`` is held to
the JAX train step on the same gathered batch and weights with
``test_torch_train.py::test_train_step_matches_jax``'s tolerances (metrics
within ``1e-5`` relative, every gradient within ``1e-6 + 1e-3 * |jax|``).
Slot contents after a refresh are compared exactly (a copy).
"""

import csv
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.models import Multisteps as JMultisteps
from sbmc_tpu.train import DenoiserInterface as JInterface
from sbmc_tpu_torch import train_cli
from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.train import Checkpointer, Trainer, callbacks
from sbmc_tpu_torch.train.interface import DenoiserInterface
from sbmc_tpu_torch.train.reservoir import (TRAIN_KEYS, DeviceReservoir,
                                            ReservoirFeeder)
from tests.test_torch_train import (LR, SMALL, _batch, _cli, _jax_state,
                                    _np_tree, _port_grads, _port_interface,
                                    _random_params, tiles)  # noqa: F401

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _items(rng, n, spp=2, h=16, w=16):
    out = []
    for _ in range(n):
        b = _batch(rng, bs=1, spp=spp, h=h, w=w, mask=False)
        item = {k: v[0] for k, v in b.items()}
        item["path"] = "synthetic"  # non-array metadata stays on the host
        out.append(item)
    return out


def _small_interface(lr=1e-2, seed=0):
    torch.manual_seed(seed)
    return DenoiserInterface(Multisteps(**SMALL), lr=lr, device="cpu")


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_training_decreases_loss():
    rng = np.random.RandomState(0)
    iface = _small_interface(lr=1e-2)
    res = DeviceReservoir(iface, capacity=8, batch_size=2, seed=0)
    res.fill(_items(rng, 8))
    losses = [float(res.train_step()["loss"]) for _ in range(11)]
    assert np.isfinite(losses).all()
    assert min(losses[5:]) < losses[0]
    assert iface.step == 11


def test_refresh_overwrites_slot_in_place():
    """Each refresh writes the next slot, round-robin, into the same
    tensors through the same staging buffers; the other slots keep their
    contents."""
    rng = np.random.RandomState(1)
    res = DeviceReservoir(_small_interface(), capacity=4, batch_size=2)
    res.fill(_items(rng, 4))
    bufs = res.buffers
    assert [bufs[k].shape[0] for k in TRAIN_KEYS] == [4] * 4
    assert bufs["features"].dtype == torch.float16
    ptrs = {k: v.data_ptr() for k, v in bufs.items()}
    staged = {k: v.data_ptr() for k, v in res._staging.items()}
    before = {k: v.clone() for k, v in bufs.items()}
    for n, new in enumerate(_items(rng, 6)):
        res.refresh(new)
        slot = n % 4
        assert res._next_slot == (n + 1) % 4
        for k in TRAIN_KEYS:
            want = torch.from_numpy(np.asarray(new[k]).astype(
                before[k].numpy().dtype))
            assert torch.equal(res.buffers[k][slot], want), (n, k)
            before[k][slot] = want
            assert torch.equal(res.buffers[k], before[k]), (n, k)
            assert res.buffers[k].data_ptr() == ptrs[k]
            assert res._staging[k].data_ptr() == staged[k]
    assert res.buffers is bufs


def test_refresh_refuses_another_shape():
    rng = np.random.RandomState(2)
    res = DeviceReservoir(_small_interface(), capacity=2, batch_size=2)
    res.fill(_items(rng, 2))
    with pytest.raises(ValueError, match="shape"):
        res.refresh(_items(rng, 1, h=8)[0])
    assert res._next_slot == 0


def test_spp_mask_range_trains():
    """Randomized sample counts: each item's mask keeps its first k samples,
    k in lo..hi, and the steps stay finite."""
    rng = np.random.RandomState(3)
    iface = _small_interface(lr=1e-3)
    res = DeviceReservoir(iface, capacity=4, batch_size=2,
                          spp_mask_range=(2, 4), seed=3)
    res.fill(_items(rng, 4, spp=4))
    seen = set()
    for _ in range(4):
        idx, ks = res.draw()
        assert len(set(idx.tolist())) == 2 and 0 <= int(idx.min()) \
            and int(idx.max()) < 4
        assert 2 <= int(ks.min()) and int(ks.max()) <= 4
        seen.update(ks.tolist())
        mask = res.batch(idx, ks)["sample_mask"]
        assert torch.equal(mask.sum(1), ks)
        assert torch.equal(mask, torch.arange(4)[None] < ks[:, None])
        assert np.isfinite(float(res.step_on(idx, ks)["loss"]))
    assert iface.step == 4 and len(seen) > 1


def test_draws_repeat_with_the_seed():
    rng = np.random.RandomState(4)
    items = _items(rng, 6)
    draws = []
    for _ in range(2):
        res = DeviceReservoir(_small_interface(), capacity=6, batch_size=3,
                              spp_mask_range=(1, 2), seed=7)
        res.fill(items)
        draws.append([tuple(map(tuple, (i.tolist(), k.tolist())))
                      for i, k in (res.draw() for _ in range(5))])
    assert draws[0] == draws[1]
    with pytest.raises(ValueError, match="capacity"):
        DeviceReservoir(_small_interface(), capacity=2, batch_size=3)


def test_reservoir_step_matches_jax():
    """One step on slots ``idx`` with sample counts ``ks`` is JAX's train
    step on the same gathered batch (float16 features, the mask of ks)."""
    rng = np.random.RandomState(5)
    items = _items(rng, 5, spp=3)
    idx, ks = torch.tensor([3, 0]), torch.tensor([2, 3])
    gathered = {k: np.stack([np.asarray(items[i][k]) for i in (3, 0)])
                for k in TRAIN_KEYS}
    gathered["features"] = gathered["features"].astype(np.float16)
    gathered["sample_mask"] = np.arange(3)[None] < np.array([2, 3])[:, None]
    jiface = JInterface(JMultisteps(**SMALL), lr=LR)
    params = _random_params(jiface.model, gathered, seed=6)
    state = _jax_state(jiface, params)
    jbatch = {k: jnp.asarray(v) for k, v in gathered.items()}
    jgrads = jax.jit(jax.grad(lambda p: jiface._losses(p, jbatch)[0]))(
        state.params)
    _, jmetrics = jiface.train_step(state, gathered)

    iface = _port_interface(params)
    res = DeviceReservoir(iface, capacity=5, batch_size=2)
    res.fill(items)
    batch = res.batch(idx, ks)
    for k, v in gathered.items():
        assert np.array_equal(batch[k].numpy(), v), k
    metrics = res.step_on(idx, ks)
    for k in ("loss", "rmse", "input_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5)
    jg = _np_tree(jgrads["params"])
    grads = _port_grads(iface)
    assert set(grads) == set(jg) and len(grads) > 30
    for path, want in jg.items():
        np.testing.assert_allclose(grads[path], want, atol=1e-6, rtol=1e-3,
                                   err_msg=path)


def test_trainer_loop_with_feeder():
    rng = np.random.RandomState(7)
    iface = _small_interface(lr=1e-2)
    data = ListDataset(_items(rng, 6))
    res = DeviceReservoir(iface, capacity=4, batch_size=2)
    res.fill([data[i] for i in range(4)])
    ptrs = {k: v.data_ptr() for k, v in res.buffers.items()}
    feeder = ReservoirFeeder(data, depth=2).start()
    refreshed = Trainer(iface).train_reservoir(res, feeder=feeder,
                                               max_steps=6, refresh_every=1)
    assert iface.step == 6 and 0 <= refreshed <= 6
    assert not feeder._thread.is_alive()
    assert {k: v.data_ptr() for k, v in res.buffers.items()} == ptrs


def test_feeder_failure_reaches_the_trainer():
    class Broken(ListDataset):
        def __getitem__(self, i):
            raise OSError("unreadable tile %d" % i)

    rng = np.random.RandomState(8)
    iface = _small_interface()
    res = DeviceReservoir(iface, capacity=2, batch_size=2)
    res.fill(_items(rng, 2))
    feeder = ReservoirFeeder(Broken([None] * 3)).start()
    feeder._thread.join(10)
    with pytest.raises(RuntimeError, match="feeder failed"):
        Trainer(iface).train_reservoir(res, feeder=feeder, max_steps=3)
    assert not feeder._thread.is_alive()


def test_trainer_loop_with_real_callback_suite(tmp_path):
    """The reservoir loop emits no epoch_start; the callback suite the train
    CLI attaches must work without it."""
    rng = np.random.RandomState(9)
    iface = _small_interface(lr=1e-2)
    res = DeviceReservoir(iface, capacity=4, batch_size=2)
    res.fill(_items(rng, 4))
    first = _batch(rng, bs=2)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), meta={"arch": "test"})
    trainer = Trainer(iface, [
        callbacks.ProgressCallback(interval=2),
        callbacks.CheckpointingCallback(ckpt, iface, interval_steps=3),
        callbacks.ScalarLogCallback(str(tmp_path / "log.csv"), interval=2),
        callbacks.DenoisingDisplayCallback(iface, lambda: first,
                                           str(tmp_path / "viz")),
    ])
    trainer.train_reservoir(res, max_steps=5, epoch_emit_every=4)
    assert iface.step == 5
    with open(tmp_path / "log.csv") as f:
        assert [r["step"] for r in csv.DictReader(f)] == ["2", "4"]
    # epoch_emit_every=4: one display strip and one epoch checkpoint.
    assert (tmp_path / "viz" / "epoch_0001.png").exists()
    # Metrics reach the callbacks a step late: batch_end(3) saves step 4.
    assert {"ckpt_000000004.msgpack", "ckpt_000000005.msgpack",
            "final.msgpack"} <= set(os.listdir(tmp_path / "ckpt"))


def test_cli_trains_from_the_reservoir(tiles, tmp_path, caplog):  # noqa: F811
    """``--device_reservoir`` below the tile count: the feeder refreshes
    slots while the CLI trains, and the checkpoint resumes in the port."""
    caplog.set_level(logging.INFO)
    ckpt = str(tmp_path / "ckpt")
    iface = train_cli.main(_cli(tiles, ckpt, "--max_steps", "4", "--device",
                                "cpu", "--device_reservoir", "4",
                                "--refresh_every", "1", "--trust_reservoir"))
    assert iface.step == 4
    assert "reservoir filled: 4 tiles" in caplog.text
    assert "spp mask range (2, 4)" in caplog.text
    assert "reservoir refreshes:" in caplog.text
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert {"final.msgpack", "ckpt_000000004.msgpack"} <= set(
        os.listdir(ckpt))


def test_cli_num_epochs_become_steps(tiles, tmp_path, caplog):  # noqa: F811
    """Eight tiles, batch 2: one epoch is four reservoir steps; a capacity
    above the tile count holds every tile and needs no feeder."""
    caplog.set_level(logging.INFO)
    iface = train_cli.main(_cli(tiles, str(tmp_path / "c"), "--num_epochs",
                                "1", "--device", "cpu", "--constant_spp",
                                "--device_reservoir", "64"))
    assert iface.step == 4
    assert "--num_epochs 1 -> max_steps 4" in caplog.text
    assert "reservoir filled: 8 tiles" in caplog.text
    assert "spp mask range None" in caplog.text
    assert "reservoir refreshes: 0 over 4 steps" in caplog.text


def test_cli_kpcn_mode_ignores_the_reservoir(tiles, tmp_path,  # noqa: F811
                                             caplog):
    caplog.set_level(logging.INFO)
    iface = train_cli.main(_cli(
        tiles, str(tmp_path / "c"), "--max_steps", "2", "--device", "cpu",
        "--kpcn_mode", "--kpcn_depth", "2", "--kpcn_width", "8", "--ksize",
        "5", "--device_reservoir", "4"))
    assert iface.step == 2
    assert "--device_reservoir ignored" in caplog.text
    assert "reservoir filled" not in caplog.text
