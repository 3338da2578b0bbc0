"""The port's scatter-vs-gather experiment (``python -m
sbmc_tpu_torch.scatter_vs_gather``) against the JAX script
(``scripts/figures/scatter_vs_gather.py``), on the CPU.

Both start from the same weights: the JAX script's ``Toy`` initialised
from ``jax.random.PRNGKey(0)``, packed with ``flax.serialization`` and
read by the port's msgpack reader. Both draw the same ``RandomState(0)``
batches (width 8, 3 steps a variant).

Tolerances: every loss within ``1e-4`` relative of the JAX script's (the
convs, the softmax and Adam round in other orders in the two frameworks);
the PNG strips within one grey level (a pixel near a level's edge may
round to its neighbour).
"""

import contextlib
import csv
import importlib.util
import io
import os
import re
from types import SimpleNamespace

import flax
import flax.linen as fnn
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu.nn import ConvChain as JConvChain
from sbmc_tpu.nn import kernel_apply as jkernel_apply
from sbmc_tpu_torch import scatter_vs_gather
from sbmc_tpu_torch.params import load_jax_params, read_msgpack
from sbmc_tpu_torch.utils.image import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, STEPS = 8, 3
LOSS_RTOL = 1e-4

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def load_script(relpath, name):
    """A JAX script of ``scripts/`` imported as a module (its import-time
    platform call with the persistent compile cache off)."""
    old = os.environ.get("SBMC_NO_COMPILE_CACHE")
    os.environ["SBMC_NO_COMPILE_CACHE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, relpath))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            del os.environ["SBMC_NO_COMPILE_CACHE"]
        else:
            os.environ["SBMC_NO_COMPILE_CACHE"] = old
    return mod


class JToy(fnn.Module):
    """The JAX script's ``Toy`` (defined inside its ``main``), built from
    the same modules with the ops' ``xla`` backend, the default on the
    CPU."""
    splat: bool
    width: int
    ksize: int = 3

    @fnn.compact
    def __call__(self, samples, coords):
        bs, spp, _, h, w = samples.shape
        feats = jnp.concatenate([jnp.log10(1.0 + samples), coords], axis=2)
        flat = feats.reshape(bs * spp, -1, h, w).transpose(0, 2, 3, 1)
        kernels = JConvChain(self.ksize ** 2, width=self.width, depth=3,
                             ksize=3, pad=True)(flat)
        kernels = kernels.transpose(0, 3, 1, 2)
        data = samples.reshape(bs * spp, 1, h, w)
        out, _ = jkernel_apply(data, kernels, softmax=True,
                               splat=self.splat, backend="xla")
        out = out.reshape(bs, spp, 1, h, w).mean(1)
        k = (self.ksize - 1) // 2
        return out[..., k:-k, k:-k]


def _read_losses(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "splat", "gather"]
    return np.array([[float(v) for v in r] for r in rows[1:]])


def _final(text):
    m = re.search(r"^final: splat (\S+) gather (\S+)$", text, re.M)
    assert m, text
    return float(m.group(1)), float(m.group(2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX script's outputs and the port's from the script's initial
    weights, and the port's printed lines."""
    root = tmp_path_factory.mktemp("svg")
    script = load_script("scripts/figures/scatter_vs_gather.py", "_jax_svg")
    jout, pout = str(root / "jax"), str(root / "port")
    jlog = io.StringIO()
    with contextlib.redirect_stdout(jlog):
        script.main(SimpleNamespace(output=jout, steps=STEPS, width=WIDTH,
                                    lr=1e-3))
    # The script initialises each variant from PRNGKey(0) on its first
    # batch; the parameters depend on the shapes alone, so one init gives
    # both variants' weights.
    _, smp, crd = scatter_vs_gather.make_batch(np.random.RandomState(0))
    params = JToy(True, WIDTH).init(jax.random.PRNGKey(0), jnp.array(smp),
                                    jnp.array(crd))
    blob = root / "init.msgpack"
    blob.write_bytes(flax.serialization.to_bytes(params))
    plog = io.StringIO()
    with contextlib.redirect_stdout(plog):
        res = scatter_vs_gather.run(pout, steps=STEPS, width=WIDTH,
                                    device="cpu",
                                    params=read_msgpack(str(blob)))
    return jout, pout, jlog.getvalue(), plog.getvalue(), res


def test_losses_match_jax_script(runs):
    jout, pout, jlog, plog, res = runs
    want = _read_losses(os.path.join(jout, "losses.csv"))
    got = _read_losses(os.path.join(pout, "losses.csv"))
    assert got.shape == want.shape == (STEPS, 3)
    np.testing.assert_array_equal(got[:, 0], np.arange(STEPS))
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[:, 1], res["splat"])
    np.testing.assert_array_equal(got[:, 2], res["gather"])
    np.testing.assert_allclose(_final(plog), _final(jlog), rtol=LOSS_RTOL,
                               atol=1e-5)


def test_printed_lines_match_jax_script(runs):
    _, _, jlog, plog, _ = runs
    pattern = re.compile(r"^(splat|gather) step \d+: loss \d+\.\d{5}$"
                         r"|^final: splat \d+\.\d{5} gather \d+\.\d{5}$")
    jlines, plines = jlog.splitlines(), plog.splitlines()
    assert len(plines) == len(jlines) == 3
    for jl, pl in zip(jlines, plines):
        assert pattern.match(jl) and pattern.match(pl), (jl, pl)
        assert jl.split(":")[0] == pl.split(":")[0]


@pytest.mark.parametrize("name", ["splat", "gather"])
def test_strips_match_jax_script(runs, name):
    jout, pout, _, _, _ = runs
    want = imageio.imread(os.path.join(jout, name + ".png"))
    got = read_png(os.path.join(pout, name + ".png"))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (62, 124)
    np.testing.assert_array_equal(imageio.imread(
        os.path.join(pout, name + ".png")), got)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batches_are_the_jax_scripts():
    script = load_script("scripts/figures/scatter_vs_gather.py", "_jax_svg2")
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        for got, want in zip(scatter_vs_gather.make_batch(a, bs=2, h=16,
                                                          w=24),
                             script.make_batch(b, bs=2, h=16, w=24)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_splat_step_gradients_match_jax(tmp_path):
    """One splat and one gather loss gradient, the port's Toy (plain ops on
    the CPU) against the JAX Toy on the same weights: the Toy, the
    transpose and kernel weighting's weight gradient agree."""
    rng = np.random.RandomState(1)
    tgt, smp, crd = scatter_vs_gather.make_batch(rng, bs=2, spp=2, h=20,
                                                 w=24)
    params = JToy(True, WIDTH).init(jax.random.PRNGKey(2), jnp.array(smp),
                                    jnp.array(crd))
    blob = tmp_path / "p.msgpack"
    blob.write_bytes(flax.serialization.to_bytes(params))
    tree = read_msgpack(str(blob))
    for splat in (True, False):
        jmodel = JToy(splat, WIDTH)

        def loss_fn(p):
            out = jmodel.apply(p, jnp.array(smp), jnp.array(crd))
            return jnp.mean((out - jnp.array(tgt)[..., 1:-1, 1:-1]) ** 2)

        jloss, jgrads = jax.value_and_grad(loss_fn)(params)
        model = scatter_vs_gather.Toy(splat, WIDTH)
        load_jax_params(model, tree)
        out = model(torch.tensor(smp, dtype=torch.float32),
                    torch.tensor(crd, dtype=torch.float32))
        loss = torch.mean((out - torch.tensor(tgt)[..., 1:-1, 1:-1]) ** 2)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        flat = flax.traverse_util.flatten_dict(jgrads["params"], sep="/")
        for name, p in model.named_parameters():
            want = np.asarray(flat[name.replace(".", "/")])
            got = p.grad.numpy()
            if got.ndim == 4:
                got = got.transpose(2, 3, 1, 0)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-6 * np.abs(want).max())



def test_adam_update_matches_optax():
    """``torch.optim.Adam`` and ``optax.adam`` at the script's defaults take
    the same steps: both add ``eps`` outside the square root of the bias-
    corrected second moment. The first steps take gradients of order 1e-8,
    where that decides the step: about ``lr / 2`` with ``eps`` outside,
    ``1e-4 * lr`` inside. Within ``3e-8 + 1e-5 * |optax|`` (float32
    rounding over five steps of up to 1e-3 each)."""
    import optax
    rng = np.random.RandomState(4)
    p0 = np.zeros(64, np.float32)
    grads = [rng.randn(64).astype(np.float32) * s
             for s in (1e-8, 1e-8, 1e-8, 1.0, 1.0)]
    tx = optax.adam(1e-3)
    jp = jnp.array(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.Adam([tp], lr=1e-3)
    for i, g in enumerate(grads):
        updates, state = tx.update(jnp.array(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=3e-8)
        if i == 0:
            assert np.abs(np.asarray(jp)).mean() > 1e-4
