"""The plain reference against the program at small sizes on the CPU, in
float32: each configuration's model, the uniform tiles, and the train
step."""

import json

import numpy as np
import pytest
import torch

from benchmark import arch as arches
from benchmark import spec, weights
from benchmark.cell import Cell
from benchmark.drivers import train
from benchmark.reference import models
from benchmark.reference import tiles as rtiles
from benchmark.reference.names import program_name
from benchmark.tests import tiny

BENCH = spec.load()
CPU = torch.device("cpu")


def _f32(cfg):
    cfg["model"]["conv_dtype"] = None
    if "kernel_dtype" in cfg["model"]:
        cfg["model"]["kernel_dtype"] = None
    return cfg


CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [c for c in CELLS if tiny.kind(c, BENCH) == "train"]


def _tiny_config(name):
    cfg = json.loads(json.dumps(spec.config(BENCH, name)))
    cfg["model"].update(cfg["tiny"])
    return cfg


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_model_matches_the_program(name, mask):
    cfg = _f32(_tiny_config(name))
    arch = arches.load(cfg["arch"])
    params = weights.make(cfg, 3, CPU)
    net = arch.program(cfg, params, CPU).eval()
    gen = torch.Generator().manual_seed(4)
    x = arch.frame(cfg, gen, CPU, 36, 44, 3)
    if mask:
        if "radiance" not in x:
            pytest.skip("the model takes no samples to mask")
        x["sample_mask"] = torch.tensor([[True, False, True]])
    with torch.no_grad():
        got = net(x)["radiance"]
        want = models.forward(cfg, params, x)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_follow_the_seed(name):
    cfg = _tiny_config(name)
    a, b = weights.make(cfg, 7, CPU), weights.make(cfg, 7, CPU)
    c = weights.make(cfg, 8, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    assert {program_name(k) for k in a} == set(
        arches.load(cfg["arch"]).program(cfg, a, CPU).state_dict())


@pytest.mark.parametrize("h, w, tile, pad", [
    (40, 56, (32, 40), (8, 8)), (1080, 1920, (1080, 2048), (50, 64)),
    (37, 23, 20, 4)])
def test_uniform_tiles_match_the_program(h, w, tile, pad):
    from sbmc_tpu_torch.parallel.tiles import split_tiles_uniform
    rng = np.random.RandomState(0)
    frame = rng.rand(1, 2, 3, h, w).astype(np.float32)
    stacked, _ = split_tiles_uniform({"features": frame}, tile, pad)
    cut = rtiles.uniform_cut(torch.from_numpy(frame), tile, pad)
    assert np.array_equal(cut.numpy(), stacked["features"])


@pytest.mark.parametrize("cell", TRAIN)
def test_reference_train_steps_match_the_program(cell):
    cfg, t = tiny.cell(cell, BENCH)
    cfg = _f32(cfg)
    state = train.setup(Cell(cell, cfg, t, 9, "cpu"))
    prog = state.prog
    ref = train.reference_steps(cfg, t, state.params, state.tiles,
                                prog["idx"], CPU)
    assert np.allclose(prog["losses"], ref["losses"], rtol=1e-5)
    for k, v in ref["grad"].items():
        assert abs(prog["grad"][k] - v) <= 1e-4 * v + 1e-9, k
        assert float((prog["grads"][k] - ref["grads"][k]).norm()) <= \
            1e-4 * v + 1e-9, k
    # Adam moves every element by about lr, whatever its gradient, so a
    # near-zero gradient element may step either way on rounding; the
    # median leaf's change still agrees closely.
    gaps = sorted(abs(prog["update"][k] - v) / v
                  for k, v in ref["update"].items())
    assert gaps[len(gaps) // 2] < 1e-3
