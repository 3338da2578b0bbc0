"""The port's op and stage microbenchmarks (``python -m
sbmc_tpu_torch.profile_kernel_weighting``, ``profile_scatter2gather`` and
``profile_model_stages``) against the JAX scripts
(``scripts/profile/kernel_weighting.py``, ``scatter2gather.py``,
``model_stages.py``) on the CPU at a tiny size: each prints the JAX
script's lines (the same labels and number formats; the times themselves
are the host's and are not compared). Then the new modules of the port
import neither ``jax`` nor ``sbmc_tpu``, and their entry points need a
CUDA device unless told otherwise.

Tolerances: none (line formats and the kernel launches the CPU run makes:
none, since CPU tensors take the plain versions).
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from sbmc_tpu_torch import (ops, profile_kernel_weighting,
                            profile_model_stages, profile_scatter2gather)
from tests.test_torch_figures import load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_ARGS = dict(bs=1, size=16, ksize=3, iters=2, warmup=1)
STAGE_ARGS = ["--h", "16", "--w", "24", "--spp", "2", "--ksize", "3",
              "--width", "8", "--iters", "1"]
#: The port's new modules (this slice's CLIs and helpers).
NEW_MODULES = ("scatter_vs_gather", "probe_vs_input", "kernel_grids",
               "denoise_nfor", "visualize_dataset", "metrics_report",
               "profile_kernel_weighting", "profile_scatter2gather",
               "profile_model_stages", "utils.timing")
NUM = r"\s*-?\d+\.\d{2}"
STAGE_LINE = re.compile(
    r"^(# stage timings: \d+x\d+ spp=\d+ k=\d+ dtype=(bf16|f32)"
    r"|(embed|unet|regress|splat)\s+%s ms/call  x\d in model =%s ms"
    r"|stage sum\s+=%s ms"
    r"|model\s+%s ms/tile \(unexplained: %s ms\))$" % ((NUM,) * 5))

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return buf.getvalue().splitlines(), res


def _op_argv(backend="kernel"):
    argv = []
    for k, v in OP_ARGS.items():
        argv += ["--" + k, str(v)]
    return argv + ["--backend", backend, "--device", "cpu"]


@pytest.mark.parametrize("which", ["kernel_weighting", "scatter2gather"])
def test_op_profiles_print_the_jax_scripts_lines(which):
    script = load_script("scripts/profile/%s.py" % which, "_jax_" + which)
    port = {"kernel_weighting": profile_kernel_weighting,
            "scatter2gather": profile_scatter2gather}[which]
    want, _ = _captured(script.main, SimpleNamespace(backend=None,
                                                     **OP_ARGS))
    unit = r"\d+\+ GB/s" if which == "kernel_weighting" else r"\d+ GB/s"
    line = re.compile(r"^%s (forward|fwd\+bwd): \d+\.\d{3} ms \(%s\)$"
                      % (which, unit))
    ops.reset_launch_counts()
    for backend in ("kernel", "plain"):
        got, times = _captured(port.main, _op_argv(backend))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert line.match(g) and line.match(w), (g, w)
            assert g.split(":")[0] == w.split(":")[0]
        assert set(times) == {"forward", "fwd+bwd"}
        assert all(t > 0 for t in times.values())
    assert not any(ops.launch_counts.values())


def test_model_stages_print_the_jax_scripts_lines(monkeypatch):
    """In float32 (XLA's CPU backend has no bfloat16 dot, so the JAX
    script runs on the CPU with ``--f32`` only)."""
    script = load_script("scripts/profile/model_stages.py", "_jax_stages")
    argv = STAGE_ARGS + ["--f32"]
    monkeypatch.setattr(sys, "argv", ["model_stages.py"] + argv)
    want, _ = _captured(script.main)
    got, times = _captured(profile_model_stages.main,
                           argv + ["--device", "cpu"])
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert STAGE_LINE.match(g) and STAGE_LINE.match(w), (g, w)
        assert g.split()[0] == w.split()[0]
    assert got[0] == want[0]
    assert set(times) == {"embed", "unet", "regress", "splat", "stage sum",
                          "model"}
    assert times["stage sum"] == pytest.approx(
        3 * times["embed"] + 3 * times["unet"] + times["regress"]
        + times["splat"])


def test_model_stages_bf16_and_a_subset():
    got, times = _captured(profile_model_stages.main, STAGE_ARGS + [
        "--device", "cpu"])
    assert got[0].endswith("dtype=bf16") and len(got) == 7
    assert all(STAGE_LINE.match(ln) for ln in got), got
    got, times = _captured(profile_model_stages.main, STAGE_ARGS + [
        "--f32", "--stages", "regress,splat", "--device", "cpu"])
    assert got[0].endswith("dtype=f32")
    assert [ln.split()[0] for ln in got] == ["#", "regress", "splat",
                                             "stage"]
    assert set(times) == {"regress", "splat", "stage sum"}


@pytest.mark.parametrize("module,argv", [
    ("profile_kernel_weighting", []), ("profile_scatter2gather", []),
    ("profile_model_stages", []), ("scatter_vs_gather", ["out"]),
    ("probe_vs_input", ["data", "ckpt"]),
    ("kernel_grids", ["--input", "d", "--checkpoint", "c", "--output",
                      "o"])])
def test_card_entry_points_need_cuda_unless_told(module, argv, monkeypatch):
    """Without ``--device cpu`` each entry point that runs on the card
    raises before any work when there is no CUDA device."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("sbmc_tpu_torch." + module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_new_modules_import_no_jax():
    """Every module this slice adds, imported in a fresh interpreter, pulls
    in neither jax nor anything of sbmc_tpu."""
    code = ("import importlib, json, sys\n"
            "for m in %r:\n"
            "    importlib.import_module('sbmc_tpu_torch.' + m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k.split('.')"
            "[0] in ('jax', 'jaxlib', 'flax', 'sbmc_tpu'))))\n"
            % (NEW_MODULES,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
