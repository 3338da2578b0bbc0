"""The port's EXR reader on files it does not decode itself, against the JAX
package's.

``tests/data/piz_rgb_64x48.exr`` is PIZ-compressed, the compression of the
reference's evaluation renders. Both packages read it through the
OpenEXRCore bridge (``src/fastexr.cpp``), each building it itself; the
tests that need it skip where it does not build, as ``TestNativeExr`` in
tests/test_pipeline_extras.py does.

Tolerances: none. The decoded planes are compared bit for bit, and the
metrics written by ``evaluation.compute`` from a PIZ reference are the same
CSV text as the JAX package's.
"""

import os
import shutil

import numpy as np
import pytest

from sbmc_tpu import evaluation as jeval
from sbmc_tpu.utils import _native_exr as jnative
from sbmc_tpu.utils import exr as jexr
from sbmc_tpu_torch import evaluation
from sbmc_tpu_torch.utils import _native_exr, exr

PIZ = os.path.join(os.path.dirname(__file__), "data", "piz_rgb_64x48.exr")


@pytest.fixture
def bridges():
    """Skips unless both packages' bridges build here."""
    try:
        _native_exr.load()
    except (OSError, RuntimeError) as e:
        pytest.skip("the port's OpenEXRCore bridge does not build: %s" % e)
    if jnative.get() is None:
        pytest.skip("the JAX package's OpenEXRCore bridge is unavailable")


def test_piz_read_is_the_jax_read(bridges):
    got, want = exr.read(PIZ), jexr.read(PIZ)
    assert got.shape == (48, 64, 3) and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    chans, size = exr.read_channels(PIZ)
    jchans, jsize = jexr.read_channels(PIZ)
    assert size == jsize and sorted(chans) == sorted(jchans)
    for name in chans:
        assert chans[name].tobytes() == jchans[name].tobytes()


def test_compute_with_a_piz_reference_matches_jax(bridges, tmp_path):
    """``evaluation.compute`` reads the reference through the bridge and the
    methods' ZIP outputs itself; the CSV is the JAX package's."""
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    shutil.copy(PIZ, str(ref_dir / "scene.exr"))
    ref = exr.read(PIZ)
    rng = np.random.RandomState(5)
    methods = []
    for i, name in enumerate(("4spp_input", "4spp_ours")):
        d = tmp_path / name
        d.mkdir()
        noisy = ref + (0.2 / (i + 1)) * rng.randn(*ref.shape)
        exr.write(str(d / "scene.exr"), noisy.astype(np.float32),
                  pixel_type="float")
        methods.append(str(d))
    got_csv, want_csv = str(tmp_path / "port.csv"), str(tmp_path / "j.csv")
    rows = evaluation.compute(str(ref_dir), got_csv, methods, ["scene.exr"],
                              pad=3)
    jeval.compute(str(ref_dir), want_csv, methods, ["scene.exr"], pad=3)
    with open(got_csv) as f, open(want_csv) as g:
        assert f.read() == g.read()
    assert len(rows) == 2 and all(r["valid"] for r in rows)
    assert rows[0]["mse"] > rows[1]["mse"] > 0


def test_missing_bridge_is_named(monkeypatch):
    def unavailable():
        raise RuntimeError("no OpenEXRCore headers")
    monkeypatch.setattr(_native_exr, "load", unavailable)
    with pytest.raises(NotImplementedError,
                       match="compression id 4 .*OpenEXRCore bridge"):
        exr.read(PIZ)
