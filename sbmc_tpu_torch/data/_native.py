"""Builder and loader of the native ``.bin`` sample decoder
(``src/fastbin.cpp``).

:func:`sbmc_tpu_torch.data.bin_format.read_tile` decodes a tile's per-sample
lz4 blocks through this CPython extension: one pass over the file's bytes,
the blocks decompressed by a pool of threads straight into the output
arrays, with the interpreter lock released. It is built from the
repo-level source with ``g++`` against the system ``liblz4`` at first use,
into ``_native_build/`` beside this file, under a name that carries a hash
of the source, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.

Where it cannot be built (no compiler, no Python headers, no liblz4),
:func:`get` returns None and ``read_tile`` decodes in Python, which gives
the same arrays; :func:`get` logs once which decoder runs.
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading

from sbmc_tpu_torch.utils.logging import get_logger

__all__ = ["get", "load", "SOURCE", "BUILD_DIR"]

LOG = get_logger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "src", "fastbin.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_native_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-l:liblz4.so.1", "-lpthread"]

_lock = threading.RLock()
_module = None
_tried = False


def _build():
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "_fastbin_%s.so" % digest)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name and rename, so concurrent processes never
    # load a half-written library.
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = (["g++"] + _FLAGS + ["-I", sysconfig.get_paths()["include"],
                               SOURCE, "-o", tmp] + _LIBS)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building %s failed:\n%s" % (SOURCE, proc.stdout))
    os.replace(tmp, out)
    return out


def load():
    """Build (once) and import the decoder; returns the module, whose
    ``decode_sample_blocks`` fills a tile's sample arrays. Raises
    ``RuntimeError`` or ``OSError`` if it cannot be built or loaded."""
    global _module
    with _lock:
        if _module is None:
            spec = importlib.util.spec_from_file_location("_fastbin",
                                                          _build())
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        return _module


def get():
    """The native decoder, or None when it cannot be built here; the first
    call logs which decoder ``read_tile`` uses."""
    global _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                load()
            except (RuntimeError, OSError) as e:
                LOG.warning("native .bin decoder unavailable, decoding in "
                            "Python: %s", e)
            else:
                LOG.info("native .bin decoder: %s", _module.__file__)
        return _module
