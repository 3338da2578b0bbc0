"""Builder and loader of the OpenEXRCore reader bridge (``src/fastexr.cpp``).

:func:`sbmc_tpu_torch.utils.exr.read_channels` decodes NONE, ZIP and ZIPS
itself; every other compression (PIZ, the compression of the reference's
evaluation renders, PXR24, DWA, ...) goes through this bridge, a CPython
extension that binds the system ``libOpenEXRCore``. It is built from the
repo-level source with ``g++`` at first use, into ``_native_build/`` beside
this file, under a name that carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs at
import time.
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading

__all__ = ["load", "SOURCE", "BUILD_DIR"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "src", "fastexr.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_native_build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIB = "-l:libOpenEXRCore-3_1.so.30"

_lock = threading.Lock()
_module = None


def _build():
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "_fastexr_%s.so" % digest)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name and rename, so concurrent processes never
    # load a half-written library.
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = (["g++"] + _FLAGS
           + ["-I", sysconfig.get_paths()["include"], "-I",
              "/usr/include/Imath", SOURCE, "-o", tmp, _LIB])
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building %s failed:\n%s" % (SOURCE, proc.stdout))
    os.replace(tmp, out)
    return out


def load():
    """Build (once) and import the bridge; returns the module, whose
    ``read(path)`` gives ``(channel names, float32 planes as bytes, height,
    width)``. Raises ``RuntimeError`` or ``OSError`` if it cannot be built
    or loaded (no compiler, no OpenEXRCore headers or library)."""
    global _module
    with _lock:
        if _module is None:
            spec = importlib.util.spec_from_file_location("_fastexr",
                                                          _build())
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        return _module
