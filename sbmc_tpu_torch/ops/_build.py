"""Builds the port's hand-written kernels and loads them with ctypes.

The CUDA sources under ``csrc/`` compile with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``_build/`` beside this file. The library name
carries a hash of the sources, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_cuda", "load_host", "CSRC", "BUILD_DIR"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: sbmc_progressive_splat(data, logits, logits_bf16, sum_r, sum_w, max_w,
#:                        out_r, out_w, out_m, bs, c, h, w, k[, stream])
_PSF_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(names, flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for name in names:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(cmd_head, source, deps, stem, flags):
    """Compile ``source`` (plus header ``deps``) into a cached library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "%s_%s.so" % (
        stem, _digest([source] + deps, flags)))
    if os.path.exists(out):
        return out
    # Build to a private name and rename, so concurrent builders never load
    # a half-written library.
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.run(
        cmd_head + flags + ["-o", tmp, os.path.join(CSRC, source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building %s failed:\n%s%s" % (
            source, proc.stdout, proc.stderr))
    os.replace(tmp, out)
    return out


def load_cuda():
    """Build (once) and load the CUDA kernels; returns the ``ctypes.CDLL``."""
    with _lock:
        if "cuda" not in _loaded:
            path = _compile([_nvcc()], "progressive_splat.cu",
                            ["progressive_splat.cuh"], "libsbmc_kernels",
                            NVCC_FLAGS)
            lib = ctypes.CDLL(path)
            lib.sbmc_progressive_splat.argtypes = _PSF_ARGS + [_P]
            lib.sbmc_progressive_splat.restype = _I
            _loaded["cuda"] = lib
        return _loaded["cuda"]


def load_host():
    """Build (once) and load the host build of the splat kernel's per-pixel
    function (``csrc/progressive_splat_host.cpp``) with the system C++
    compiler; the CPU tests hold it against the plain PyTorch version."""
    with _lock:
        if "host" not in _loaded:
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no C++ compiler (g++/c++) on PATH")
            path = _compile([cxx], "progressive_splat_host.cpp",
                            ["progressive_splat.cuh"], "libsbmc_psf_host",
                            ["-O2", "-std=c++17", "-shared", "-fPIC"])
            lib = ctypes.CDLL(path)
            lib.sbmc_progressive_splat_host.argtypes = _PSF_ARGS
            lib.sbmc_progressive_splat_host.restype = _I
            _loaded["host"] = lib
        return _loaded["host"]
