"""Builds the port's hand-written kernels and loads them with ctypes.

The CUDA sources under ``csrc/`` compile with ``nvcc`` into shared
libraries with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``_build/`` beside this file: one library per
source, all compilers started together. A library's name carries a hash of
every file under ``csrc/`` and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded. Nothing here runs at import
time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types

__all__ = ["load_cuda", "load_host", "CSRC", "BUILD_DIR"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: sbmc_progressive_splat_generic(data, logits, logits_bf16, sum_r, sum_w,
#:                                max_w, out_r, out_w, out_m, bs, c, h, w,
#:                                k[, stream]); the tiled sbmc_progressive_splat
#:                                takes tile_h before the stream, the host
#:                                build of its rows `groups` last
_PSF_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_progressive_splat_ddata_generic(logits, logits_bf16, new_max, d_r,
#:                                      d_data, bs, c, h, w, k[, stream]); the
#:                                      vector sbmc_progressive_splat_ddata
#:                                      takes groups before the stream, the
#:                                      host build of its tiles `groups`
#:                                      last
_DDATA_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_progressive_splat_dlogits_generic(data, logits, logits_bf16, new_max,
#:                                        d_r, d_w, d_logits, bs, c, h, w,
#:                                        k[, stream]); the vector
#:                                        sbmc_progressive_splat_dlogits takes
#:                                        row_blocks before the stream
_DLOGITS_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_kernel_weighting_generic(data, weights, weights_bf16, out, sum_w,
#:                               bs, c, h, w, k[, stream]); the tiled
#:                               sbmc_kernel_weighting takes v and groups
#:                               before the stream
_KW_ARGS = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_kernel_weighting_dw_generic(data, d_out, d_sum_w, d_w,
#:                                  bs, c, h, w, k[, stream])
_KW_DW_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_kernel_weighting_dw(data, d_out, d_sum_w, d_w, out_bf16,
#:                          bs, c, h, w, k, v, groups[, stream])
_KW_DW_TILED_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I]
#: sbmc_scatter2gather_generic(weights, itemsize, out, bs, h, w, k[, stream]);
#:                             the vector sbmc_scatter2gather (and its host
#:                             build) takes v, the elements of an item,
#:                             before the stream
_S2G_ARGS = [_P, _I, _P, _I, _I, _I, _I]
#: sbmc_scatter2gather_max(weights, itemsize, out, kmax, bs, h, w, k[, stream])
_S2G_MAX_ARGS = [_P, _I, _P, _P, _I, _I, _I, _I]
#: sbmc_kernel_weighting_exp_generic(data, logits, logits_bf16, maxes, out,
#:                                   sum_w, bs, c, h, w, k[, stream]); the
#:                                   tiled sbmc_kernel_weighting_exp takes v
#:                                   and groups before the stream
_KW_EXP_ARGS = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I]
#: sbmc_threefry_uniform(keys, n_keys, n, lo, span, raw, out[, stream])
_THREEFRY_ARGS = [_P, _I, _I, _F, _F, _I, _P]
#: sbmc_tri_nearest(org, dirs, time, tris, n, t, out_t, out_idx,
#:                  out_back[, stream])
_TRI_NEAREST_ARGS = [_P, _P, _P, _P, _I, _I, _P, _P, _P]
#: sbmc_tri_any(org, dirs, dist, tris, n, t, out[, stream])
_TRI_ANY_ARGS = [_P, _P, _P, _P, _I, _I, _P]
#: the tiled sbmc_tri_any takes its queue (one int32, 0) before the
#: stream; the host builds of the tiled loop take rays (the rays a thread)
#: last; the generic kernels are sbmc_tri_nearest_generic and
#: sbmc_tri_any_generic
#: sbmc_sample_embed(x, x_bs, x_ss, cx, kx, e, ce, ke, ebias, wx, we, w1, w2,
#:                   bias, mask, nvalid, out, reduced, cout, bs, spp, hw,
#:                   grid[, stream])
_SAMPLE_EMBED_ARGS = [_P, _L, _L, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _I, _L, _I]
#: sbmc_sample_regress(x, x_bs, cx, e, ce, k0, w0, w1, w2, bias, out, nout,
#:                     bs, hw, grid[, stream])
_SAMPLE_REGRESS_ARGS = [_P, _L, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                        _L, _I]
#: sbmc_sample_embed_fits(cx, ce, hidden, cout), sbmc_sample_regress_fits(
#: k_in, hidden, nout): whether a chain fits the kernels (host functions, no
#: stream)
#: sbmc_unet_epilogue(y, bias, out, ldo, pool, act, bs, h, w, c, sms[, stream])
_UNET_EPILOGUE_ARGS = [_P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I]
#: sbmc_unet_upsample(x, out, ldo, bs, hi, wi, ho, wo, c[, stream])
_UNET_UPSAMPLE_ARGS = [_P, _P, _L, _I, _I, _I, _I, _I, _I]
#: sbmc_unet_layout(src, dst, to_nhwc, bs, c, h, w, sms[, stream])
_UNET_LAYOUT_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I]
#: sbmc_unet_epilogue_backward(dy, ldy, out, ldo, dpool, act, dz, partials,
#:                             nparts, dbias, bs, h, w, c, sms[, stream])
_UNET_EPILOGUE_BWD_ARGS = [_P, _L, _P, _L, _P, _I, _P, _P, _I, _P, _I, _I, _I,
                           _I, _I]
#: sbmc_unet_upsample_backward(g, ldg, dx, bs, hi, wi, ho, wo, c[, stream])
_UNET_UPSAMPLE_BWD_ARGS = [_P, _L, _P, _I, _I, _I, _I, _I, _I]
#: sbmc_kpcn_entry(x, dtype, out, bs, c, h, w, width, sms[, stream])
_KPCN_ENTRY_ARGS = [_P, _I, _P, _I, _I, _I, _I, _I, _I]
#: sbmc_kpcn_exit(y, bias, out, bs, h, w, c, k2, sms[, stream])
_KPCN_EXIT_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I]

#: source -> {exported function: argument types}; the CUDA entry points take
#: the stream as one more pointer.
_CUDA = {
    "progressive_splat.cu": {
        "sbmc_progressive_splat": _PSF_ARGS + [_I, _P],
        "sbmc_progressive_splat_generic": _PSF_ARGS + [_P]},
    "progressive_splat_bwd.cu": {
        "sbmc_progressive_splat_ddata": _DDATA_ARGS + [_I, _P],
        "sbmc_progressive_splat_ddata_generic": _DDATA_ARGS + [_P],
        "sbmc_progressive_splat_dlogits": _DLOGITS_ARGS + [_I, _P],
        "sbmc_progressive_splat_dlogits_generic": _DLOGITS_ARGS + [_P]},
    "kernel_weighting.cu": {
        "sbmc_kernel_weighting": _KW_ARGS + [_I, _I, _P],
        "sbmc_kernel_weighting_generic": _KW_ARGS + [_P],
        "sbmc_kernel_weighting_dw": _KW_DW_TILED_ARGS + [_P],
        "sbmc_kernel_weighting_dw_generic": _KW_DW_ARGS + [_P],
        "sbmc_kernel_weighting_exp": _KW_EXP_ARGS + [_I, _I, _P],
        "sbmc_kernel_weighting_exp_generic": _KW_EXP_ARGS + [_P]},
    "scatter2gather.cu": {
        "sbmc_scatter2gather": _S2G_ARGS + [_I, _P],
        "sbmc_scatter2gather_generic": _S2G_ARGS + [_P],
        "sbmc_scatter2gather_max": _S2G_MAX_ARGS + [_P]},
    "threefry.cu": {
        "sbmc_threefry_uniform": _THREEFRY_ARGS + [_P]},
    "trace_hits.cu": {
        "sbmc_tri_nearest": _TRI_NEAREST_ARGS + [_P],
        "sbmc_tri_nearest_generic": _TRI_NEAREST_ARGS + [_P],
        "sbmc_tri_any": _TRI_ANY_ARGS + [_P, _P],
        "sbmc_tri_any_generic": _TRI_ANY_ARGS + [_P]},
    "sample_chain.cu": {
        "sbmc_sample_embed": _SAMPLE_EMBED_ARGS + [_P],
        "sbmc_sample_regress": _SAMPLE_REGRESS_ARGS + [_P],
        "sbmc_sample_embed_fits": [_I, _I, _I, _I],
        "sbmc_sample_regress_fits": [_I, _I, _I]},
    "unet.cu": {
        "sbmc_unet_epilogue": _UNET_EPILOGUE_ARGS + [_P],
        "sbmc_unet_upsample": _UNET_UPSAMPLE_ARGS + [_P],
        "sbmc_unet_layout": _UNET_LAYOUT_ARGS + [_P],
        "sbmc_unet_epilogue_backward": _UNET_EPILOGUE_BWD_ARGS + [_P],
        "sbmc_unet_upsample_backward": _UNET_UPSAMPLE_BWD_ARGS + [_P]},
    "kpcn.cu": {
        "sbmc_kpcn_entry": _KPCN_ENTRY_ARGS + [_P],
        "sbmc_kpcn_exit": _KPCN_EXIT_ARGS + [_P]},
}
_HOST = {
    "progressive_splat_host.cpp": {
        "sbmc_progressive_splat_host": _PSF_ARGS,
        "sbmc_progressive_splat_rows_host": _PSF_ARGS + [_I]},
    "progressive_splat_bwd_host.cpp": {
        "sbmc_progressive_splat_ddata_host": _DDATA_ARGS,
        "sbmc_progressive_splat_ddata_tiles_host": _DDATA_ARGS + [_I],
        "sbmc_progressive_splat_dlogits_host": _DLOGITS_ARGS,
        "sbmc_progressive_splat_dlogits_rows_host": _DLOGITS_ARGS},
    "kernel_weighting_host.cpp": {
        "sbmc_kernel_weighting_host": _KW_ARGS,
        "sbmc_kernel_weighting_tiles_host": _KW_ARGS + [_I, _I],
        "sbmc_kernel_weighting_dw_host": _KW_DW_ARGS,
        "sbmc_kernel_weighting_dw_tiles_host": _KW_DW_TILED_ARGS,
        "sbmc_kernel_weighting_exp_host": _KW_EXP_ARGS,
        "sbmc_kernel_weighting_exp_tiles_host": _KW_EXP_ARGS + [_I, _I]},
    "scatter2gather_host.cpp": {
        "sbmc_scatter2gather_host": _S2G_ARGS,
        "sbmc_scatter2gather_vec_host": _S2G_ARGS + [_I],
        "sbmc_scatter2gather_max_host": _S2G_MAX_ARGS},
    "threefry_host.cpp": {
        "sbmc_threefry_uniform_host": _THREEFRY_ARGS},
    "trace_hits_host.cpp": {
        "sbmc_tri_nearest_host": _TRI_NEAREST_ARGS,
        "sbmc_tri_nearest_tiles_host": _TRI_NEAREST_ARGS + [_I],
        "sbmc_tri_any_host": _TRI_ANY_ARGS,
        "sbmc_tri_any_tiles_host": _TRI_ANY_ARGS + [_I]},
}

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


def _digest(flags):
    """Hash of the flags and of every file under ``csrc/``: any source may
    include any header, so an edit anywhere rebuilds everything."""
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(compiler, table, flags):
    """Compile each source of ``table`` into its own cached library (the
    missing ones in parallel), load them, and return a namespace of the
    exported functions with their argument types set."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest(flags)
    running = []
    paths = {}
    for source in table:
        stem = "lib" + os.path.splitext(source)[0]
        out = os.path.join(BUILD_DIR, "%s_%s.so" % (stem, digest))
        paths[source] = out
        if os.path.exists(out):
            continue
        # Build to a private name and rename, so concurrent processes never
        # load a half-written library.
        tmp = "%s.%d.tmp" % (out, os.getpid())
        proc = subprocess.Popen(
            [compiler] + flags + ["-o", tmp, os.path.join(CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, out))
    failures = []
    for source, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append("building %s failed:\n%s" % (source, log))
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    fns = types.SimpleNamespace()
    for source, exported in table.items():
        lib = ctypes.CDLL(paths[source])
        for name, argtypes in exported.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
            setattr(fns, name, fn)
    return fns


def load_cuda():
    """Build (once) and load the CUDA kernels; returns a namespace holding
    every entry point of ``_CUDA`` (``sbmc_progressive_splat``,
    ``sbmc_kernel_weighting``, ``sbmc_scatter2gather``, ...)."""
    with _lock:
        if "cuda" not in _loaded:
            _loaded["cuda"] = _build(_nvcc(), _CUDA, NVCC_FLAGS)
        return _loaded["cuda"]


def load_host():
    """Build (once) and load the host builds of the kernels' per-pixel
    functions (``csrc/*_host.cpp``) with the system C++ compiler; the CPU
    tests hold them against the plain PyTorch versions."""
    with _lock:
        if "host" not in _loaded:
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no C++ compiler (g++/c++) on PATH")
            _loaded["host"] = _build(cxx, _HOST, HOST_FLAGS)
        return _loaded["host"]
