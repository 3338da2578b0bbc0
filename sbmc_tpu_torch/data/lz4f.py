"""LZ4-frame compression via ctypes bindings to the system liblz4 (a copy of
``sbmc_tpu/data/lz4f.py``: the port imports nothing of the JAX package).

The reference stores sample tiles as LZ4-frame compressed blocks (written by
the patched PBRT's SampleRecord::write_compressed with the LZ4F API, read
back with python-lz4's ``lz4.frame.decompress``, reference:
sbmc/datasets.py:570-579). This module provides byte-compatible
``compress``/``decompress`` without the python-lz4 dependency.
"""

import ctypes
import ctypes.util

__all__ = ["compress", "decompress"]

_LZ4F_VERSION = 100


def _load():
    name = ctypes.util.find_library("lz4") or "liblz4.so.1"
    lib = ctypes.CDLL(name)
    lib.LZ4F_isError.restype = ctypes.c_uint
    lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
    lib.LZ4F_getErrorName.restype = ctypes.c_char_p
    lib.LZ4F_getErrorName.argtypes = [ctypes.c_size_t]
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    lib.LZ4F_compressFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_createDecompressionContext.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
    lib.LZ4F_decompress.restype = ctypes.c_size_t
    lib.LZ4F_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p]
    return lib


_lib = None


def _get():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _check(code):
    if _get().LZ4F_isError(code):
        raise RuntimeError(
            "lz4: %s" % _lib.LZ4F_getErrorName(code).decode())
    return code


def compress(data):
    """Compress ``bytes`` into a standalone LZ4 frame."""
    data = bytes(data)
    bound = _get().LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    n = _check(_lib.LZ4F_compressFrame(dst, bound, data, len(data), None))
    return dst.raw[:n]


def decompress(buf, expected_size=None):
    """Decompress a complete LZ4 frame to bytes.

    Args:
      buf: the full frame bytes.
      expected_size: optional output-size hint (avoids chunked growth).
    """
    buf = bytes(buf)
    ctx = ctypes.c_void_p()
    _check(_get().LZ4F_createDecompressionContext(
        ctypes.byref(ctx), _LZ4F_VERSION))
    try:
        out = bytearray()
        chunk = max(expected_size or 0, 4 * len(buf), 1 << 16)
        src_off = 0
        while src_off < len(buf):
            dst = ctypes.create_string_buffer(chunk)
            dst_size = ctypes.c_size_t(chunk)
            src_size = ctypes.c_size_t(len(buf) - src_off)
            src = (ctypes.c_char * (len(buf) - src_off)).from_buffer_copy(
                buf[src_off:])
            hint = _check(_lib.LZ4F_decompress(
                ctx, dst, ctypes.byref(dst_size), src,
                ctypes.byref(src_size), None))
            out += dst.raw[:dst_size.value]
            src_off += src_size.value
            if hint == 0:
                break
        return bytes(out)
    finally:
        _lib.LZ4F_freeDecompressionContext(ctx)
