"""Minimal OpenEXR 2 scanline reader/writer (float32/float16, NONE/ZIP/ZIPS);
a copy of ``sbmc_tpu/utils/exr.py``.

Plays the role pyexr plays for the reference (scripts/denoise.py:170,
sbmc/evaluation.py) without external bindings: enough of the EXR format to
write denoiser outputs and read them back for evaluation — single-part
scanline images, RGB(A)/arbitrary channels, NONE/ZIP/ZIPS compression (ZIP
uses the EXR byte-reorder + delta predictor over zlib). Files in any other
compression (PIZ, PXR24, DWA, ...) are read through the OpenEXRCore bridge
(:mod:`sbmc_tpu_torch.utils._native_exr`).
"""

import struct
import zlib

import numpy as np

__all__ = ["read", "write", "read_channels"]

_MAGIC = 20000630
_PIXELTYPE = {"half": 1, "float": 2}
_DTYPE = {1: np.float16, 2: np.float32, 0: np.uint32}
_ZIP_BLOCK = {0: 1, 2: 1, 3: 16}  # lines per chunk by compression id


def _write_attr(f, name, typ, data):
    f.write(name.encode() + b"\0" + typ.encode() + b"\0")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def _predictor_encode(buf):
    a = np.frombuffer(buf, np.uint8).astype(np.int16)
    d = np.empty_like(a)
    d[0] = a[0]
    d[1:] = a[1:] - a[:-1] + 128 + 256
    d = (d & 0xff).astype(np.uint8)
    # split into two interleaved halves
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = d[0::2]
    out[half:] = d[1::2]
    return out.tobytes()


def _predictor_decode(buf):
    a = np.frombuffer(buf, np.uint8)
    n = len(a)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[0::2] = a[:half]
    inter[1::2] = a[half:]
    d = inter.astype(np.int16)
    d[1:] -= 128 + 256
    out = np.cumsum(d, dtype=np.int64) & 0xff
    return out.astype(np.uint8).tobytes()


def write(path, img, channel_names=None, pixel_type="half",
          compression="zip"):
    """Write an EXR image.

    Args:
      img: ``[h, w]`` or ``[h, w, c]`` array.
      channel_names: defaults to ["Y"], ["R","G","B"], or ["R","G","B","A"]
        by channel count.
      pixel_type: "half" or "float".
      compression: "none", "zips" or "zip".
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"],
                         4: ["R", "G", "B", "A"]}[c]
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    dtype = np.float16 if pixel_type == "half" else np.float32
    img = img.astype(dtype)

    order = np.argsort(channel_names)  # channels stored alphabetically
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        chlist = b""
        for i in order:
            chlist += channel_names[i].encode() + b"\0"
            chlist += struct.pack("<i", _PIXELTYPE[pixel_type])
            chlist += struct.pack("<BBBB", 0, 0, 0, 0)
            chlist += struct.pack("<ii", 1, 1)
        chlist += b"\0"
        _write_attr(f, "channels", "chlist", chlist)
        _write_attr(f, "compression", "compression",
                    struct.pack("<B", comp_id))
        box = struct.pack("<4i", 0, 0, w - 1, h - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("<B", 0))
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\0")

        lines_per = _ZIP_BLOCK[comp_id]
        n_chunks = (h + lines_per - 1) // lines_per
        offset_pos = f.tell()
        f.write(b"\0" * 8 * n_chunks)

        offsets = []
        for chunk in range(n_chunks):
            y0 = chunk * lines_per
            ny = min(lines_per, h - y0)
            raw = b""
            for line in range(y0, y0 + ny):
                for i in order:
                    raw += img[line, :, i].tobytes()
            if comp_id == 0:
                data = raw
            else:
                data = zlib.compress(_predictor_encode(raw))
                if len(data) >= len(raw):
                    data = raw
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
        f.seek(offset_pos)
        f.write(struct.pack("<%dq" % n_chunks, *offsets))


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while True:
            ch = f.read(1)
            if ch == b"\0":
                break
            name += ch
        if name == b"":
            break
        typ = b""
        while True:
            ch = f.read(1)
            if ch == b"\0":
                break
            typ += ch
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))
    return attrs


def _native_read(path, comp_id):
    """Decode through the OpenEXRCore bridge; returns the read_channels
    result. Raises ``NotImplementedError`` if the bridge cannot be built."""
    from sbmc_tpu_torch.utils import _native_exr
    try:
        mod = _native_exr.load()
    except (OSError, RuntimeError) as e:
        raise NotImplementedError(
            f"EXR compression id {comp_id} is read through the OpenEXRCore "
            f"bridge (src/fastexr.cpp), which is unavailable: {e}") from e
    names, planes, h, w = mod.read(path)
    out = {name: np.frombuffer(buf, np.float32).reshape(h, w)
           for name, buf in zip(names, planes)}
    return out, (h, w)


def _parse_chlist(data):
    chans = []
    off = 0
    while data[off] != 0:
        end = data.index(b"\0", off)
        name = data[off:end].decode()
        off = end + 1
        ptype = struct.unpack("<i", data[off:off + 4])[0]
        off += 16  # type + pLinear/reserved + x/y sampling
        chans.append((name, ptype))
    return chans


def read_channels(path):
    """Read an EXR; returns (dict name -> [h, w] float32 array, (h, w)).

    Compressions beyond NONE/ZIP/ZIPS (PIZ, PXR24, DWA, ...) are decoded by
    the OpenEXRCore bridge.
    """
    with open(path, "rb") as f:
        magic, _version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not an EXR file")
        attrs = _read_attrs(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp_id = attrs["compression"][1][0]
        if comp_id not in _ZIP_BLOCK:
            return _native_read(path, comp_id)
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
        w, h = x1 - x0 + 1, y1 - y0 + 1

        lines_per = _ZIP_BLOCK[comp_id]
        n_chunks = (h + lines_per - 1) // lines_per
        f.read(8 * n_chunks)  # offset table (we read sequentially)

        out = {name: np.empty((h, w), np.float32) for name, _ in chans}
        line_bytes = sum(w * np.dtype(_DTYPE[pt]).itemsize
                         for _, pt in chans)
        for _ in range(n_chunks):
            cy, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            ny = min(lines_per, y1 + 1 - cy)
            raw_len = line_bytes * ny
            if comp_id != 0 and size < raw_len:
                data = _predictor_decode(zlib.decompress(data))
            for line in range(ny):
                off = line * line_bytes
                for name, pt in chans:
                    dt = np.dtype(_DTYPE[pt])
                    nb = w * dt.itemsize
                    row = np.frombuffer(data[off:off + nb], dt)
                    out[name][cy - y0 + line] = row.astype(np.float32)
                    off += nb
        return out, (h, w)


def read(path, channel_names=None):
    """Read an EXR as an ``[h, w, c]`` float32 array.

    Channels are returned in ``channel_names`` order (default RGB(A) or Y,
    falling back to alphabetical file order).
    """
    chans, (h, w) = read_channels(path)
    if channel_names is None:
        if set("RGB").issubset(chans):
            channel_names = ["R", "G", "B"] + (
                ["A"] if "A" in chans else [])
        elif "Y" in chans:
            channel_names = ["Y"]
        else:
            channel_names = sorted(chans)
    return np.stack([chans[c] for c in channel_names], -1)
