"""Small image helpers (counterpart of ``sbmc_tpu/utils/image.py``)."""

import struct
import zlib

import numpy as np
import torch

__all__ = ["crop_like", "tonemap", "write_png", "read_png"]


def crop_like(src, tgt):
    """Center-crop the last two (spatial) dims of ``src`` to match ``tgt``.

    Works for tensors or arrays whose spatial dims are the last two axes.
    """
    sh, sw = src.shape[-2], src.shape[-1]
    th, tw = tgt.shape[-2], tgt.shape[-1]
    if (sh, sw) == (th, tw):
        return src
    if sh < th or sw < tw:
        raise ValueError(f"cannot crop {tuple(src.shape)} to larger "
                         f"{tuple(tgt.shape)}")
    dy, dx = (sh - th) // 2, (sw - tw) // 2
    return src[..., dy:dy + th, dx:dx + tw]


def tonemap(im):
    """Reinhard tonemap ``x / (1 + x)`` of a tensor after clamping
    negatives."""
    im = torch.clamp(im, min=0)
    return im / (1.0 + im)


def write_png(path, img):
    """Write an ``[h, w, 3]`` uint8 image as an 8-bit RGB PNG, or an
    ``[h, w]`` uint8 or uint16 image as an 8- or 16-bit grey PNG (the
    layouts ``imageio`` writes for these arrays)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
        ctype, depth = 2, 8
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, 8 * img.dtype.itemsize
    else:
        raise ValueError("write_png takes [h, w, 3] uint8 or [h, w] uint8 "
                         f"/ uint16 images, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    # PNG stores 16-bit samples big-endian.
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(h, -1).view(np.uint8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    # Each scanline starts with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows],
                         axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


#: PNG colour type -> channels (grey, RGB, grey + alpha, RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, h, stride, bpp):
    """Undo the five PNG row filters (none, sub, up, average, Paeth) of
    ``h`` scanlines of ``stride`` bytes, ``bpp`` bytes a pixel."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has %d bytes, expected %d"
                         % (rows.size, h * (stride + 1)))
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:       # sub: add the byte one pixel to the left
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:       # up: add the byte above
            cur = (line + prior) & 255
        elif ftype in (3, 4):  # average / Paeth: left to right, a pixel
            cur = np.empty(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = ((left + up) >> 1 if ftype == 3
                        else _paeth(left, up, upleft))
                left = (line[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError("PNG row %d has unknown filter type %d"
                             % (y, ftype))
        out[y] = cur
        prior = cur
    return out


def read_png(path):
    """Decode a PNG file with zlib and the five row filters.

    Reads 8- and 16-bit grey, grey + alpha, RGB and RGBA images without
    interlacing, which is what the renderer's texture folders hold. Returns
    ``[h, w]`` (grey) or ``[h, w, c]``, ``uint8`` or ``uint16``, as
    ``imageio`` does. Palette images, bit depths below 8 and interlaced
    files raise ``NotImplementedError``; a damaged file raises
    ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG colour type {ctype}, bit depth {depth}, interlace "
            f"{interlace}; read_png takes 8/16-bit grey, grey+alpha, RGB "
            "and RGBA without interlacing")
    c = _PNG_CHANNELS[ctype]
    bpp = c * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: {e}") from e
    px = _unfilter(raw, h, w * bpp, bpp)
    im = (px.reshape(h, w, c) if depth == 8 else
          px.view(">u2").astype(np.uint16).reshape(h, w, c))
    return im[:, :, 0] if c == 1 else im
