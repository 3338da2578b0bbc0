"""Small image helpers (counterpart of ``sbmc_tpu/utils/image.py``)."""

import struct
import zlib

import numpy as np
import torch

__all__ = ["crop_like", "tonemap", "write_png"]


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
    """Write an ``[h, w, 3]`` uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes [h, w, 3] images, got {img.shape}")

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    # Each scanline starts with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
