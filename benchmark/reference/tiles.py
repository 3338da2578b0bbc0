"""Uniform overlapping tiles of a frame, as the denoise command line's
``--uniform_tiles`` cuts them: the frame is zero-padded at its bottom and
right to a grid of ``(ny, nx)`` tiles of one size ``(th, tw)``, neighbours
overlapping by ``2 * pad``.
"""

import torch

__all__ = ["uniform_grid", "uniform_cut"]


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) \
        else (int(v), int(v))


def uniform_grid(h, w, tile, pad):
    """``(ny, nx, (th, tw), (py, px), (sy, sx))`` of a frame."""
    (th, tw), (py, px) = _pair(tile), _pair(pad)
    sy, sx = th - 2 * py, tw - 2 * px
    if sy <= 0 or sx <= 0:
        raise ValueError("tile must exceed 2 * pad")
    ny = max(1, -(-(h - 2 * py) // sy))
    nx = max(1, -(-(w - 2 * px) // sx))
    return ny, nx, (th, tw), (py, px), (sy, sx)


def uniform_cut(frame, tile, pad):
    """Cut a ``[..., h, w]`` tensor into ``[n_tiles, ..., th, tw]``
    (the leading batch axis of 1 dropped)."""
    h, w = frame.shape[-2:]
    ny, nx, (th, tw), _, (sy, sx) = uniform_grid(h, w, tile, pad)
    ph, pw = (ny - 1) * sy + th, (nx - 1) * sx + tw
    fp = torch.nn.functional.pad(frame, (0, pw - w, 0, ph - h))
    return torch.stack([fp[0, ..., iy * sy:iy * sy + th,
                           ix * sx:ix * sx + tw]
                        for iy in range(ny) for ix in range(nx)])
