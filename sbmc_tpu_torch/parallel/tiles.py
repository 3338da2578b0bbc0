"""Overlap-tiled full-frame inference (a copy of
``sbmc_tpu/parallel/tiles.py``; reference: scripts/denoise.py:42-93).

Large frames are processed in overlapping tiles to bound device memory; the
overlap (``pad``) absorbs the model's receptive-field border so tiles stitch
seamlessly. ``split_tiles``/``pad_back``/``merge_tiles`` reproduce the
reference semantics (with the reference's tile-duplication and dropped
global-features quirks fixed); tiles are independent, so they can be
round-robined across devices or hosts for multi-chip denoising.
"""

import numpy as np

__all__ = ["split_tiles", "pad_back", "merge_tiles",
           "split_tiles_uniform", "merge_tiles_uniform"]

_TILE_KEYS = ["radiance", "features", "kpcn_diffuse_in", "kpcn_specular_in",
              "kpcn_diffuse_buffer", "kpcn_specular_buffer", "kpcn_albedo"]
_UNCHANGED_KEYS = ["global_features", "sample_mask", "spp"]


def split_tiles(batch, max_sz=1024, pad=256):
    """Split a full-frame batch into overlapping tiles.

    Args:
      batch: dict with image-like arrays (spatial dims last).
      max_sz: maximum tile extent (including overlap).
      pad: overlap with neighboring tiles on interior edges.

    Returns:
      list of ``(tile_batch, y0, y1, x0, x1, (py0, py1, px0, px1))`` where
      ``[y0:y1, x0:x1]`` is the output region this tile is responsible for
      and the ``p*`` entries are the overlap margins to strip from the
      tile's (re-padded) output.
    """
    ref_key = "features" if "features" in batch else "kpcn_diffuse_in"
    h, w = batch[ref_key].shape[-2:]
    if h <= max_sz and w <= max_sz:
        return [(batch, 0, h, 0, w, (0, 0, 0, 0))]
    step = max_sz - 2 * pad
    if step <= 0:
        raise ValueError("max_sz must exceed 2 * pad")
    tiles = []
    for start_y in range(0, h, step):
        pad_y, pad_y2 = (0 if start_y == 0 else pad), pad
        end_y = start_y + max_sz
        if end_y >= h:
            end_y, pad_y2 = h, 0
        for start_x in range(0, w, step):
            pad_x, pad_x2 = (0 if start_x == 0 else pad), pad
            end_x = start_x + max_sz
            if end_x >= w:
                end_x, pad_x2 = w, 0
            tb = {}
            for k in _UNCHANGED_KEYS:
                if k in batch:
                    tb[k] = batch[k]
            for k in _TILE_KEYS:
                if k in batch:
                    tb[k] = batch[k][..., start_y:end_y, start_x:end_x]
            tiles.append((tb, start_y + pad_y, end_y - pad_y2,
                          start_x + pad_x, end_x - pad_x2,
                          (pad_y, pad_y2, pad_x, pad_x2)))
            if end_x == w:
                break
        if end_y == h:
            break
    return tiles


def pad_back(tile_batch, out):
    """Zero-pad a model output back to its input tile size (the model crops
    a receptive-field border, reference: scripts/denoise.py:42-51)."""
    ref_key = "features" if "features" in tile_batch else "kpcn_diffuse_in"
    ref = tile_batch[ref_key]
    pad_h = (ref.shape[-2] - out.shape[-2]) // 2
    pad_w = (ref.shape[-1] - out.shape[-1]) // 2
    p = max(pad_h, pad_w)
    widths = [(0, 0)] * (out.ndim - 2) + [(p, p), (p, p)]
    return np.pad(np.asarray(out), widths)


def merge_tiles(canvas, tile_outputs):
    """Paste stripped tile outputs into the full-frame canvas.

    Args:
      canvas: ``[..., h, w]`` numpy array to fill.
      tile_outputs: iterable of ``(out, y0, y1, x0, x1, tilepad)`` where
        ``out`` is the tile's re-padded output (input-tile-sized).
    """
    for out, y0, y1, x0, x1, (py0, py1, px0, px1) in tile_outputs:
        out = np.asarray(out)
        out = out[..., py0:out.shape[-2] - py1, px0:out.shape[-1] - px1]
        canvas[..., y0:y1, x0:x1] = out
    return canvas


def _pair(v):
    """Normalize an int-or-(y, x) argument to a (y, x) tuple."""
    if isinstance(v, (tuple, list)):
        ty, tx = v
        return int(ty), int(tx)
    return int(v), int(v)


def split_tiles_uniform(batch, tile=512, pad=128):
    """Split into *uniform-size* overlapping tiles stacked on the batch axis.

    Unlike :func:`split_tiles` (reference semantics, ragged edge tiles and a
    Python loop), every tile here is exactly ``tile x tile`` — the frame is
    zero-padded up to the tiling grid — so all tiles stack into one batched
    array: a single compiled ``model.apply`` serves the whole frame and the
    batch axis shards over a device mesh (true SPMD multi-chip denoise).

    Args:
      batch: dict of image-like arrays with batch dim 1.
      tile: tile extent (must exceed ``2 * pad``); an int for square tiles
        or a ``(th, tw)`` pair for rectangular tiles (e.g. one full-height
        1080p strip — rectangular tiles cut the overlap overhead from
        ~1.7x at 768x768/64 to ~1.2x for a single padded full-frame tile).
      pad: overlap absorbed on interior edges; int or ``(py, px)``.

    Returns:
      ``(stacked, info)`` where ``stacked`` maps keys to arrays with leading
      dim ``n_tiles`` and ``info`` carries the geometry for
      :func:`merge_tiles_uniform`.
    """
    ref_key = "features" if "features" in batch else "kpcn_diffuse_in"
    h, w = batch[ref_key].shape[-2:]
    th, tw = _pair(tile)
    py, px = _pair(pad)
    step_y, step_x = th - 2 * py, tw - 2 * px
    if step_y <= 0 or step_x <= 0:
        raise ValueError("tile must exceed 2 * pad")
    ny = max(1, -(-(h - 2 * py) // step_y))
    nx = max(1, -(-(w - 2 * px) // step_x))
    ph = 2 * py + ny * step_y
    pw = 2 * px + nx * step_x

    stacked = {}
    for k in _UNCHANGED_KEYS:
        if k in batch:
            v = batch[k]
            reps = [ny * nx] + [1] * (np.asarray(v).ndim - 1)
            stacked[k] = np.tile(np.asarray(v), reps)
    for k in _TILE_KEYS:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        widths = [(0, 0)] * (v.ndim - 2) + [(0, ph - h), (0, pw - w)]
        vp = np.pad(v, widths)
        tiles = []
        for iy in range(ny):
            for ix in range(nx):
                y0, x0 = iy * step_y, ix * step_x
                tiles.append(vp[0, ..., y0:y0 + th, x0:x0 + tw])
        stacked[k] = np.stack(tiles)
    info = {"ny": ny, "nx": nx, "tile": (th, tw), "pad": (py, px),
            "step": (step_y, step_x), "h": h, "w": w}
    return stacked, info


def merge_tiles_uniform(outputs, info, out_hw=None):
    """Merge batched uniform-tile outputs back into a full frame.

    Args:
      outputs: ``[n_tiles, ..., th, tw]`` model outputs (the model may have
        cropped a border; it is re-centered automatically).
      info: geometry dict from :func:`split_tiles_uniform`.
      out_hw: optional (h, w) of the full-frame output (defaults to the
        input frame size).

    Returns:
      ``[1, ..., h, w]`` numpy array.
    """
    outputs = np.asarray(outputs)
    ny, nx = info["ny"], info["nx"]
    th, tw = _pair(info["tile"])
    py, px = _pair(info["pad"])
    step_y, step_x = _pair(info["step"])
    h, w = out_hw or (info["h"], info["w"])
    # model's border crop (symmetric per side, same on both axes)
    crop = (tw - outputs.shape[-1]) // 2
    canvas = np.zeros(outputs.shape[1:-2] + (h, w), outputs.dtype)
    if py - crop < 0 or px - crop < 0:
        raise ValueError(
            "tile pad (%d, %d) is smaller than the model crop (%d)" %
            (py, px, crop))
    for i in range(ny * nx):
        iy, ix = divmod(i, nx)
        o = outputs[i]
        # Tile i covers [iy*step, iy*step + tile) in frame coords; it owns
        # the non-overlap region [pad, pad + step), extended to the frame
        # border at the edges (minus the model's crop, which nothing can
        # produce — the frame keeps a zero `crop` border, exactly like the
        # reference's cropped full-frame output).
        y_lo = crop if iy == 0 else py
        y_hi = th - crop if iy == ny - 1 else py + step_y
        x_lo = crop if ix == 0 else px
        x_hi = tw - crop if ix == nx - 1 else px + step_x
        # map into output coords (padded frame == output frame up to h, w)
        fy0, fx0 = iy * step_y + y_lo, ix * step_x + x_lo
        fy1 = min(iy * step_y + y_hi, h)
        fx1 = min(ix * step_x + x_hi, w)
        if fy1 <= fy0 or fx1 <= fx0:
            continue
        oy0, ox0 = y_lo - crop, x_lo - crop
        canvas[..., fy0:fy1, fx0:fx1] = o[
            ..., oy0:oy0 + (fy1 - fy0), ox0:ox0 + (fx1 - fx0)]
    return canvas[None]
