"""Kernel weighting's (B4, ``kw_fwd*``) share of its roofline in a
denoised frame: the bytes its launches must move (two a tile, at the tile
less the valid convolutions' border) at the card's memory bandwidth, over
their device time in a traced stretch."""

from benchmark.work import HBM_BYTES_PER_S

UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"
KERNEL = "kw_fwd"


def read(run):
    nbytes = run.work.get("kw_bytes")
    if run.trace is None or not nbytes:
        return None
    launches, seconds = run.trace.kernel(KERNEL)
    if not launches or seconds <= 0:
        return None
    return 100.0 * nbytes * run.units / HBM_BYTES_PER_S / seconds
