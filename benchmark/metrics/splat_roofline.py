"""The fused progressive splat step's (B1, ``psf_*``) share of its
roofline in a denoised frame: the bytes its launches must move (each tile,
each sample) at the card's memory bandwidth, over their device time in a
traced stretch."""

from benchmark.work import HBM_BYTES_PER_S

UNIT = "%"
LAYER = "kernels"
MOVES = "frames_per_s"
KERNEL = "psf_"


def read(run):
    nbytes = run.work.get("splat_bytes")
    if run.trace is None or not nbytes:
        return None
    launches, seconds = run.trace.kernel(KERNEL)
    if not launches or seconds <= 0:
        return None
    return 100.0 * nbytes * run.units / HBM_BYTES_PER_S / seconds
