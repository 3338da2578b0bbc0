"""The fused progressive splat step's (B1, ``psf_*``) share of its
roofline in a train step: the bytes its launches must move (a sample each,
at the batch's shape) at the card's memory bandwidth, over their device
time in a traced stretch."""

from benchmark.work import HBM_BYTES_PER_S

UNIT = "%"
LAYER = "kernels"
MOVES = "train_step_ms"
KERNEL = "psf_"


def read(run):
    nbytes = run.work.get("splat_bytes")
    if run.trace is None or not nbytes:
        return None
    launches, seconds = run.trace.kernel(KERNEL)
    if not launches or seconds <= 0:
        return None
    return 100.0 * nbytes * run.units / HBM_BYTES_PER_S / seconds
