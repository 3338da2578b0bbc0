"""The model's share of the card's dense peak while it denoises: the
useful FLOPs of the frames of a traced stretch (counted from the
configuration's widths over the frame's own pixels, whatever the tiles
pad) over the stretch's length, against the peak of the convolutions'
dtype."""

from benchmark.work import PEAK_FLOPS

UNIT = "%"
LAYER = "model"
MOVES = "frames_per_s"


def read(run):
    if run.trace is None or not run.units:
        return None
    w = run.work
    return (100.0 * w["model_flops"] * run.units / run.trace.window_s
            / PEAK_FLOPS[w["flops_dtype"]])
