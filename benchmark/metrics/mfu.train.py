"""The train step's share of the card's dense peak: the batch's forward
and backward FLOPs (counted from the configuration's widths) over the
steps of a traced stretch, against the peak of the convolutions'
dtype."""

from benchmark.work import PEAK_FLOPS

UNIT = "%"
LAYER = "train step"
MOVES = "train_step_ms"


def read(run):
    if run.trace is None or not run.units:
        return None
    w = run.work
    return (100.0 * w["model_flops"] * run.units / run.trace.window_s
            / PEAK_FLOPS[w["flops_dtype"]])
