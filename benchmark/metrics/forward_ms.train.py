"""The train step's forward device time: the least, over the steps
(``train.step``) of a traced stretch, of the device ms of its
``train.forward`` span (the model, the loss and the step's metrics)."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "train step"
MOVES = "train_step_ms"
STAGES = {"train.step": ["train.forward"]}


def read(run):
    return stage_ms(run, STAGES)
