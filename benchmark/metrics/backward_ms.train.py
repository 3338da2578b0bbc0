"""The train step's backward device time: the least, over the steps
(``train.step``) of a traced stretch, of the device ms of its
``train.backward`` span (autograd through the model and the loss)."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "train step"
MOVES = "train_step_ms"
STAGES = {"train.step": ["train.backward"]}


def read(run):
    return stage_ms(run, STAGES)
