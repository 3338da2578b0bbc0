"""The train step's optimizer device time: the least, over the steps
(``train.step``) of a traced stretch, of the device ms of its
``train.clip`` (the global-norm clip) and ``train.optimizer`` spans
(``zero_grad``, then Adam)."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "train step"
MOVES = "train_step_ms"
STAGES = {"train.step": ["train.clip", "train.optimizer"]}


def read(run):
    return stage_ms(run, STAGES)
