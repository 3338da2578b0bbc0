"""The per-sample embeddings' device time in a denoised frame: the least,
over the frame's model calls (``sbmc.forward``) of a traced stretch, of
the device ms of its ``sbmc.embedding`` spans (a step each: the cat with
the step's extra features and the 1x1 chain over every sample)."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "model"
MOVES = "frames_per_s"
STAGES = {"sbmc.forward": ["sbmc.embedding"]}


def read(run):
    return stage_ms(run, STAGES)
