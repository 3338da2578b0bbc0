"""The pixel-space U-Nets' device time in a denoised frame: the least, over
the frame's model calls (``sbmc.forward``) of a traced stretch, of the
device ms of its ``sbmc.propagation`` spans (a step each: the masked
sample mean and the U-Net)."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "model"
MOVES = "frames_per_s"
STAGES = {"sbmc.forward": ["sbmc.propagation"]}


def read(run):
    return stage_ms(run, STAGES)
