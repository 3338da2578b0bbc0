"""The kernel stage's device time in a denoised frame: the least, over the
frame's model calls of a traced stretch, of the device ms of SBMC's
``sbmc.regress`` and ``sbmc.splat`` spans (a sample each: the regressor,
clamp and cast of the logits, then the splat, B1) inside ``sbmc.forward``,
or of KPCN's ``kpcn.apply`` (the two gathers, B4, and the recombination)
inside ``kpcn.forward``."""

from benchmark.spans import stage_ms

UNIT = "ms"
LAYER = "model"
MOVES = "frames_per_s"
STAGES = {"sbmc.forward": ["sbmc.regress", "sbmc.splat"],
          "kpcn.forward": ["kpcn.apply"]}


def read(run):
    return stage_ms(run, STAGES)
