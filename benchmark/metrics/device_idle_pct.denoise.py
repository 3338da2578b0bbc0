"""Share of a traced stretch of denoised frames in which no operation ran
on the card: one minus the union of the device's activity intervals over
the stretch's length."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
