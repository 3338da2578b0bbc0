"""The program's own spans (``sbmc_tpu_torch.tracing``), as the per-layer
metrics whose source is ``program_span`` read them.

The program opens a span at each of its layer boundaries while a
``torch.profiler`` records, as a traced stretch does, and times it on the
card by two events on the stream. A metric's value is the minimum, over the
recorded calls of a unit span (a frame's model call, a train step), of the
device milliseconds summed over the named spans inside that call; the
minimum keeps the host-traced stretch's slowdown out. A program without the
tracing module, or a run that recorded no such call, reads None.
"""

__all__ = ["stage_ms"]


def stage_ms(run, stages):
    """``stages`` maps unit span names to the span names summed inside each
    call; the first unit with recorded calls is read."""
    if run.trace is None:
        return None
    try:
        from sbmc_tpu_torch import tracing
    except ImportError:  # a program that opens no spans
        return None
    for unit, names in stages.items():
        values = [sum(c.below[n].device_ms for n in names if n in c.below)
                  for c in tracing.calls(unit)
                  if any(n in c.below for n in names)]
        if values:
            return min(values)
    return None
