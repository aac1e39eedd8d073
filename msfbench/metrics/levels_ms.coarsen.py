"""levels_ms.coarsen (ms, program span): mean length of the coarsen
engine's ``coarsen.levels`` span per solve (``coarsen/engine.py``: every
contraction level, its dedupe by the sorted segment-min and the host's
level loop), in trace mode."""
from msfbench.readers import mean, span_durations_ms


def read(r):
    return mean(span_durations_ms(r.spans, "coarsen.levels"))
