"""residual_ms.coarsen (ms, program span): mean length of the coarsen
engine's ``coarsen.residual`` span per solve: the flat AS solve of the
graph the levels leave, in trace mode."""
from msfbench.readers import mean, span_durations_ms


def read(r):
    return mean(span_durations_ms(r.spans, "coarsen.residual"))
