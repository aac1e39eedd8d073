"""round_ms.solve (ms, program span): mean length of the AS loop's
``msf.round`` spans (``core/msf.py::run_flat``; each closes after its
round's device work, in trace mode)."""
from msfbench.readers import mean, span_durations_ms


def read(r):
    return mean(span_durations_ms(r.spans, "msf.round"))
