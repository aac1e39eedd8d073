"""report_ms.coarsen (ms, program span): mean length of the
``solve.report`` spans of coarsen solves (``solve/engines.py``: the
report's copies of the forest's edge ids and the labels into page-locked
host buffers, fresh ones where no free pair is cached, and its scalar
reads), in trace mode."""
from msfbench.readers import mean, span_durations_ms


def read(r):
    return mean(span_durations_ms(r.spans, "solve.report"))
