"""hook_ms.solve (ms, program span): time per flat solve in the AS rounds'
``msf.hook`` spans (``core/msf.py``: ``hook_and_tiebreak``, the weight sum
and ``record_edges`` with its nonzero), in trace mode."""
from msfbench.solvespans import per_solve_ms


def read(r):
    return per_solve_ms(r.spans, "msf.hook", "solve.flat")
