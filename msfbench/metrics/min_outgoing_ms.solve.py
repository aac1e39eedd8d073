"""min_outgoing_ms.solve (ms, program span): time per flat solve in the AS
rounds' ``msf.min_outgoing`` spans (``core/msf.py``: the gathers of p[src]
and p[dst], the outgoing mask and ``segment_argmin``'s scatter-mins; each
closes after its device work, in trace mode)."""
from msfbench.solvespans import per_solve_ms


def read(r):
    return per_solve_ms(r.spans, "msf.min_outgoing", "solve.flat")
