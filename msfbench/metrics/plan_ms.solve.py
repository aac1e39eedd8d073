"""plan_ms.solve (ms, host clock): mean time of ``plan(g, SolveSpec())`` per
solve, the planner's resolve (the pack32 probe over w, eid and valid) and
its cache lookup."""
from msfbench.readers import mean


def read(r):
    m = mean(q["plan_s"] for q in r.requests)
    return None if m is None else 1e3 * m
