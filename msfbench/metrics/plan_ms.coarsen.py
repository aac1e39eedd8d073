"""plan_ms.coarsen (ms, host clock): mean time of ``plan(g, SolveSpec(mode=
"coarsen"))`` per coarsen solve: the planner's resolve and its cache lookup."""
from msfbench.readers import mean


def read(r):
    m = mean(q["plan_s"] for q in r.requests)
    return None if m is None else 1e3 * m
