"""rounds.coarsen (rounds, program counter): mean ``SolveReport.iterations``
per coarsen solve: its contraction levels and the residual's AS rounds."""
from msfbench.readers import mean


def read(r):
    return mean(q["rounds"] for q in r.requests)
