"""rounds.solve (rounds, program counter): mean ``SolveReport.iterations``
per solve, the AS loop's hook-and-shortcut rounds."""
from msfbench.readers import mean


def read(r):
    return mean(q["rounds"] for q in r.requests)
