"""host_syncs.solve (syncs, program counter): mean ``host_syncs`` of the
``solve.flat`` spans: the program's own tally of the points at which a
flat solve's host waits for the card (``obs.host_sync``), without the
trace spans' syncs."""
from msfbench.readers import mean
from msfbench.solvespans import attr_values


def read(r):
    return mean(attr_values(r.spans, "solve.flat", "host_syncs"))
