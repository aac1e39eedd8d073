"""outgoing_share.solve (%, program counter): of the edges the AS rounds
scan (``edges`` of each ``msf.counts`` span), the share that still join
two components (``outgoing``): the work a round that scanned only those
edges would keep."""
from msfbench.solvespans import attr_values


def read(r):
    edges = sum(attr_values(r.spans, "msf.counts", "edges"))
    outgoing = sum(attr_values(r.spans, "msf.counts", "outgoing"))
    return 100.0 * outgoing / edges if edges else None
