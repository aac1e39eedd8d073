"""device_idle.solve (%, device trace): share of the profiled sub-window of
solves in which no kernel, copy or set ran on the card."""
from msfbench.readers import idle_share


def read(r):
    return idle_share(r.profile)
