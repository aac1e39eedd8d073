"""shortcut_ms.solve (ms, program span): time per flat solve in the AS
rounds' ``msf.shortcut`` spans (``core/shortcut.py``: pointer jumping until
every tree is a star, one host read a jump), in trace mode."""
from msfbench.solvespans import per_solve_ms


def read(r):
    return per_solve_ms(r.spans, "msf.shortcut", "solve.flat")
