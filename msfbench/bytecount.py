"""Least device-memory bytes of the MSF solve's work, from shapes.

One Awerbuch-Shiloach round over a symmetric graph of ``E`` directed
edges and ``n`` vertices reads each input array once and writes each
output once:

- the edge arrays: ``src`` and ``dst`` (int32), ``w`` (float32), ``eid``
  (int32) and ``valid`` (bool): 17 bytes per directed edge;
- the parent vector, read (int32, ``n``) and written (int32, ``n``).

The forest's edge ids are written once over the whole solve, at most
``n - 1`` of them; they are left out of the per-round count, which only
makes the bound lower. The count does not depend on the kernels that
implement the round, so it reads the same whatever does the work.
"""
from __future__ import annotations

EDGE_BYTES = 4 + 4 + 4 + 4 + 1  # src, dst, w, eid, valid
VERTEX_BYTES = 4 + 4  # parent read and written


def round_bytes(n: int, e_directed: int) -> int:
    """Least bytes of one round."""
    return EDGE_BYTES * int(e_directed) + VERTEX_BYTES * int(n)


def solve_bytes(n: int, e_directed: int, rounds: int) -> int:
    """Least bytes of a solve that took ``rounds`` rounds."""
    return int(rounds) * round_bytes(n, e_directed)
