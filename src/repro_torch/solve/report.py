"""`SolveReport` — the one result schema every engine maps onto.

Host-side: the forest weight, the chosen global eids, component labels
and counters come back as Python and numpy values; the engine-native
result (device tensors) stays under ``raw``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np

from repro_torch.graphs.structures import host_array
from repro_torch.obs.trace import host_sync


class SolveReport(NamedTuple):
    """Uniform result of ``Plan.solve()``."""

    mode: str  # engine that produced this report
    weight: float  # total forest weight
    msf_eids: np.ndarray  # int32 [n_msf_edges] chosen edge ids, trimmed
    parent: np.ndarray  # int32 [n] component representative per vertex
    n_msf_edges: int
    iterations: int  # hook/shortcut rounds (levels + residual)
    levels: Tuple  # per-level LevelStats rows (coarsen); () when no levels ran
    host_roundtrips: int  # per-level host round-trips (0 = device-resident)
    recompiles: int  # distinct executables compiled (stream mode)
    raw: Any  # engine-native result (MSFResult)
    timings: Dict[str, float] = {}  # span name -> seconds; {} when obs off
    cost: Any = None  # PlanCost of the plan (solve.cost); None off-scope
    stale: bool = False  # stream mode: snapshot may diverge from true MSF
    n_unhealed: int = 0  # stream mode: deletions not certifiably healed

    @property
    def n_components(self) -> int:
        """Component count from *canonical roots* (``parent[v] == v`` after
        pointer-jumping the vector to its fixpoint)."""
        return int(np.count_nonzero(_canonicalize(self.parent)
                                    == np.arange(len(self.parent))))


def _canonicalize(parent) -> np.ndarray:
    """Pointer-jump a parent vector to its root fixpoint (host-side)."""
    p = host_array(parent)
    while True:
        gp = p[p]
        if np.array_equal(gp, p):
            return p
        p = gp


def _trim_eids(msf_eids, n_msf_edges) -> np.ndarray:
    return host_array(msf_eids)[: int(n_msf_edges)].astype(np.int32)


def report_from_msf_result(
    mode: str,
    r,
    *,
    levels: Tuple = (),
    host_roundtrips: int = 0,
    recompiles: int = 0,
) -> SolveReport:
    """Adapt an ``MSFResult``-shaped record."""
    host_sync("report.scalars", 4)  # weight, n_msf_edges twice, iterations
    host_sync("report.arrays", 2)  # msf_eids, parent
    return SolveReport(
        mode=mode,
        weight=float(r.weight),
        msf_eids=_trim_eids(r.msf_eids, r.n_msf_edges),
        parent=host_array(r.parent),
        n_msf_edges=int(r.n_msf_edges),
        iterations=int(r.iterations),
        levels=tuple(levels),
        host_roundtrips=int(host_roundtrips),
        recompiles=int(recompiles),
        raw=r,
    )

